"""Row-sharded columns and collective ops on torch.distributed.

Port of `custrings_tpu/parallel/`: `runtime` (process bootstrap, meshes,
global columns), `dist` (the host-side split, the PSRS dictionary merge,
sharded replace, contains and unique_tokens) and `sharded`
(`ShardedStringColumn`).  The JAX package's `compat.py` is a shard_map
version shim and has no counterpart.
"""
