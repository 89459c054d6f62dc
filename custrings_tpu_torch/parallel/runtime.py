"""Process bootstrap, meshes and global columns on torch.distributed.

Port of `custrings_tpu/parallel/runtime.py`.  A job is one process a
device: rank r drives one card and owns row shard r.

    runtime.init_runtime()                  # one call per process
    mesh = runtime.global_mesh()            # every rank in the job
    sc = runtime.shard_global(rows, mesh)   # every rank passes the same rows
    values, n = sc.categorize()             # collective ops over the mesh

`init_runtime` resolves the job from its arguments, then the JAX package's
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, then torchrun's
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK.  The coordinator is a
"host:port" (a TCP rendezvous) or any init_method URL, such as
"file:///path/store".  The ranks talk over NCCL on `cuda:{LOCAL_RANK}`;
gloo serves a job on the CPU (`device="cpu"`), or a caller that asks for
it (`backend="gloo"`, which also takes CUDA tensors).  A single-process
caller may skip `init_runtime`: the meshes then make a world of one.

The mesh is a `torch.distributed.device_mesh.DeviceMesh`, the counterpart
of `jax.sharding.Mesh`; an axis name gives its process group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..column import _device as _checked_device
from ..column import _flatten

#: the device this process drives, set when the process joins a job
_device: torch.device | None = None


def _resolve(coordinator, num_processes, process_id, env=None):
    """(init_method, world size, rank) of the job, or None when nothing
    names one.  Each field: the argument, then the JAX package's variable,
    then torchrun's."""
    env = os.environ if env is None else env
    torchrun = None
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        torchrun = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    coordinator = coordinator or env.get("COORDINATOR_ADDRESS") or torchrun
    if num_processes is None:
        num_processes = env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
    if process_id is None:
        process_id = env.get("PROCESS_ID", env.get("RANK"))
    if not coordinator or not num_processes or int(num_processes) < 1:
        return None
    world = int(num_processes)
    if process_id is None:
        if world != 1:
            raise ValueError(f"init_runtime: a job of {world} processes needs this process's id")
        process_id = 0
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    return method, world, int(process_id)


def _pick_device(device) -> torch.device:
    """The named device; the card LOCAL_RANK names when that is None or
    "cuda" (raises without CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return _checked_device(dev)


def _join(method, world: int, rank: int, dev: torch.device, backend, timeout, store=None):
    global _device
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    if store is None:
        kw["init_method"] = method
    else:
        kw["store"] = store
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)
    _device = dev


def init_runtime(coordinator: str | None = None, num_processes: int | None = None,
                 process_id: int | None = None, *, device=None, backend: str | None = None,
                 timeout=None) -> bool:
    """Join (or create) the job.  Returns False when nothing names a job
    (single-process), True once this process is in one; a second call is
    harmless.  `timeout` (a timedelta) bounds every collective."""
    if dist.is_initialized():
        global _device
        if _device is None:  # a launcher joined before this package did
            _device = _pick_device(device)
        return True
    spec = _resolve(coordinator, num_processes, process_id)
    if spec is None:
        return False
    _join(*spec, _pick_device(device), backend, timeout)
    return True


def is_initialized() -> bool:
    return dist.is_initialized()


def shutdown() -> None:
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def device() -> torch.device | None:
    """The device this process drives, once it is in a job."""
    return _device


def _mesh_device(device) -> torch.device:
    """The device a mesh is made for: the argument, the job's device, or
    the card; a single-process caller gets a world of one (an in-memory
    store) on it."""
    dev = _pick_device(device) if device is not None or _device is None else _device
    if not dist.is_initialized():
        _join(None, 1, 0, dev, None, None, store=dist.HashStore())
    return dev


def global_mesh(axis: str = "data", device=None) -> DeviceMesh:
    """One mesh axis over every rank in the job."""
    dev = _mesh_device(device)
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def hybrid_mesh(dcn_axis: str = "hosts", ici_axis: str = "data", device=None) -> DeviceMesh:
    """[hosts, ranks per host] mesh, ranks per host from LOCAL_WORLD_SIZE.

    Launchers number the ranks host by host, so the inner axis holds the
    ranks of one host: collectives along `ici_axis` stay on its NVLink
    and only those along `dcn_axis` cross hosts."""
    dev = _mesh_device(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"hybrid_mesh: {world} ranks do not split into hosts of {local}")
    return init_device_mesh(dev.type, (world // local, local), mesh_dim_names=(dcn_axis, ici_axis))


def shard_global(strs, mesh: DeviceMesh, axis: str = "data", device=None):
    """A row-sharded column from host rows: every rank passes the SAME
    rows and keeps its own shard (shard_column's layout), on `device`, by
    default the job's device."""
    from . import dist as pdist
    from .sharded import ShardedStringColumn

    data, offsets, validity = _flatten(strs)
    dev = _pick_device(device) if device is not None else _mesh_device(None)
    shard = pdist._rank_shard(data, offsets, validity, mesh, axis, dev)
    return ShardedStringColumn(*shard, mesh, axis, nrows=len(validity))
