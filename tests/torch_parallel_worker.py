"""One rank of a gloo job on the CPU running the port's parallel module.

Run by tests/test_torch_parallel.py, one process a rank:

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT_DIR

The ranks rendezvous through a FileStore at STORE; a world of 4 joins
through the JAX package's variables (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID), the others through init_runtime's arguments, and each makes
its hybrid mesh with LOCAL_WORLD_SIZE = min(2, WORLD).  Every scenario runs once and the rank writes its results to
OUT_DIR/rank{RANK}.json.  Imports only torch, numpy and the port; the
test module imports the corpora from here.
"""

import json
import os
import sys

PRELOADED = set(sys.modules)

CORPUS = (["eee", "aaa", "eee", "ddd", "ccc"] * 5 + ["zzz", "bbb", None, "", "aaa"] * 3 + ["mmm"])
DIGITS = ["hello123", "no digits", None, "42", "x"] * 4
END2END = (["the cat sat on the mat #tag", "no match here", None, ""] * 6
           + ["the end 42", "a the b the c"])
REPLACE = ["the quick the", "other theory", None, "no match here"] * 2
TOKENS = ["the quick fox", "the lazy dog", None, "fox and dog run", "quick quick"] * 2
COMMAS = ["a,b,c", "b,c", None, "c,d,,e"] * 4
TINY = ["b", None, "a"]
NULL_HEAD = [None] * 6 + ["b", "a", None, "a", "c", "", "zz", "b", "é", None, "a", "ab", "a\x00",
                          "\x00", "a\x00\x00", "a\x00"]
MULTIHOST = ["the cat sat", "dog", None, "", "the end", "cat"] * 8 + ["zebra", "the cat sat"]
HYBRID_LOCAL = 2


def skewed(S: int):
    """Sorted distinct keys in contiguous shards: each rank's keys fall in
    one owner's range."""
    return [f"k{i:06d}" for i in range(S * 24)]


#: (name, rows, delimiter) of the unique_tokens scenarios
TOKEN_CASES = (("ws", TOKENS, None), ("comma", COMMAS, ","), ("tiny", TINY, None))
#: corpora of the categorize scenarios (the skewed one is made per world)
CATEGORIZE = {"corpus": CORPUS, "tiny": TINY, "null_head": NULL_HEAD, "end2end": END2END}


def _shard_payload(sc):
    return {"alive": sc.alive.tolist(), "validity": sc.validity.tolist(), "R": sc.R}


def _column_payload(col):
    nb = int(col.offsets[-1])
    return {"data": col.data[:nb].tolist(), "offsets": col.offsets.tolist(),
            "validity": col.validity.tolist()}


def run(mesh, S: int):
    import torch

    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import layout
    from custrings_tpu_torch.parallel import dist as pdist
    from custrings_tpu_torch.parallel.sharded import ShardedStringColumn

    def sharded(rows):
        return ShardedStringColumn.from_column(column.from_host_strings(rows, "cpu"), mesh)

    out = {}
    cats = dict(CATEGORIZE, skewed=skewed(S))
    for name, rows in cats.items():
        sc = sharded(rows)
        values, n = sc.categorize()
        out[f"categorize/{name}"] = {"values": values.tolist(), "n": n, "size": sc.size(),
                                     **_shard_payload(sc)}
        out[f"to_column/{name}"] = _column_payload(sc.to_column())

    col = column.from_host_strings(DIGITS, "cpu")
    chars, nch = layout.char_matrix(col)
    per = col.size // S
    me = pdist._group(mesh, "data")[2]
    mask, total = pdist.distributed_contains(chars[me * per : (me + 1) * per], nch[me * per : (me + 1) * per],
                                             r"\d+", mesh)
    out["contains/digits"] = {"mask": mask.tolist(), "total": total}
    for name, rows in (("end2end", END2END), ("tiny", TINY)):
        mask, total = sharded(rows).contains_re(r"#\w+")
        out[f"contains_re/{name}"] = {"mask": mask.tolist(), "total": total}

    sc = sharded(REPLACE)
    data, offsets = pdist.distributed_replace(sc.data, sc.offsets, sc.validity, mesh, "the", "A")
    try:
        pdist.distributed_replace(sc.data, sc.offsets, sc.validity, mesh, "the", "THEIR")
        refused = False
    except ValueError:
        refused = True
    nb = int(offsets[-1])
    out["replace/shrink"] = {"data": data[:nb].tolist(), "offsets": offsets.tolist(), "refused_growing": refused}
    for name, rows in (("end2end", END2END), ("tiny", TINY)):
        grown = sharded(rows).replace("the", "THEIR!")
        out[f"replace/grow/{name}"] = _column_payload(grown.to_column())

    for name, rows, delim in TOKEN_CASES:
        col = column.from_host_strings(rows, "cpu")
        ids, n = pdist.distributed_unique_tokens(col, mesh, delim)
        out[f"unique_tokens/host/{name}"] = {"ids": ids.tolist(), "n": n}
        ids, n = sharded(rows).unique_tokens(delim)
        out[f"unique_tokens/device/{name}"] = {"ids": ids.tolist(), "n": n}
    return out


def main():
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from datetime import timedelta

    import torch

    torch.set_num_threads(1)
    from custrings_tpu_torch.parallel import runtime

    timeout = timedelta(seconds=60)
    os.environ["LOCAL_WORLD_SIZE"] = str(min(HYBRID_LOCAL, world))
    if world == 4:
        os.environ.update(COORDINATOR_ADDRESS=f"file://{store}", NUM_PROCESSES=str(world),
                          PROCESS_ID=str(rank))
        joined = runtime.init_runtime(device="cpu", timeout=timeout)
    else:
        joined = runtime.init_runtime(f"file://{store}", world, rank, device="cpu", timeout=timeout)
    assert joined and runtime.init_runtime(device="cpu"), "init_runtime did not join the job"
    mesh = runtime.global_mesh(device="cpu")
    res = run(mesh, world)
    res["hybrid_shape"] = list(runtime.hybrid_mesh(device="cpu").shape)
    sc = runtime.shard_global(MULTIHOST, mesh, device="cpu")
    values, n = sc.categorize()
    mask, total = sc.contains_re(r"\bcat\b")
    res["shard_global"] = {"values": values.tolist(), "n": n, "total": total, "mask": mask.tolist(),
                           **_shard_payload(sc)}
    res["foreign_modules"] = sorted(m for m in set(sys.modules) - PRELOADED
                                    if m.split(".")[0] in ("jax", "jaxlib", "custrings_tpu"))
    runtime.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
