"""Parity of custrings_tpu_torch.parallel (torch.distributed over gloo, on
the CPU) with custrings_tpu.parallel (shard_map on the virtual CPU
devices).

Module fixtures run gloo jobs of S = 1, 2 and 4 worker processes, all
started at once (`torch_parallel_worker.py`, which imports only torch and
the port); each rank runs every scenario once and writes its results.  Each test holds a
rank's results to the JAX package's at the same S: categorize values on
every row and the key count, to_column, contains masks and totals, the
shrinking and growing replace, both unique_tokens forms (ids over each
rank's tokens, the unique count), the runtime's meshes and shard_global.
Columns are compared by their bytes within the offsets, the offsets and
the validity; capacities may differ by design.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
import torch_parallel_worker as W
from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.parallel import dist as jdist
from custrings_tpu.parallel.sharded import ShardedStringColumn as JSharded
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.parallel import dist as tdist
from custrings_tpu_torch.parallel import runtime as truntime
from test_torch_split_ws import fast_reference_compiles  # noqa: F401

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
WORLDS = (1, 2, 4)
#: a hung collective fails its test after this many seconds
WORLD_TIMEOUT = 180
#: variables that would point a worker at another job
_JOB_VARS = ("PYTHONPATH", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The gloo jobs of every world size, all started at once (they run
    while the JAX side compiles): {S: (worker processes, output dir)}."""
    env = {k: v for k, v in os.environ.items() if k not in _JOB_VARS}
    started = {}
    for S in WORLDS:
        out = tmp_path_factory.mktemp(f"world{S}")
        started[S] = ([subprocess.Popen([sys.executable, WORKER, str(r), str(S), str(out / "store"), str(out)],
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                       for r in range(S)], out)
    yield started, time.monotonic() + WORLD_TIMEOUT
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda s: f"S{s}")
def world(request, jobs):
    """(S, [rank r's results]) of the gloo job of S worker processes."""
    S = request.param
    started, deadline = jobs
    procs, out = started[S]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0].decode())
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo job of {S} ranks did not end within {WORLD_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {S} failed:\n{log[-3000:]}"
    return S, [json.loads((out / f"rank{r}.json").read_text()) for r in range(S)]


def _mesh(S: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:S]), ("data",))


_JAX = {}


def _jax(key, fn):
    """The JAX side of a comparison, computed once per key."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _np(x):
    return np.asarray(jax.device_get(x))


def _same_column(payload, col):
    """A worker's column payload equals a JAX column (bytes within the
    offsets, offsets, validity)."""
    off = _np(col.offsets)
    assert payload["offsets"] == off.tolist()
    assert payload["validity"] == _np(col.validity).tolist()
    assert payload["data"] == _np(col.data)[: off[-1]].tolist()


def _corpora(S: int):
    return dict(W.CATEGORIZE, skewed=W.skewed(S))


# ---------------- the host-side split ----------------


@pytest.mark.parametrize("S", WORLDS + (3,))
@pytest.mark.parametrize("name", sorted(W.CATEGORIZE) + ["skewed"])
def test_shard_column_split(S, name):
    rows = _corpora(S)[name]
    want = [_np(x) for x in jdist.shard_column(jcol.from_host_strings(rows), S)]
    got = [x.numpy() for x in tdist.shard_column(tcol.from_host_strings(rows, "cpu"), S)]
    jd, jo, jv, ja = want
    td, to, tv, ta = got
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ta, ja)
    for s in range(S):
        np.testing.assert_array_equal(td[s, : to[s, -1]], jd[s, : jo[s, -1]])


# ---------------- categorize ----------------


@pytest.mark.parametrize("name", sorted(W.CATEGORIZE) + ["skewed"])
def test_categorize(world, name):
    S, ranks = world
    rows = _corpora(S)[name]

    def ref():
        d, o, v, a = jdist.shard_column(jcol.from_host_strings(rows), S)
        vals, n = jdist.distributed_categorize(d, o, v, a, _mesh(S))
        return _np(vals), int(n), _np(a), _np(v)

    vals, n, alive, valid = _jax(("categorize", S, name), ref)
    for r, res in enumerate(ranks):
        got = res[f"categorize/{name}"]
        assert got["values"] == vals[r].tolist(), f"rank {r}"
        assert got["n"] == n
        assert got["alive"] == alive[r].tolist()
        assert got["validity"] == valid[r].tolist()
        assert got["size"] == len(rows)


@pytest.mark.parametrize("name", sorted(W.CATEGORIZE) + ["skewed"])
def test_to_column(world, name):
    S, ranks = world
    rows = _corpora(S)[name]
    want = JSharded.from_column(jcol.from_host_strings(rows), _mesh(S)).to_column()
    for res in ranks:
        _same_column(res[f"to_column/{name}"], want)


# ---------------- contains ----------------


def test_distributed_contains(world):
    S, ranks = world

    def ref():
        col = jcol.from_host_strings(W.DIGITS)
        chars, nch = jlayout.char_matrix(col)
        per = col.size // S
        chars = jnp.asarray(_np(chars).reshape(S, per, -1))
        m, total = jdist.distributed_contains(chars, jnp.asarray(_np(nch).reshape(S, per)), r"\d+", _mesh(S))
        return _np(m), int(total)

    mask, total = _jax(("contains", S), ref)
    for r, res in enumerate(ranks):
        assert res["contains/digits"] == {"mask": mask[r].tolist(), "total": total}


@pytest.mark.parametrize("name", ["end2end", "tiny"])
def test_contains_re(world, name):
    S, ranks = world
    rows = getattr(W, name.upper())

    def ref():
        m, total = JSharded.from_column(jcol.from_host_strings(rows), _mesh(S)).contains_re(r"#\w+")
        return _np(m), int(total)

    mask, total = _jax(("contains_re", S, name), ref)
    for r, res in enumerate(ranks):
        assert res[f"contains_re/{name}"] == {"mask": mask[r].tolist(), "total": total}


# ---------------- replace ----------------


def test_distributed_replace(world):
    S, ranks = world

    def ref():
        d, o, v, a = jdist.shard_column(jcol.from_host_strings(W.REPLACE), S)
        data, offs = jdist.distributed_replace(d, o, v, _mesh(S), "the", "A")
        with pytest.raises(ValueError):
            jdist.distributed_replace(d, o, v, _mesh(S), "the", "THEIR")
        return _np(data), _np(offs)

    data, offs = _jax(("replace", S), ref)
    for r, res in enumerate(ranks):
        got = res["replace/shrink"]
        assert got["refused_growing"]
        assert got["offsets"] == offs[r].tolist()
        assert got["data"] == data[r, : offs[r, -1]].tolist()


@pytest.mark.parametrize("name", ["end2end", "tiny"])
def test_sharded_replace_grow(world, name):
    S, ranks = world
    rows = getattr(W, name.upper())
    want = _jax(("grow", S, name), lambda: JSharded.from_column(jcol.from_host_strings(rows), _mesh(S))
                .replace("the", "THEIR!").to_column())
    assert jcol.to_host_strings(want) == [None if s is None else s.replace("the", "THEIR!") for s in rows]
    for res in ranks:
        _same_column(res[f"replace/grow/{name}"], want)


# ---------------- unique_tokens ----------------


@pytest.mark.parametrize("form", ["host", "device"])
@pytest.mark.parametrize("case", W.TOKEN_CASES, ids=[c[0] for c in W.TOKEN_CASES])
def test_unique_tokens(world, form, case):
    S, ranks = world
    name, rows, delim = case

    def ref():
        col = jcol.from_host_strings(rows)
        if form == "host":
            ids, n = jdist.distributed_unique_tokens(col, _mesh(S), delim)
        else:
            ids, n = JSharded.from_column(col, _mesh(S)).unique_tokens(delim)
        return _np(ids), int(n)

    ids, n = _jax(("tokens", S, form, name), ref)
    if delim is None:  # chip_smoke's oracle of the sharded path's token ids
        assert chip_smoke.token_oracle(rows) == ([i for row in ids for i in row if i >= 0], n)
    total = 0
    for r, res in enumerate(ranks):
        got = res[f"unique_tokens/{form}/{name}"]
        assert got["n"] == n
        count = int((ids[r] >= 0).sum())
        assert got["ids"][:count] == ids[r, :count].tolist(), f"rank {r}"
        assert all(i == -1 for i in got["ids"][count:])
        total += count
    assert n == len({t for s in rows if s for t in (s.split(delim) if delim else s.split()) if t})
    assert total == sum(len([t for t in (s.split(delim) if delim else s.split()) if t]) for s in rows if s)


# ---------------- the runtime ----------------


def test_runtime_meshes_and_shard_global(world):
    """Every rank joined (the world of 4 through COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID), the [hosts, ranks per host] mesh has
    the shape LOCAL_WORLD_SIZE gives, and shard_global's shards categorize
    and count as the JAX package does."""
    S, ranks = world

    def ref():
        sc = JSharded.from_column(jcol.from_host_strings(W.MULTIHOST), _mesh(S))
        vals, n = sc.categorize()
        m, total = sc.contains_re(r"\bcat\b")
        return _np(vals), int(n), _np(m), int(total), _np(sc.alive)

    vals, n, mask, total, alive = _jax(("shard_global", S), ref)
    local = min(W.HYBRID_LOCAL, S)
    for r, res in enumerate(ranks):
        assert res["hybrid_shape"] == [S // local, local]
        got = res["shard_global"]
        assert got["values"] == vals[r].tolist()
        assert got["mask"] == mask[r].tolist()
        assert got["alive"] == alive[r].tolist()
        assert (got["n"], got["total"]) == (n, total)


def test_worker_loads_no_jax(world):
    S, ranks = world
    assert [res["foreign_modules"] for res in ranks] == [[]] * S


def test_resolve_job():
    env = {"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "4", "PROCESS_ID": "2",
           "MASTER_ADDR": "m", "MASTER_PORT": "9", "WORLD_SIZE": "8", "RANK": "5"}
    assert truntime._resolve(None, None, None, env) == ("tcp://h:1", 4, 2)
    assert truntime._resolve("file:///x/s", 2, 1, env) == ("file:///x/s", 2, 1)
    torchrun = {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    assert truntime._resolve(None, None, None, torchrun) == ("tcp://m:9", 8, 5)
    assert truntime._resolve(None, None, None, {}) is None
    assert truntime._resolve("h:1", 1, None, {}) == ("tcp://h:1", 1, 0)
    with pytest.raises(ValueError):
        truntime._resolve("h:1", 2, None, {})


def test_runtime_defaults(monkeypatch):
    """Nothing names a job: single-process, no group made; the default
    device is the card, which is refused where CUDA is missing."""
    for k in _JOB_VARS:
        monkeypatch.delenv(k, raising=False)
    assert truntime.init_runtime() is False
    assert not truntime.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            truntime._pick_device(None)
