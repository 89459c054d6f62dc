"""Port parity for K6 and K7: the plain MurmurHash3 (`ops/hash.py`)
against the Pallas kernel `hash_rows_pallas` in interpret mode and the
JAX `convert.hash_mm3`, the facade's `hash` against the reference vector,
and the plain `compact_bytes` (`ops/compact.py`) against the JAX
`compact_bytes` with its Pallas kernel in interpret mode."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.config import use_interpret_mode
from custrings_tpu.ops import convert as jconvert
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import pallas_compact as jcompact
from custrings_tpu.ops.pallas_hash import hash_rows_pallas
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import compact as tcompact
from custrings_tpu_torch.ops import hash as thash

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
EDGE = ["", "a", "ab", "abc", "abcd", "abcde", None, "héllo wörld", "🎉" * 3, "\0x\0", "z" * 61]


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


@pytest.mark.parametrize("name", ["edge", "tweets", "logs"])
def test_hash_plain_vs_pallas_and_convert(name):
    strs = {"edge": EDGE, "tweets": CS.make_corpus(300, seed=3), "logs": CS.make_logs(200, seed=4)}[name]
    t, j = _pair(strs)
    got = thash.hash_mm3(t).numpy()
    w4 = -(-jlayout.max_row_bytes(j) // 4) * 4
    view = jlayout.padded_view(j, w4).astype(jnp.uint32)
    lens = j.lengths().astype(jnp.uint32)
    want_p = np.asarray(hash_rows_pallas(view, lens, None, use_interpret_mode())).astype(np.int64)
    np.testing.assert_array_equal(got, want_p)
    np.testing.assert_array_equal(got, np.asarray(jconvert.hash_mm3(j)).astype(np.int64))
    valid = np.asarray(j.validity)
    oracle = CS.murmur3_np(strs)
    assert [int(h) if v else None for h, v in zip(got, valid)] == oracle


def test_hash_facade_reference_vector():
    strs, want = CS.HASH_VECTOR
    assert tnv.to_device(strs, device="cpu").hash() == want
    assert jnv.to_device(strs).hash() == want
    assert CS.murmur3_np(strs) == want


def test_hash_empty_column():
    t, _ = _pair([])
    assert thash.hash_mm3(t).shape == (0,)


@pytest.mark.parametrize("cap,density,tile_out", [
    (8192, 0.15, True), (4096, 0.95, True), (6144, 0.0, True), (5000, 0.5, False), (7, 0.3, False),
])
def test_compact_bytes_parity(monkeypatch, cap, density, tile_out):
    """The densities of tests/test_pallas_window.py (drop probability
    0.15, 0.95 and 0.0, the last taking the JAX overflow path), and two
    out_caps that are not whole tiles (the JAX scatter path)."""
    monkeypatch.setenv("CUSTRINGS_PALLAS_COMPACT", "1")
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, cap, dtype=np.uint8)
    keep = rng.random(cap) > density
    kept = int(keep.sum())
    out_cap = jcompact.TB * max(-(-kept // jcompact.TB), 1) if tile_out else kept + 5
    want = np.asarray(jcompact.compact_bytes(jnp.asarray(data), jnp.asarray(keep), out_cap))
    got = tcompact.compact_bytes(torch.from_numpy(data), torch.from_numpy(keep), out_cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:kept], data[keep])
    assert (got[kept:] == 0).all()


def test_compact_bytes_out_cap_below_kept():
    data = torch.arange(100, dtype=torch.uint8)
    keep = data % 3 != 0
    got = tcompact.compact_bytes(data, keep, 20)
    np.testing.assert_array_equal(got.numpy(), data[keep].numpy()[:20])


def test_compact_bytes_rejects_bad_inputs():
    data = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tcompact.compact_bytes(data, torch.ones(9, dtype=torch.bool), 10)
    with pytest.raises(ValueError):
        tcompact.compact_bytes(data.to(torch.int32), torch.ones(10, dtype=torch.bool), 10)
