"""Edge shapes of K6 and K7 against the JAX package: the plain MurmurHash3
(`ops/hash.py`) against `convert.hash_mm3` and the Pallas kernel
`hash_rows_pallas` in interpret mode at every `len & 3`, a row over
64 KB, empty and null rows, one row, a buffer whose last row ends at a
cap of 16k + 7 and a data view; and the plain `compact_bytes`
(`ops/compact.py`) against the JAX `compact_bytes` (its Pallas kernel in
interpret mode where it takes it) at out_cap above cap and 0, caps not a
multiple of 16 and below 8, all and none kept, with a bool and a uint8
keep."""

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

from test_torch_hash_compact import CS

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


def _raw_pair(lens, seed, lead=0):
    """The same rows of random bytes (every byte value, NUL included) as a
    port column, whose buffer holds exactly the rows' bytes and whose data
    is a view `lead` bytes into its allocation, and a JAX column (padded
    to its bucket capacity, as the JAX package builds them)."""
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64))]).astype(np.int32)
    data = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    valid = np.ones(len(lens), bool)
    buf = torch.zeros(lead + data.shape[0], dtype=torch.uint8)
    buf[lead:] = torch.from_numpy(data)
    t = tcol.StringColumn(buf[lead:], torch.from_numpy(offs), torch.from_numpy(valid))
    j = jcol._device_column(data, offs, valid)
    return t, j


def _every_len_mod_4():
    return np.random.default_rng(1).permutation(np.tile(np.arange(13), 8))


def _cap_16k_plus_7():
    lens = np.random.default_rng(2).integers(0, 40, 101)
    lens[-1] += (7 - int(lens.sum())) % 16
    return lens


HASH_CASES = {
    # name: (row lengths, data view offset, also against the Pallas kernel)
    "every len & 3": (_every_len_mod_4, 0, True),
    "every len & 3, data view": (_every_len_mod_4, 3, False),
    "one row": (lambda: np.array([7]), 0, False),
    "last row ends at a cap of 16k + 7": (_cap_16k_plus_7, 0, True),
}


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_edges_vs_convert(name):
    lens_fn, lead, pallas = HASH_CASES[name]
    t, j = _raw_pair(lens_fn(), seed=len(name), lead=lead)
    if name == "last row ends at a cap of 16k + 7":
        assert t.capacity == int(t.offsets[-1]) and t.capacity % 16 == 7
    got = thash.hash_mm3(t).numpy()
    assert got.dtype == np.int64 and ((got >= 0) & (got < 1 << 32)).all()
    np.testing.assert_array_equal(got, np.asarray(jconvert.hash_mm3(j)).astype(np.int64))
    if pallas:
        w4 = -(-jlayout.max_row_bytes(j) // 4) * 4
        view = jlayout.padded_view(j, w4).astype(jnp.uint32)
        lens_u = j.lengths().astype(jnp.uint32)
        want = hash_rows_pallas(view, lens_u, None, use_interpret_mode())
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


def test_hash_all_empty_rows():
    """Every row empty (a buffer of no bytes): each hashes as "" does in
    the reference vector."""
    t, _ = _raw_pair(np.zeros(50, np.int64), seed=0)
    empty = CS.HASH_VECTOR[1][CS.HASH_VECTOR[0].index("")]
    assert thash.hash_mm3(t).tolist() == [empty] * 50


def test_hash_row_over_64kb():
    """One row of 65,539 bytes among short ones: the kernel's steps of 128
    bytes carry the hash across 512 of them."""
    t, j = _raw_pair([3, 65_539, 0, 6], seed=5)
    np.testing.assert_array_equal(thash.hash_mm3(t).numpy(),
                                  np.asarray(jconvert.hash_mm3(j)).astype(np.int64))


def test_hash_null_rows_masked_by_the_facade():
    strs = [None, "abc", None, "", "abcd", None, "x" * 9]
    got = tnv.to_device(strs, device="cpu").hash()
    assert got == jnv.to_device(strs).hash()
    assert [g is None for g in got] == [s is None for s in strs]
    t, j = tcol.from_host_strings(strs, "cpu"), jcol.from_host_strings(strs)
    np.testing.assert_array_equal(thash.hash_mm3(t).numpy(),
                                  np.asarray(jconvert.hash_mm3(j)).astype(np.int64))


COMPACT_CASES = {
    # name: (cap, kept fraction, out_cap from (cap, kept))
    "out_cap above cap": (5000, 0.5, lambda cap, kept: cap + 1000),
    "out_cap 0": (4096, 0.5, lambda cap, kept: 0),
    "cap 16k + 3, whole tiles out": (2307, 0.9, lambda cap, kept: jcompact.TB * -(-kept // jcompact.TB)),
    "cap 16k + 9, out_cap = cap": (2057, 0.7, lambda cap, kept: cap),
    "cap below 8": (7, 0.5, lambda cap, kept: 16),
    "all kept": (2048, 1.0, lambda cap, kept: cap),
    "none kept": (2048, 0.0, lambda cap, kept: cap),
}


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compact_bytes_edges(monkeypatch, name):
    """The JAX compact_bytes with its Pallas kernel forced (interpret
    mode; it takes its scatter path where out_cap is not whole tiles or
    cap < 8) against the port's, given the mask as bool and as uint8 0/1.
    At out_cap 0 the JAX kernel path fails (a Pallas grid of no tiles),
    so the port is held to the empty result there."""
    monkeypatch.setenv("CUSTRINGS_PALLAS_COMPACT", "1")
    cap, frac, oc_fn = COMPACT_CASES[name]
    rng = np.random.default_rng(cap)
    data = rng.integers(0, 256, cap, dtype=np.uint8)
    keep = rng.random(cap) < frac
    kept = int(keep.sum())
    out_cap = oc_fn(cap, kept)
    if out_cap == 0:
        want = np.zeros(0, np.uint8)
    else:
        want = np.asarray(jcompact.compact_bytes(jnp.asarray(data), jnp.asarray(keep), out_cap))
    for tkeep in (torch.from_numpy(keep), torch.from_numpy(keep.astype(np.uint8))):
        got = tcompact.compact_bytes(torch.from_numpy(data), tkeep, out_cap).numpy()
        assert got.shape == (out_cap,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:kept], data[keep][:out_cap])
        assert (got[kept:] == 0).all()
