"""Port parity for K1/K1b and the layout built on them: the plain window
gathers of custrings_tpu_torch against the Pallas window kernel of
custrings_tpu in interpret mode, and the padded view, char matrix, tail
plane and length buckets against the JAX layout module."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import pallas_window as jwin
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import window as twin

MIXED = [
    "hello world",
    "",
    "a",
    "tschüß éé",
    "日本語のテキスト",
    "x" * 300,
    "mixed ascii & 中文 tail",
    None,
    "🎉 four-byte emoji 🎉",
]


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


def _windows():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    starts = np.sort(rng.integers(0, 3000, 40)).astype(np.int32)
    starts[-3:] = [2990, 2999, 3000]  # windows running off the buffer end
    return data, starts


@pytest.mark.parametrize("width", [1, 100, 513])
def test_ragged_gather_bytes_matches_pallas(width):
    data, starts = _windows()
    want = np.asarray(jwin.ragged_gather_i32(jnp.asarray(data), jnp.asarray(starts), width))
    got = twin.ragged_gather_i32(torch.from_numpy(data), torch.from_numpy(starts), width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got8 = twin.ragged_gather(torch.from_numpy(data), torch.from_numpy(starts), width)
    np.testing.assert_array_equal(got8.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("width", [4, 64, 98])
def test_ragged_gather_words_matches_pallas(width):
    data, starts = _windows()
    want = np.asarray(jwin.ragged_gather_words(jnp.asarray(data), jnp.asarray(starts), width))
    got = twin.ragged_gather_words(torch.from_numpy(data), torch.from_numpy(starts), width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pallas_window", ["0", "1"])
def test_padded_view_and_char_matrix_parity(monkeypatch, pallas_window):
    monkeypatch.setenv("CUSTRINGS_PALLAS_WINDOW", pallas_window)
    t, j = _pair(MIXED)
    w = tlayout.max_row_bytes(t)
    assert w == jlayout.max_row_bytes(j)
    np.testing.assert_array_equal(
        tlayout.padded_view(t, w).numpy(), np.asarray(jlayout.padded_view(j, w))
    )
    mat, nch = tlayout.char_matrix(t)
    jmat, jnch = jlayout.char_matrix(j)
    np.testing.assert_array_equal(nch.numpy(), np.asarray(jnch))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))


def test_tail_plane_and_ascii_facts_parity():
    t, j = _pair(MIXED + ["the end"] * 3)
    np.testing.assert_array_equal(tlayout.tail_plane(t).numpy(), np.asarray(jlayout.tail_plane(j)))
    np.testing.assert_array_equal(tlayout.row_nonascii_ids(t), jlayout.row_nonascii_ids(j))
    assert tlayout.is_ascii(t) == jlayout.is_ascii(j) is False
    for a, b in zip(tlayout.row_bounds_planes(t), jlayout.row_bounds_planes(j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_length_buckets_and_rows_parity():
    rng = np.random.default_rng(11)
    strs = ["s%d" % i for i in range(300)] + ["é" * int(k) for k in rng.integers(40, 120, 40)]
    strs += ["long " * 60, None, "日本語" * 30]
    t, j = _pair(strs)
    tb, jb = tlayout.length_buckets(t), jlayout.length_buckets(j)
    assert tb is not None and jb is not None and len(tb) == len(jb) >= 2
    for a, b in zip(tb, jb):
        assert (a.width, a.nv) == (b.width, b.nv)
        np.testing.assert_array_equal(a.idx_np, b.idx_np)
        np.testing.assert_array_equal(a.vmask.numpy(), np.asarray(b.vmask))
        mat, nch = tlayout.char_matrix_rows(t, a)
        jmat, jnch = jlayout.char_matrix_rows(j, b)
        np.testing.assert_array_equal(nch.numpy()[: a.nv], np.asarray(jnch)[: b.nv])
        np.testing.assert_array_equal(mat.numpy()[: a.nv], np.asarray(jmat)[: b.nv])
