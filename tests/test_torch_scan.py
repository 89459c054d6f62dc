"""Port parity for K3: the plain int32 scans of custrings_tpu_torch against
the Pallas scan kernel of custrings_tpu in interpret mode (tiny tile so
the multi-tile carry runs), the forms the CUDA kernel writes in place
(cumsum0's int32[n+1], the shifted max, the row ids) against the JAX
package's helpers at lengths around the CUDA kernel's tiles, plus the
segment helpers built on them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from custrings_tpu import column as jcol
from custrings_tpu.ops import pallas_scan as jscan
from custrings_tpu.ops import segments as jseg
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.ops import scan as tscan
from custrings_tpu_torch.ops import segments as tseg

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


def _data(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if dtype == np.uint8:
        return rng.integers(0, 256, n).astype(np.uint8)
    if dtype == np.int8:
        return rng.integers(-128, 128, n).astype(np.int8)
    return rng.integers(-100000, 100000, n).astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 1000, 2500])
@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.int8])
def test_cumsum_matches_pallas(n, dtype):
    x = _data(dtype, n, n)
    want = np.asarray(jscan.cumsum_i32(jnp.asarray(x), force=True, tile_r=8))
    got = tscan.cumsum_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 1000, 2500])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_cummax_matches_pallas(n, dtype):
    x = _data(dtype, n, n + 17)
    if dtype == np.int32:
        x = x - 50000  # mostly negative, so the INT32_MIN identity matters
    want = np.asarray(jscan.cummax_i32(jnp.asarray(x), force=True, tile_r=8))
    got = tscan.cummax_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cumsum_wraps_like_int32():
    x = np.full(3000, 2_000_000, np.int32)
    want = np.asarray(jscan.cumsum_i32(jnp.asarray(x), force=True, tile_r=8))
    np.testing.assert_array_equal(tscan.cumsum_i32(torch.from_numpy(x)).numpy(), want)


def test_empty_scan():
    assert tscan.cumsum_i32(torch.zeros(0, dtype=torch.uint8)).shape == (0,)
    assert tscan.cummax_i32(torch.zeros(0, dtype=torch.int32)).shape == (0,)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8193, 10_000])
@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int8, np.int32])
def test_cumsum0_in_place_form_matches_jax(n, dtype):
    """cumsum0 as the kernel writes it: one int32[n+1] holding 0 and then
    the inclusive scan, at lengths around 4096 and one past the kernel's
    8192-element tile."""
    x = _data(dtype, n, n + 3)
    want = np.asarray(jcol.cumsum0(jnp.asarray(x)))
    got = tscan.cumsum0_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcol.cumsum0(torch.from_numpy(x)).numpy(), want)


def test_cumsum0_wraps_past_2_31():
    x = np.random.default_rng(2).integers(1 << 29, 1 << 31, 10_000).astype(np.int32)
    wrapped = ((np.cumsum(x.astype(np.int64)) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    want = np.asarray(jcol.cumsum0(jnp.asarray(x)))
    np.testing.assert_array_equal(want, np.concatenate([[0], wrapped]))
    np.testing.assert_array_equal(tscan.cumsum0_i32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_cummax0_form_matches_jax(n):
    """[0] + the running max (the split's token ends), against the Pallas
    max scan."""
    x = _data(np.int32, n, n + 29) - 50000
    want = [0]
    if n:
        want += np.asarray(jscan.cummax_i32(jnp.asarray(x), force=True, tile_r=8)).tolist()
    got = tscan.cummax0_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert got.tolist() == want


@pytest.mark.parametrize("rows", [1, 300, 4097])
def test_cumsum_row_ids_matches_jax(rows):
    """The row ids with the "- 1" and clamp folded into the scan, empty rows
    first, last and stacked, and padding past the last row."""
    rng = np.random.default_rng(rows)
    sizes = rng.integers(0, 4, rows).astype(np.int32)
    sizes[[0, -1]] = 0
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cap = int(offs[-1]) + 4099
    marks = np.zeros(cap + 1, np.int32)
    np.add.at(marks, offs[:-1], 1)
    want = np.asarray(jcol.row_ids_from_offsets(jnp.asarray(offs), cap))
    np.testing.assert_array_equal(tscan.cumsum_row_ids(torch.from_numpy(marks[:cap]), rows).numpy(), want)
    np.testing.assert_array_equal(tcol.row_ids_from_offsets(torch.from_numpy(offs), cap).numpy(), want)


def test_segment_helpers_parity():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 6, 50).astype(np.int32)
    lens[[0, 7, 8, 49]] = 0  # empty rows stack their row starts
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cap = int(offs[-1]) + 9
    vals = rng.integers(-5, 5, 50).astype(np.int32)
    to, jo = torch.from_numpy(offs), jnp.asarray(offs)
    for got, want in [
        (tseg.broadcast_rows_to_bytes(torch.from_numpy(vals), to, cap),
         jseg.broadcast_rows_to_bytes(jnp.asarray(vals), jo, cap)),
        (tseg.row_start_positions(to, cap), jseg.row_start_positions(jo, cap)),
        (tseg.row_end_positions(to, cap), jseg.row_end_positions(jo, cap)),
    ]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pre = np.concatenate([[0], np.cumsum(rng.integers(0, 2, cap))]).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.per_row_of_prefix(torch.from_numpy(pre), to).numpy(),
        np.asarray(jseg.per_row_of_prefix(jnp.asarray(pre), jo)),
    )


def test_compose_scan_parity():
    rng = np.random.default_rng(5)
    T = rng.integers(0, 4, (37, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.compose_scan(torch.from_numpy(T)).numpy(), np.asarray(jseg.compose_scan(jnp.asarray(T)))
    )
