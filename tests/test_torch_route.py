"""Port parity for K4c/K4e and the streaming padded views built on them:
the plain compaction and expansion of custrings_tpu_torch against the
Pallas stream kernels of custrings_tpu in interpret mode (small tiles, so
several tiles are stitched), and the streaming padded view, char matrix,
key words and hashed encode against the JAX ones with the streaming
route forced in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custrings_tpu import column as jcol
from custrings_tpu.ops import array as jarray
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import pallas_route as jroute
from custrings_tpu.ops import unique as juq
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.ops import array as tarray
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import route as troute
from custrings_tpu_torch.ops import shift_compact as tshift
from custrings_tpu_torch.ops import unique as tuq

from test_torch_slice import CORPUS
from test_torch_window import MIXED


@pytest.mark.parametrize("n", [256, 500, 5000])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_compact_stream_matches_pallas(n, density):
    rng = np.random.default_rng(n + int(density * 7))
    keep = rng.random(n) < density
    data = rng.integers(0, 256, n).astype(np.uint8)
    v32 = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    (w8, w32), wk0 = jroute.compact_stream(
        jnp.asarray(keep), [jnp.asarray(data), jnp.asarray(v32)], tile=256
    )
    (g8, g32, g64), k0 = troute.compact_stream(
        torch.from_numpy(keep),
        [torch.from_numpy(data), torch.from_numpy(v32), torch.from_numpy(v32.astype(np.int64))],
    )
    np.testing.assert_array_equal(g8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))
    np.testing.assert_array_equal(g64.numpy(), np.asarray(w32).astype(np.int64))
    np.testing.assert_array_equal(k0.numpy(), np.asarray(wk0))
    (s8,), sk0 = tshift.compact_arrays(torch.from_numpy(keep), [torch.from_numpy(data)])
    np.testing.assert_array_equal(s8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(sk0.numpy(), np.asarray(wk0))


@pytest.mark.parametrize("n", [256, 500, 5000])
@pytest.mark.parametrize("step", [0, 2, 40])
def test_expand_stream_matches_pallas(n, step):
    rng = np.random.default_rng(n + step)
    live = rng.random(n) < 0.5
    dist = np.maximum.accumulate(rng.integers(0, step + 1, n)).astype(np.int32)
    live = live & ((np.arange(n) + dist) < n)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    v32 = rng.integers(-999, 999, n).astype(np.int32)
    (w8, w32), wpl = jroute.expand_stream(
        jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(vals), jnp.asarray(v32)],
        tile=256, align=512,
    )
    (g8, g32), placed = troute.expand_stream(
        torch.from_numpy(live), torch.from_numpy(dist),
        [torch.from_numpy(vals), torch.from_numpy(v32)],
    )
    np.testing.assert_array_equal(placed.numpy(), np.asarray(wpl))
    np.testing.assert_array_equal(g8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))


def test_expand_stream_out_cap_matches_pallas():
    # out_cap > n: elements land past the input length; out_cap < n: the
    # ones whose target is past the output drop out
    n = 600
    rng = np.random.default_rng(3)
    live = np.ones(n, bool)
    dist = np.full(n, 700, np.int32)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    for out_cap in (n + 768, 1000):
        (want,), wpl = jroute.expand_stream(
            jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(vals)],
            out_cap=out_cap, tile=256, align=512,
        )
        (got,), placed = troute.expand_stream(
            torch.from_numpy(live), torch.from_numpy(dist), [torch.from_numpy(vals)], out_cap=out_cap
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(placed.numpy(), np.asarray(wpl))


def test_route_refuses_bad_planes():
    keep = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="plane"):
        troute.compact_stream(keep, [torch.zeros(4, dtype=torch.float32)])
    with pytest.raises(ValueError, match="mask"):
        troute.expand_stream(torch.ones(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), [keep])
    with pytest.raises(ValueError, match="dist"):
        troute.expand_stream(keep, torch.zeros(5, dtype=torch.int32), [keep])


@pytest.fixture
def stream_views(monkeypatch):
    """Force the streaming padded view in both packages (and the JAX
    package's window-kernel route, so its char matrix is the hybrid build
    over the streaming view, as on the TPU)."""
    monkeypatch.setenv("CUSTRINGS_STREAM_VIEW", "1")
    monkeypatch.setenv("CUSTRINGS_PALLAS_WINDOW", "1")
    monkeypatch.setattr(tlayout, "STREAM_VIEW_MIN", 0)


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


@pytest.mark.parametrize("width", [8, 64, "full"])
def test_stream_views_match_jax(stream_views, width):
    t, j = _pair(MIXED + CORPUS[:60])
    full = -(-tlayout.max_row_bytes(t) // 4) * 4
    w = full if width == "full" else width
    assert tlayout._use_stream_view(t, w)
    np.testing.assert_array_equal(
        tlayout.padded_view(t, w).numpy(), np.asarray(jlayout.padded_view(j, w))
    )
    np.testing.assert_array_equal(
        tarray._key_words(t, w).numpy(), np.asarray(jarray._key_words(j, w)).view(np.int32)
    )
    if width == "full":
        mat, nch = tlayout.char_matrix(t, w)
        jmat, jnch = jlayout.char_matrix(j, w)
        np.testing.assert_array_equal(nch.numpy(), np.asarray(jnch))
        np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))


def test_stream_encode_hashed_matches_jax(stream_views):
    strs = CORPUS[:300] + [CORPUS[0]] * 3
    t, j = _pair(strs)
    full = -(-jlayout.max_row_bytes(j) // 4) * 4
    got = tuq._encode_hashed(t, 64, full)
    want = juq._encode_hashed(j, 64, full)
    values, key_rows, nkeys, amb, u, ucap = got
    jv, jk, jn, ja, ju, jucap = want
    assert (int(nkeys), bool(amb), int(u), ucap) == (int(jn), bool(ja), int(ju), jucap)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(key_rows.numpy()[: int(nkeys)], np.asarray(jk)[: int(jn)])
