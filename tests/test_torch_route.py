"""Port parity for K4c/K4e and the streaming padded views built on them:
the plain compaction and expansion of custrings_tpu_torch against the
Pallas stream kernels of custrings_tpu in interpret mode (small tiles, so
several tiles are stitched), and the streaming padded view, char matrix,
key words and hashed encode against the JAX ones with the streaming
route forced in both packages."""

import types

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

import chip_smoke as CS
from test_torch_slice import CORPUS
from test_torch_window import MIXED

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


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


def _np_compact(keep, planes):
    """numpy's compaction: each plane's kept elements stably to the front,
    zeros after, and the exclusive prefix count with the total."""
    keep = np.asarray(keep).astype(bool)
    outs = []
    for a in planes:
        out = np.zeros_like(a)
        kept = a[keep]
        out[: kept.shape[0]] = kept
        outs.append(out)
    return outs, np.concatenate([[0], np.cumsum(keep)]).astype(np.int32)


@pytest.mark.parametrize("n", [1, 300])
def test_compact_stream_k0_forms_and_views_match_pallas(n):
    """On views with a storage offset (data[1:], keep[1:]): want_k0=False
    gives the same planes and None for k0, a given k0 the same as one
    computed, and compact_arrays passes want_k0 through."""
    rng = np.random.default_rng(40 + n)
    keep_full = rng.random(n + 1) < 0.5
    data_full = rng.integers(0, 256, n + 1).astype(np.uint8)
    v32 = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    (w8, w32), wk0 = jroute.compact_stream(
        jnp.asarray(keep_full[1:]), [jnp.asarray(data_full[1:]), jnp.asarray(v32)], tile=256
    )
    keep, data = torch.from_numpy(keep_full)[1:], torch.from_numpy(data_full)[1:]
    assert keep.storage_offset() == 1 and data.storage_offset() == 1
    planes = [data, torch.from_numpy(v32)]
    written, k0 = troute.compact_stream(keep, planes)
    unwanted, none = troute.compact_stream(keep, planes, want_k0=False)
    given, k0_given = troute.compact_stream(keep, planes, k0)
    assert none is None and torch.equal(k0_given, k0)
    np.testing.assert_array_equal(k0.numpy(), np.asarray(wk0))
    for g8, g32 in (written, unwanted, given):
        np.testing.assert_array_equal(g8.numpy(), np.asarray(w8))
        np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))
    (s8,), s_none = tshift.compact_arrays(keep, [data], want_k0=False)
    assert s_none is None
    np.testing.assert_array_equal(s8.numpy(), np.asarray(w8))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_stream_eight_mixed_planes(density):
    """Eight planes of every element type (the JAX kernel takes none of
    bool or int64, so numpy is the reference), all or none kept too, with
    k0 written, given and not wanted."""
    n = 700
    rng = np.random.default_rng(int(density * 10) + 50)
    keep = rng.random(n) < density
    planes = [rng.integers(0, 256, n).astype(np.uint8), rng.random(n) < 0.5,
              rng.integers(-(2**31), 2**31, n).astype(np.int32), rng.integers(-(2**62), 2**62, n),
              rng.integers(0, 256, n).astype(np.uint8), rng.integers(-9, 9, n).astype(np.int32),
              rng.integers(-(2**40), 2**40, n), rng.random(n) < 0.1]
    want, wk0 = _np_compact(keep, planes)
    tk, tp = torch.from_numpy(keep), [torch.from_numpy(a) for a in planes]
    for k0, want_k0 in ((None, True), (torch.from_numpy(wk0), True), (None, False)):
        got, k0_out = troute.compact_stream(tk, tp, k0, want_k0)
        assert [g.dtype for g in got] == [a.dtype for a in tp]
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w)
        if want_k0:
            np.testing.assert_array_equal(k0_out.numpy(), wk0)
        else:
            assert k0_out is None


def test_compact_stream_empty_and_refusals():
    """n = 0 gives empty planes and k0 = [0]; more than eight planes and a
    k0 of the wrong length are refused."""
    keep = torch.zeros(0, dtype=torch.bool)
    (out,), k0 = troute.compact_stream(keep, [torch.zeros(0, dtype=torch.uint8)])
    assert out.shape == (0,) and k0.tolist() == [0]
    assert troute.compact_stream(keep, [torch.zeros(0, dtype=torch.int64)], want_k0=False)[1] is None
    keep = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="at most 8"):
        troute.compact_stream(keep, [torch.zeros(4, dtype=torch.uint8)] * 9)
    with pytest.raises(ValueError, match="k0"):
        troute.compact_stream(keep, [torch.zeros(4, dtype=torch.uint8)], torch.zeros(4, dtype=torch.int32))


def test_compact_edge_cases_on_cpu():
    """chip_smoke.compact_edge_cases (the cases the card runs; here with a
    small capacity, each wrapper its plain version) against numpy: every
    plane and k0, None where k0 is not wanted."""
    cases = CS.compact_edge_cases(torch, device="cpu", cap=2 * CS.COMPACT_TILE + 77)
    assert len(cases) >= 30
    labels = " | ".join(c[0] for c in cases)
    for part in ("(sub-tile - 1)", "(sub-tile + 1)", "(tile - 1)", "(tile + 1)", "density 0.0", "density 0.0001", "density 1.0", "eight mixed planes",
                 "k0 given", "k0 not wanted", "data[1:]", "keep[3:]", "u8[0]", "[1] density", "bool[",
                 "i64[", "uint8 keep"):
        assert part in labels, part
    for label, keep, planes, k0, want_k0 in cases:
        want, wk0 = _np_compact(keep.numpy(), [a.numpy() for a in planes])
        got, k0_out = troute.compact_stream(keep, planes, k0, want_k0)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=label)
        if want_k0:
            np.testing.assert_array_equal(k0_out.numpy(), wk0, err_msg=label)
        else:
            assert k0_out is None, label
        bound = CS._compact_stream_bound(keep, planes, k0 is not None, want_k0)[0]
        assert bound >= keep.shape[0] * (1 + sum(a.element_size() for a in planes)), label


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


def _live_dist(n, seed, garbage):
    """live bool[n] and dist int32[n], nondecreasing over the live lanes;
    with `garbage` the dead lanes carry unordered values (negative and
    past any output), as the grow writer's padding and the split's
    leftover lanes do."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) < 0.6
    dist = np.maximum.accumulate(rng.integers(0, 3, n)).astype(np.int32)
    if garbage:
        dist = np.where(live, dist, rng.integers(-(2**31), 2**31 - 1, n)).astype(np.int32)
    return live, dist


def _jax_expand(live, dist, planes, out_cap):
    """The Pallas expansion (interpret mode) with the dead lanes'
    distances forward-filled, as custrings_tpu's shift_compact does
    before its kernel route."""
    dmono = np.maximum.accumulate(np.where(live, dist, 0)).astype(np.int32)
    return jroute.expand_stream(jnp.asarray(live), jnp.asarray(dmono), [jnp.asarray(a) for a in planes],
                                out_cap=out_cap, tile=256, align=512)


@pytest.mark.parametrize("garbage", [False, True])
def test_expand_stream_mixed_planes_match_pallas(garbage):
    """One call moving uint8, int32 and int64 planes, with dead lanes'
    dist ordered or garbage, against the Pallas kernel: the int64 plane
    against the int32 one's result shifted."""
    n = 3000
    live, dist = _live_dist(n, 5, garbage)
    rng = np.random.default_rng(6)
    v8 = rng.integers(0, 256, n).astype(np.uint8)
    v32 = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    (w8, w32), wpl = _jax_expand(live, dist, [v8, v32], n)
    (g8, g32, g64), placed = troute.expand_stream(
        torch.from_numpy(live), torch.from_numpy(dist),
        [torch.from_numpy(v8), torch.from_numpy(v32), torch.from_numpy(v32.astype(np.int64) << 20)])
    np.testing.assert_array_equal(placed.numpy(), np.asarray(wpl))
    np.testing.assert_array_equal(g8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))
    np.testing.assert_array_equal(g64.numpy(), np.asarray(w32).astype(np.int64) << 20)


@pytest.mark.parametrize("want_placed", [True, False])
@pytest.mark.parametrize("out_cap", ["n // 2", "n", "2n"])
def test_expand_stream_out_cap_and_placed_match_pallas(out_cap, want_placed):
    """out_cap below, at and above n, with dead lanes carrying garbage
    dist; without placed the planes equal the call with it and placed is
    None."""
    n = 2000
    m = {"n // 2": n // 2, "n": n, "2n": 2 * n}[out_cap]
    live, dist = _live_dist(n, 9, True)
    vals = np.random.default_rng(10).integers(0, 256, n).astype(np.uint8)
    (want,), wpl = _jax_expand(live, dist, [vals], m)
    args = (torch.from_numpy(live), torch.from_numpy(dist), [torch.from_numpy(vals)], m)
    (got,), placed = troute.expand_stream(*args, want_placed=want_placed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if want_placed:
        np.testing.assert_array_equal(placed.numpy(), np.asarray(wpl))
    else:
        assert placed is None
        (with_placed,), _ = troute.expand_stream(*args)
        assert torch.equal(got, with_placed)
        (shifted,), none = tshift.expand_to(*args, want_placed=False)
        assert none is None and torch.equal(shifted, got)


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


@pytest.mark.parametrize("rows,width", [(1, 8), (1 << 20, 64), (1 << 20, 320), (1 << 26, 4096)])
def test_views_route_a_cuda_column_to_the_window(monkeypatch, rows, width):
    """The route predicate sends a column on the card to the K1 window view
    at every size, small or past the JAX package's STREAM_VIEW_MIN (a stub
    column: the predicate reads only the size), and the streaming route
    stays reachable through the layout's STREAM_VIEW_MIN, as the
    stream_views fixture sets it."""
    stub = types.SimpleNamespace(size=rows, device=torch.device("cuda"))
    assert not tlayout._use_stream_view(stub, width)
    monkeypatch.setattr(tlayout, "STREAM_VIEW_MIN", 0)
    assert tlayout._use_stream_view(stub, width)


def test_views_entry_points_never_stream(monkeypatch):
    """padded_view, char_matrix and the key words at the default route build
    no streaming view (K4c/K4e would raise here) and equal the JAX
    package's window views.  The column's non-ASCII row ids, which K4c
    compacts, are cached first, as after the column's first op."""

    def refuse(*a, **k):
        raise AssertionError("the streaming route was taken")

    t, j = _pair(MIXED + CORPUS[:60])
    assert len(tlayout.row_nonascii_ids(t))
    monkeypatch.setattr(tlayout, "expand_stream", refuse)
    monkeypatch.setattr(tlayout, "compact_arrays", refuse)
    full = -(-tlayout.max_row_bytes(t) // 4) * 4
    for w in (8, 64, full):
        np.testing.assert_array_equal(tlayout.padded_view(t, w).numpy(), np.asarray(jlayout.padded_view(j, w)))
        np.testing.assert_array_equal(
            tarray._key_words(t, w).numpy(), np.asarray(jarray._key_words(j, w)).view(np.int32)
        )
    mat, nch = tlayout.char_matrix(t, full)
    jmat, jnch = jlayout.char_matrix(j, full)
    np.testing.assert_array_equal(nch.numpy(), np.asarray(jnch))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
