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

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

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


@pytest.mark.parametrize("width", [1, 15, 16, 17, 31, 100, 513])
def test_ragged_gather_bytes_matches_pallas(width):
    data, starts = _windows()
    want = np.asarray(jwin.ragged_gather_i32(jnp.asarray(data), jnp.asarray(starts), width))
    got = twin.ragged_gather_i32(torch.from_numpy(data), torch.from_numpy(starts), width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got8 = twin.ragged_gather(torch.from_numpy(data), torch.from_numpy(starts), width)
    np.testing.assert_array_equal(got8.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("width", [1, 8, 15, 16, 17, 31, 64, "full"])
def test_masked_gather_matches_jax_window_view(width):
    """K1 masked at the row lengths in the gather equals the JAX package's
    window view (its Pallas gather in interpret mode, then the mask), as
    bytes and as the int32 matrix the char matrix starts from: widths
    below, at and past the longest row, with empty, null, BMP and astral
    rows."""
    t, j = _pair(MIXED)
    w = tlayout.max_row_bytes(t) if width == "full" else width
    want = np.asarray(jlayout._padded_view_pallas(j.data, j.offsets, w))
    np.testing.assert_array_equal(want, np.asarray(jlayout._padded_view(j.data, j.offsets, w)))
    starts, lens = t.offsets[:-1], t.lengths()
    np.testing.assert_array_equal(twin.ragged_gather(t.data, starts, w, lens).numpy(), want)
    got32 = twin.ragged_gather_i32(t.data, starts, w, lens)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy(), want.astype(np.int32))


def test_masked_gather_past_the_buffer_matches_pallas():
    """Lengths that run past the buffer's end, and zero lengths, against the
    Pallas gather masked on the host."""
    data, starts = _windows()
    lens = np.random.default_rng(8).integers(0, 700, starts.shape[0]).astype(np.int32)
    lens[:3] = 0
    raw = np.asarray(jwin.ragged_gather(jnp.asarray(data), jnp.asarray(starts), 513))
    want = np.where(np.arange(513)[None, :] < lens[:, None], raw, 0).astype(np.uint8)
    got = twin.ragged_gather(torch.from_numpy(data), torch.from_numpy(starts), 513, torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_edge_cases_match_pallas():
    """chip_smoke.window_edge_cases, K1's edges on the card, run on the CPU:
    each case through the port's wrapper against the Pallas kernel in
    interpret mode (masked on the host where the case has lengths), and
    against the gather's definition in numpy.  Each buffer reaches the
    Pallas kernel zero-padded to the base buffer's length, which keeps the
    function (the port reads zeros past cap) and one compile a padded
    width; rows with a negative start are held to numpy alone, since the
    Pallas kernel clips starts to 0."""
    cs = _chip_smoke()
    nbytes = 3000
    cases = cs.window_edge_cases(torch, "cpu", rows=64, nbytes=nbytes)
    labels = [c[0] for c in cases]
    assert {c[3] for c in cases} >= {1, 15, 16, 17, 31, 513}
    assert {(c[4] is None, c[5]) for c in cases} == {(a, b) for a in (False, True) for b in (False, True)}
    assert sum("data[1:]" in x for x in labels) == 2
    assert sorted(int(x.split("16k+")[1].split(")")[0]) for x in labels if "16k+" in x) == list(range(1, 16))
    raw = {}
    for label, d, st, w, ln, i32 in cases:
        cap, s = d.shape[0], st.numpy()
        key = (d.storage_offset(), cap, id(st), w)
        if key not in raw:
            padded = np.zeros(nbytes, np.uint8)
            padded[:cap] = d.numpy()
            raw[key] = np.asarray(jwin.ragged_gather_i32(jnp.asarray(padded), jnp.asarray(s), w))
        g = s[:, None].astype(np.int64) + np.arange(w)[None, :]
        ref = np.where((g >= 0) & (g < cap), d.numpy()[np.clip(g, 0, cap - 1)], 0)
        want = raw[key]
        if ln is not None:
            keep = np.arange(w)[None, :] < ln.numpy()[:, None]
            ref, want = np.where(keep, ref, 0), np.where(keep, want, 0)
        got = (twin.ragged_gather_i32 if i32 else twin.ragged_gather)(d, st, w, ln)
        assert got.dtype == (torch.int32 if i32 else torch.uint8) and got.shape == (64, w), label
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=label)
        np.testing.assert_array_equal(got.numpy()[s >= 0], want[s >= 0], err_msg=label)


@pytest.mark.parametrize("width", [4, 64, 98])
def test_ragged_gather_words_matches_pallas(width):
    data, starts = _windows()
    want = np.asarray(jwin.ragged_gather_words(jnp.asarray(data), jnp.asarray(starts), width))
    got = twin.ragged_gather_words(torch.from_numpy(data), torch.from_numpy(starts), width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _word_case(case):
    """(data, lo, hi, starts) of a words-gather case, the buffer being
    data[lo:hi]: starts at every residue mod 16, windows running past a
    cap of 4k+1..4k+3 (some starting past it), or a data[1:] view."""
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, 997, dtype=np.uint8)
    if case == "residues":
        return data, 0, 997, (rng.integers(0, 50, 48) * 16 + np.arange(48) % 16).astype(np.int32)
    if case == "data[1:]":
        return data, 1, 997, (np.arange(48) * 19 % 900).astype(np.int32)
    cap = 4 * 200 + int(case[-1])  # "cap 4k+r"
    return data, 0, cap, (cap - 60 + np.arange(48) * 3).astype(np.int32)


@pytest.mark.parametrize("case", ["residues", "cap 4k+1", "cap 4k+2", "cap 4k+3", "data[1:]"])
@pytest.mark.parametrize("width", [4, 28, 64, 256])
def test_ragged_gather_words_edges_match_pallas(width, case):
    """The words gather at the encode's widths (and a 7-word one) with
    starts at every residue mod 16, windows past a cap that is not a
    multiple of 4, and a data[1:] view, against the Pallas kernel."""
    data, lo, hi, starts = _word_case(case)
    want = np.asarray(jwin.ragged_gather_words(jnp.asarray(data[lo:hi].copy()), jnp.asarray(starts), width))
    view = torch.from_numpy(data)[lo:hi]
    got = twin.ragged_gather_words(view, torch.from_numpy(starts), width)
    assert got.dtype == torch.int32 and got.shape == (48, -(-width // 4))
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


def _ascii_rows(n, seed, lo=19, hi=78):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghij klmnopqrstuvwxyz", np.uint8)
    return [bytes(rng.choice(letters, int(k))).decode() for k in rng.integers(lo, hi + 1, n)]


def _bucket_cases():
    """Columns that take each branch of length_buckets, the decision
    ROW_STATS records for each (None: no decision, under MIN_ROWS) and
    their non-ASCII rows (none, some or all)."""
    short = _ascii_rows(300, 1)
    cost = _ascii_rows(150, 2, 100, 100) + _ascii_rows(150, 3, 200, 200)
    merged = _ascii_rows(400, 4) + ["ü" * 300] * 10 + ["x" * 2000] + [None, ""] * 3
    on_widths = (short + ["é" * 128, "é" * 129, "日" * 512, "日" * 513, "😀" * 511]
                 + ["ab" * 200] * 130 + ["x" * 2000, None])
    return {
        "few_rows": (MIXED, None),
        "one_width": (short[:150] + [None, ""] * 10 + short[150:], "ladder_none"),
        "cost_refused": (cost, "cost_none"),
        "merged_upward": (merged, "bucketed"),
        "on_ladder_widths": (on_widths, "bucketed"),
        "all_null": ([None] * 300, "ladder_none"),
        "all_empty": ([""] * 300, "ladder_none"),
        "all_nonascii": (["é" * (k % 90 + 1) for k in range(300)], "ladder_none"),
    }


@pytest.mark.parametrize("case", list(_bucket_cases()))
def test_length_buckets_and_nonascii_ids_parity(case):
    """Every branch of the device-side row statistics against the JAX
    package's host numpy: the same decision, buckets, widths, row counts,
    ids, padding and validity, and the same non-ASCII row ids."""
    strs, decision = _bucket_cases()[case]
    t, j = _pair(strs)
    before = dict(tlayout.ROW_STATS)
    tb, jb = tlayout.length_buckets(t), jlayout.length_buckets(j)
    na, jna = tlayout.row_nonascii_ids(t), jlayout.row_nonascii_ids(j)
    moved = {k: v - before[k] for k, v in tlayout.ROW_STATS.items() if k != "host_bytes" and v != before[k]}
    nonascii = "nonascii_fetched" if len(jna) else "nonascii_none"
    assert moved == ({decision: 1, nonascii: 1} if decision else {nonascii: 1})
    assert (tb is None) == (jb is None) == (decision != "bucketed")
    assert na.dtype == np.int64
    np.testing.assert_array_equal(na, jna)
    if case == "merged_upward":
        assert [b.width for b in tb] == [128, 2048] and tb[-1].nv == 11  # the 300-char class merged up
    for a, b in zip(tb or [], jb or []):
        assert (a.width, a.nv) == (b.width, b.nv)
        assert a.idx_np.dtype == np.int64 and np.all(np.diff(a.idx_np) > 0)
        np.testing.assert_array_equal(a.idx_np, b.idx_np)
        np.testing.assert_array_equal(a.vmask.numpy(), np.asarray(b.vmask))
        np.testing.assert_array_equal(a.idx_c.numpy(), np.asarray(b.idx_c))
        np.testing.assert_array_equal(a.idx_s.numpy(), np.asarray(b.idx_s))
        assert a.idx_c.dtype == torch.int32 and a.idx_s.dtype == torch.int64


def test_the_none_path_reads_back_no_row_plane(monkeypatch):
    """contains_re on a 10k-row ASCII column whose rows all fit one width:
    one ladder-None decision and one zero-row non-ASCII lookup, counted
    once (cached on a second call), from one read-back of two scalars,
    at most 1 KiB; what the counter adds up is what was read back, and
    counting never synchronizes the device."""
    import re

    from custrings_tpu_torch.regex import ops as rops
    from custrings_tpu_torch.utils import tracing

    sync = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: sync.append(1))
    reads = []
    read_back = tlayout._read_back
    monkeypatch.setattr(tlayout, "_read_back", lambda x: reads.append(x.numel() * x.element_size()) or read_back(x))
    strs = _ascii_rows(10_000, 9)
    strs[::97] = [None] * len(strs[::97])
    strs[5] = "some special and requests"
    col = tcol.from_host_strings(strs, "cpu")
    before = dict(tlayout.ROW_STATS)
    got = rops.contains_re(col, "special.*requests")
    moved = {k: v - before[k] for k, v in tlayout.ROW_STATS.items() if v != before[k]}
    assert moved == {"ladder_none": 1, "nonascii_none": 1, "host_bytes": sum(reads)}
    assert len(reads) == 1 and 0 < sum(reads) <= 1024
    assert got.tolist() == [s is not None and re.search("special.*requests", s) is not None for s in strs]
    after = dict(tlayout.ROW_STATS)
    assert torch.equal(rops.contains_re(col, "special.*requests"), got)
    assert tlayout.ROW_STATS == after and len(reads) == 1 and not sync
    assert "layout.ROW_STATS: ladder_none=" in tracing.report()
    tracing.reset()
    assert not any(tlayout.ROW_STATS.values()) and "ROW_STATS" not in tracing.report()


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_encode_word_gathers_match_pallas_and_their_bound(monkeypatch):
    """The hashed encode's own ragged_gather_words calls, captured as
    chip_smoke.py captures them (key words from the row starts, tails from
    the sorted rows' and the representatives' starts), against the Pallas
    kernel; and chip_smoke's K1b bound counts the union of their windows."""
    from custrings_tpu_torch.ops import unique as tunique

    cs = _chip_smoke()
    monkeypatch.setattr(tunique, "HASHED_MIN", 64)
    col = tcol.from_host_strings(cs.make_corpus(400, seed=5), "cpu")
    calls = cs._captured_word_gathers(col)
    assert [c[0] for c in calls] == [
        "key words 64 (row starts)", "tails past 64 (sorted rows)", "tails past 64 (group representatives)",
        "key words 256 (row starts)", "tails past 256 (sorted rows)", "tails past 256 (group representatives)"]
    data = col.data.numpy()
    for label, d, st, w in calls:
        want = np.asarray(jwin.ragged_gather_words(jnp.asarray(data), jnp.asarray(st.numpy()), w))
        np.testing.assert_array_equal(twin.ragged_gather_words(d, st, w).numpy(), want, err_msg=label)
        wb, cover = 4 * -(-w // 4), np.zeros(data.shape[0], bool)
        for s in st.tolist():
            cover[max(s, 0):max(min(s + wb, data.shape[0]), 0)] = True
        assert cs._words_bound(torch, d, st, w) == (int(cover.sum()) + st.shape[0] * (wb + 4), 0), label
