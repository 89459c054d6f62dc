"""Port parity for the whitespace split, the right-to-left split, partition
and rpartition, the ragged token split and its cover-compact writer,
against custrings_tpu on the same host strings (Pallas K3 in interpret
mode, as the JAX package's own tests run it on the CPU), with a Python
oracle beside it.  Compared exactly: token counts, valid rows' bytes,
offsets and validity, never buffer capacities (they differ by design).

Whitespace here is every code point <= 0x20, not `str.isspace`: the rows
hold \\xa0, \\u3000 and \\x85 inside words, and \\x00-\\x08, \\x0e-\\x1b and
\\x1f between them."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import custrings_tpu.column as jcolumn
import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import pallas_route as jroute
from custrings_tpu.ops import split as jsp
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import route as troute
from custrings_tpu_torch.ops import split as tsp

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def fast_reference_compiles():
    """The reference's XLA programs compiled without most optimizations
    while this module runs: on a few hundred rows compiling dominates, and
    every split variant (delimiter, limit, direction, route) is a program of
    its own."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)

WORDS = ["the", "a", "of", "quick", "aa", "aaaa", "aaa", "é", "naïve", "日本語", "😀", "x😀y",
         "a\xa0b", "　", "w\x85", "z,z", "::", "the,the", "#tag", "b#c#d", "aa,a", "ab::"]
SPACES = [" ", " ", "  ", "\t", "\n", "\x0b", "\x0c", "\r", "\x1f", "\x00", "\x01", "\x08",
          "\x0e", "\x1b", " \t "]
SPECIALS = [None, "", " ", "   ", "\t\n", "a", " a b ", "a b c d e", "aaaa", "aaa", "::::",
            "#", "a#", "#a", "\x00", "a\x00b", "\xa0", "　a　", "x\x85 y", "é é"]


def ws_rows(n: int = 280, seed: int = 0):
    """Seeded rows of words among whitespace runs of every class, with
    leading and trailing whitespace, nulls, empty and whitespace-only rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.random()
        if k < 0.04:
            out.append(None)
        elif k < 0.07:
            out.append("")
        elif k < 0.11:
            out.append("".join(SPACES[i] for i in rng.integers(0, len(SPACES), rng.integers(1, 4))))
        else:
            parts = [SPACES[rng.integers(len(SPACES))]] if rng.random() < 0.3 else []
            for t in range(int(rng.integers(1, 8))):
                if t:
                    parts.append(SPACES[rng.integers(len(SPACES))])
                parts.append(WORDS[rng.integers(len(WORDS))])
            if rng.random() < 0.3:
                parts.append(SPACES[rng.integers(len(SPACES))])
            out.append("".join(parts))
    return out + SPECIALS


STRS = ws_rows()


def pair(strs):
    """(port column on the CPU, JAX column) of the same strings."""
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


T, J = pair(STRS)


def same_column(t, j):
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    assert tcol.to_host_strings(t) == jcol.to_host_strings(j)


def same_tokens(got, want):
    same_column(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.row_offsets.numpy(), np.asarray(want.row_offsets))
    np.testing.assert_array_equal(got.row_validity.numpy(), np.asarray(want.row_validity))


def records(tc):
    toks = tcol.to_host_strings(tc.tokens)
    ro = tc.row_offsets.numpy()
    return [toks[ro[i]: ro[i + 1]] if v else None for i, v in enumerate(tc.row_validity.tolist())]


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the whitespace split's oracle is chip_smoke.py's, so these tests hold it
# to custrings_tpu too: words are runs of code points > 0x20, a row without
# one gives [""], and at the limit the last token (from the right, the
# first) keeps the rest of the row
CS = _chip_smoke()
ws_split = CS.ws_split


def force_count_first(monkeypatch):
    """Send run_ragged and the delimiter split over BOUND_SYNC_THRESHOLD in
    both packages: the token count is synced first."""
    monkeypatch.setattr(tsp, "BOUND_SYNC_THRESHOLD", 64)
    monkeypatch.setattr(jcolumn, "BOUND_SYNC_THRESHOLD", 64)


@pytest.mark.parametrize("n,right,route", [
    (-1, False, "fused"), (0, False, "fused"), (1, False, "fused"), (2, False, "fused"),
    (-1, True, "fused"), (1, True, "fused"), (2, True, "fused"),
    (-1, False, "count_first"), (1, True, "count_first"),
])
def test_whitespace_split_parity(monkeypatch, n, right, route):
    if route == "count_first":
        force_count_first(monkeypatch)
    fn, jfn = (tsp.rsplit_record, jsp.rsplit_record) if right else (tsp.split_record, jsp.split_record)
    got = fn(T, None, n)
    same_tokens(got, jfn(J, None, n))
    assert records(got) == [ws_split(s, n, right) for s in STRS]


@pytest.mark.parametrize("n,right", [(-1, False), (2, True)])
def test_ws_body_extents_parity(n, right):
    counts = tsp._ws_body(T, None, n, right)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jsp._ws_body(J, None, n, right)))
    total = int(counts.sum())
    c, s, e = tsp._ws_body(T, 4096, n, right)
    jc, js, je = jsp._ws_body(J, 4096, n, right)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy()[:total], np.asarray(js)[:total])
    np.testing.assert_array_equal(e.numpy()[:total], np.asarray(je)[:total])


def _py_rsplit(s, d, n):
    return None if s is None else s.rsplit(d, n if n > 0 else -1)


@pytest.mark.parametrize("delim,n,route", [
    (" ", -1, "fused"), (" ", 1, "count_first"), ("é", 2, "count_first"),
    ("aa", -1, "count_first"), ("aa", 1, "fused"), ("aa", 2, "fused"), ("::", 1, "fused"),
    ("#", 0, "count_first"),
])
def test_rsplit_delimiter_parity(monkeypatch, delim, n, route):
    """rsplit on a delimiter: at the row's start or end, absent, multi-byte,
    or overlapping ("aa" in "aaaa" and "aaa")."""
    if route == "count_first":
        force_count_first(monkeypatch)
    got = tsp.rsplit_record(T, delim, n)
    same_tokens(got, jsp.rsplit_record(J, delim, n))
    assert records(got) == [_py_rsplit(s, delim, n) for s in STRS]


@pytest.mark.parametrize("body,delim,n", [
    ("_delim_body", "aa", 1), ("_delim_extents_stream", " ", 1),
])
def test_rsplit_extents_bodies_parity(body, delim, n):
    counts = getattr(tsp, body)(T, None, delim, n, None, True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(getattr(jsp, body)(J, None, delim, n, True)))
    total = int(counts.sum())
    c, s, e = getattr(tsp, body)(T, 4096, delim, n, None, True)
    jc, js, je = getattr(jsp, body)(J, 4096, delim, n, True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy()[:total], np.asarray(js)[:total])
    np.testing.assert_array_equal(e.numpy()[:total], np.asarray(je)[:total])


@pytest.mark.parametrize("delim,n", [(None, 1), ("aa", -1)])
def test_rsplit_columns_parity(delim, n):
    cols, jcols = tsp.rsplit_columns(T, delim, n), jsp.rsplit_columns(J, delim, n)
    assert len(cols) == len(jcols)
    for a, b in zip(cols, jcols):
        same_column(a, b)


def _py_partition(s, d, right):
    if s is None:
        return [None] * 3
    return list(s.rpartition(d) if right else s.partition(d))


@pytest.mark.parametrize("delim,right", [
    (" ", False), ("é", False), ("aa", True), ("\x00", True),
])
def test_partition_parity(delim, right):
    """partition / rpartition: the find's char position mapped to bytes,
    with non-ASCII rows before the delimiter."""
    fn, jfn = (tsp.rpartition, jsp.rpartition) if right else (tsp.partition, jsp.partition)
    got, want = fn(T, delim), jfn(J, delim)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        same_column(a, b)
    rows = [tcol.to_host_strings(c) for c in got]
    assert [list(r) for r in zip(*rows)] == [_py_partition(s, delim, right) for s in STRS]


def test_partition_empty_delimiter_parity():
    """An empty delimiter is found nowhere: [row, "", ""] / ["", "", row]."""
    for fn, jfn in ((tsp.partition, jsp.partition), (tsp.rpartition, jsp.rpartition)):
        for a, b in zip(fn(T, ""), jfn(J, "")):
            same_column(a, b)


def test_cover_spans_matches_jax():
    """The writer's cover mask against the JAX `cover_spans` on disjoint
    spans, with empty and dead ones among them."""
    rng = np.random.default_rng(3)
    cap = 5000
    bounds = np.sort(rng.choice(cap, 1200, replace=False)).astype(np.int32)
    bb, ee = bounds[0::2], bounds[1::2]
    ee = np.where(rng.random(bb.shape[0]) < 0.1, bb, ee)  # empty spans
    ok = rng.random(bb.shape[0]) < 0.8
    got = troute.cover_spans(torch.from_numpy(bb), torch.from_numpy(ee), torch.from_numpy(ok), cap)
    want = jroute.cover_spans(bb, ee, ok, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("right", [False, True])
def test_cover_compact_writer_matches_the_gather_writer(right):
    """The token bytes by cover + compaction (K4c's plain version) equal the
    JAX gather writer's on the whitespace split's own extents."""
    c, s, e = tsp._ws_body(T, 4096, 1, right)
    tok_off = tcol.cumsum0(c)
    total = int(tok_off[-1])
    tvalid = torch.arange(4096) < total
    byte_off = tcol.cumsum0(torch.where(tvalid, e - s, 0))
    bcap = T.capacity
    got = tsp._ragged_write(T, s, byte_off, bcap)
    want = jsp._ragged_write_body(J, np.asarray(s), np.asarray(byte_off), bcap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_column_splits():
    t, j = pair([])
    for fn, jfn in ((tsp.split_record, jsp.split_record), (tsp.rsplit_record, jsp.rsplit_record)):
        for d in (None, " "):
            same_tokens(fn(t, d), jfn(j, d))


def test_facade_whitespace_split_and_partition():
    """The facade's record and column forms (ops held to custrings_tpu
    above) against the oracles; one of each against the JAX facade."""
    s = tnv.to_device(STRS, device="cpu")

    def rec(rs):
        return [None if r is None else r.to_host() for r in rs]

    assert rec(s.split_record(None)) == [ws_split(x, -1, False) for x in STRS]
    assert rec(s.split_record(None, 2)) == [ws_split(x, 2, False) for x in STRS]
    assert rec(s.rsplit_record(None, 2)) == [ws_split(x, 2, True) for x in STRS]
    assert rec(s.rsplit_record(" ", 1)) == [_py_rsplit(x, " ", 1) for x in STRS]
    assert rec(s.partition(" ")) == [_py_partition(x, " ", False) for x in STRS]
    assert rec(s.rpartition("#")) == [_py_partition(x, "#", True) for x in STRS]
    cols = [c.to_host() for c in s.rsplit(None, 1)]
    assert [list(r) for r in zip(*cols)] == [
        [None] * 2 if x is None else ws_split(x, 1, True) + [None] * (2 - len(ws_split(x, 1, True)))
        for x in STRS
    ]
    js = jnv.to_device(STRS)
    assert rec(s.rpartition("#")) == rec(js.rpartition("#"))
    assert [c.to_host() for c in s.split(None)] == [c.to_host() for c in js.split(None)]
