"""Port parity for the regex span ops (count_re, findall_record,
findall_columns, replace_re) and the facade methods on them: the same
seeded rows (nulls, empties, non-ASCII) through custrings_tpu and
custrings_tpu_torch, compared exactly (counts; valid rows' bytes,
offsets and validity), plus Python `re` as a second oracle.  The port
runs its plain span passes (K5's CPU route)."""

import importlib.util
import os
import re

import numpy as np
import pytest

import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import substr as jsub
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import substr as tsub
from custrings_tpu_torch.regex import ops as trx


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXTRA = ["a@b c@d", "the that ththat", "", None, "x@y@z w@v", "aé@b thé@x", "thethe", "#日本 #ü_1 #a"]
ROWS = _chip_smoke().make_corpus(2000, seed=3, max_bytes=60) + EXTRA
SHORT = ["", "a", "ba", "aab", "bbb", None, "aé", "xaay"] * 4  # empty matches: a*, x?
PATTERNS = ["the|that", r"#\w+", r"(\w+)@(\w+)", r"\bthe\b"]


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


_COLS = {}


def _cols(name):
    if name not in _COLS:
        _COLS[name] = _pair({"rows": ROWS, "short": SHORT, "bucketed": _bucketed()}[name])
    return _COLS[name]


def _bucketed():
    rng = np.random.default_rng(4)
    return ["s %d the" % i for i in range(300)] + ["#ü" + "the a@b " * int(k) for k in rng.integers(30, 40, 12)] + [None]


def _same_column(t, j):
    """Offsets, validity and each valid row's bytes are equal."""
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    assert tcol.to_host_strings(t) == jcol.to_host_strings(j)


CASES = [("rows", p) for p in PATTERNS] + [("short", "a*"), ("short", "x?"), ("bucketed", r"#\w+")]


@pytest.mark.parametrize("name,pattern", CASES)
def test_count_and_findall_record_parity(name, pattern):
    t, j = _cols(name)
    if name == "bucketed":
        assert tlayout.length_buckets(t) is not None and jlayout.length_buckets(j) is not None
    counts = trx.count_re(t, pattern).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jrx.count_re(j, pattern)))
    got, want = trx.findall_record(t, pattern), jrx.findall_record(j, pattern)
    _same_column(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.row_offsets.numpy(), np.asarray(want.row_offsets))
    np.testing.assert_array_equal(got.row_validity.numpy(), np.asarray(want.row_validity))
    np.testing.assert_array_equal(np.diff(got.row_offsets.numpy()), counts)


@pytest.mark.parametrize("name,pattern", CASES)
def test_findall_columns_parity(name, pattern):
    t, j = _cols(name)
    got, want = trx.findall_columns(t, pattern), jrx.findall_columns(j, pattern)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_column(a, b)


@pytest.mark.parametrize("n", [-1, 1])
@pytest.mark.parametrize("name,pattern", CASES)
def test_replace_re_parity(name, pattern, n):
    t, j = _cols(name)
    _same_column(trx.replace_re(t, pattern, "EMAIL", n), jrx.replace_re(j, pattern, "EMAIL", n))


@pytest.mark.parametrize("pattern", ["the|that", r"(\w+)@(\w+)", r"#\w+"])
def test_facade_matches_jax_and_python_re(pattern):
    s, js = tnv.to_device(ROWS, device="cpu"), jnv.to_device(ROWS)
    rx = re.compile(pattern)
    count = s.count(pattern)
    assert count == list(js.count(pattern))
    assert count == [0 if x is None else sum(1 for _ in rx.finditer(x)) for x in ROWS]
    rec = [None if r is None else r.to_host() for r in s.findall_record(pattern)]
    assert rec == [None if r is None else r.to_host() for r in js.findall_record(pattern)]
    assert rec == [None if x is None else [m.group(0) for m in rx.finditer(x)] for x in ROWS]
    cols = [c.to_host() for c in s.findall(pattern)]
    assert cols == [c.to_host() for c in js.findall(pattern)]
    rep = s.replace(pattern, "EMAIL", regex=True).to_host()
    assert rep == js.replace(pattern, "EMAIL", regex=True).to_host()
    assert rep == [None if x is None else rx.sub("EMAIL", x) for x in ROWS]


def test_empty_column():
    t, j = _pair([])
    assert trx.count_re(t, "a").shape == (0,)
    assert trx.findall_record(t, "a").nrows == 0
    assert trx.findall_columns(t, "a") == [] == jrx.findall_columns(j, "a")
    assert tcol.to_host_strings(trx.replace_re(t, "a", "b")) == []


@pytest.mark.parametrize("pattern,why", [("a|ab", "ordered_spans"), ("a" * 40, "nfa_spans")])
def test_uncovered_span_programs_raise(pattern, why):
    """Programs the bit span passes cannot take (not certified, or over 32
    instructions) raise, naming the engine they need; never a silent
    answer from another route."""
    t, _ = _pair(["xab", "a" * 45, None])
    for op in (trx.count_re, trx.findall_record, trx.findall_columns, lambda c, p: trx.replace_re(c, p, "z")):
        with pytest.raises(NotImplementedError, match=why):
            op(t, pattern)
    with pytest.raises(NotImplementedError, match=why):
        tnv.nvstrings(t).replace(pattern, "z")


@pytest.mark.parametrize("name", ["ascii", "mixed"])
def test_char_map_and_codepoints_parity(name):
    strs = [x for x in ROWS if x is None or x.isascii()] if name == "ascii" else ROWS
    t, j = _pair(strs)
    assert tlayout.is_ascii(t) == (name == "ascii")
    cm, jcm = tlayout.char_map(t), jlayout.char_map(j)
    total = int(cm.cs0[-1])
    np.testing.assert_array_equal(cm.cs0.numpy(), np.asarray(jcm.cs0))
    np.testing.assert_array_equal(cm.char_offsets.numpy(), np.asarray(jcm.char_offsets))
    np.testing.assert_array_equal(cm.char_pos.numpy()[:total], np.asarray(jcm.char_pos)[:total])
    np.testing.assert_array_equal(cm.nchars().numpy(), np.asarray(jcm.nchars()))
    np.testing.assert_array_equal(
        tlayout.codepoints(t).numpy()[:total], np.asarray(jlayout.codepoints(j))[:total]
    )


def test_slice_from_parity():
    t, j = _cols("rows")
    rng = np.random.default_rng(6)
    starts = rng.integers(-2, 30, t.size).astype(np.int32)
    stops = rng.integers(-2, 40, t.size).astype(np.int32)
    _same_column(tsub.slice_from(t, starts, stops), jsub.slice_from(j, starts, stops))
    _same_column(tsub.slice_from(t), jsub.slice_from(j))
