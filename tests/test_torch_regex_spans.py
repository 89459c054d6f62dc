"""Port parity for the regex span ops count_re, findall_record and
findall_columns, char_map and slice_from: the same seeded rows (nulls,
empties, non-ASCII) through custrings_tpu and custrings_tpu_torch,
compared exactly (counts; valid rows' bytes, offsets and validity).  The
port runs its plain span passes (K5's CPU route).  replace_re and the
facade methods, with Python `re` as a second oracle, are in
test_torch_regex_replace.py, which shares this file's rows."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import substr as jsub
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import substr as tsub
from custrings_tpu_torch.regex import device as tdevice
from custrings_tpu_torch.regex import ops as trx

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


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


def test_empty_column():
    t, j = _pair([])
    assert trx.count_re(t, "a").shape == (0,)
    assert trx.findall_record(t, "a").nrows == 0
    assert trx.findall_columns(t, "a") == [] == jrx.findall_columns(j, "a")
    assert tcol.to_host_strings(trx.replace_re(t, "a", "b")) == []


@pytest.mark.parametrize("pattern,why", [("a|ab", "ordered_spans"), ("a" * 40, "nfa_spans")])
def test_uncovered_span_programs_raise(pattern, why, monkeypatch):
    """Programs the bit span passes cannot take (not certified, or over 32
    instructions) run on the torch span engine they need (`why`) and
    equal the JAX package in every op, the facade's replace included."""
    strs = ["xab", "a" * 45, None, "ab a", ""]
    t, j = _pair(strs)
    assert trx.get_program(pattern)._span_bits() is None
    np.testing.assert_array_equal(trx.count_re(t, pattern).numpy(), np.asarray(jrx.count_re(j, pattern)))
    got, want = trx.findall_record(t, pattern), jrx.findall_record(j, pattern)
    _same_column(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.row_offsets.numpy(), np.asarray(want.row_offsets))
    for a, b in zip(trx.findall_columns(t, pattern), jrx.findall_columns(j, pattern), strict=True):
        _same_column(a, b)
    _same_column(trx.replace_re(t, pattern, "z"), jrx.replace_re(j, pattern, "z"))
    assert tnv.nvstrings(t).replace(pattern, "z").to_host() == jcol.to_host_strings(jrx.replace_re(j, pattern, "z"))
    calls = []
    engine = getattr(tdevice.DeviceProgram, why)
    monkeypatch.setattr(tdevice.DeviceProgram, why, lambda self, *a, **k: calls.append(why) or engine(self, *a, **k))
    trx.count_re(t, pattern)
    assert calls


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
