"""Port parity for K2b: its plain walk (`nfa_words`) against the Pallas
dense kernel `_matches_f32` in interpret mode, the JAX vector engine and
Python `re`; its char tables against the Pallas planes; one engine call
per contains_re / match_re on the K2 and K2b routes; the facade; and
chip_smoke.py's matcher sets on their engines.  The vector and chunked
engines and the routes over bucketed columns are in
`test_torch_nfa_{vector,chunked,routes}.py`, which share this file's
rows and helpers."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.regex import ops as jrx
from custrings_tpu.regex.pallas_nfa import PallasNFA
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.regex import nfa_bits, nfa_words
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


CS = _chip_smoke()

#: tests/test_regex.py's >32-inst programs (multi-word planes, NCCLASS
#: lanes past word 0, U > 1), and the log filters of chip_smoke.py
K2B_PATTERNS = [
    r"\w{10,40}", r"(\d+[a-c]{3,9}){2,4}", r"[a-h]{30,70}", r"[^o]{3,40}\b\w+", CS.ERR, CS.ISO,
]
#: Python `re` lets [^o] cross a newline where the engine (as the reference)
#: does not: that pattern is held to the JAX engines only
RE_AGREES = {p: p != r"[^o]{3,40}\b\w+" for p in K2B_PATTERNS}

ROWS = [
    "Hello world", "hello World 123", "abc", "", None, "abcdefghabcdefghabcdefghabcdefghxx",
    "2024-01-02T10:11:12Z web-01 ERROR connection timeout after 3 retries",
    "2024-01-02T10:11:12.123+02:00 db-1 WARN a fatal exception",
    "1abc2bbbb33cccc 44aaa", "x" * 60, "tschüß naïve 42abc warning", "a\nb\nc errors",
    "🎉 critical: 日本語 timeout.", "0123456789abcdefghijklmnop",
] + [s and CS._cut(s, 120) for s in CS.make_logs(24, seed=5)]  # width 128: quick loops


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


def _mats(j):
    jchars, jnch = jlayout.char_matrix(j)
    return jchars, jnch, torch.from_numpy(np.array(jchars)), torch.from_numpy(np.array(jnch))


def _oracle(pattern, strs, anchored):
    f = re.compile(pattern).match if anchored else re.compile(pattern).search
    return [s is not None and f(s) is not None for s in strs]


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("pattern", K2B_PATTERNS)
def test_matches_words_vs_pallas_f32_and_re(pattern, anchored):
    t, j = _pair(ROWS)
    jchars, jnch, chars, nch = _mats(j)
    dp, jdp = trx.get_program(pattern), jrx.get_program(pattern)
    assert dp.I > nfa_bits.MAX_BITS_INSTS and nfa_words.pallas_supported(dp)
    nfa = trx._get_nfa(pattern)
    assert isinstance(nfa, nfa_words.NFAWords)
    got = nfa._matches_words(chars, nch, anchored).numpy()
    want_f32 = np.asarray(PallasNFA(jdp)._matches_f32(jchars, jnch, anchored, False))
    np.testing.assert_array_equal(got, want_f32)
    np.testing.assert_array_equal(got, np.asarray(jdp.nfa_matches(jchars, jnch, anchored)))
    if RE_AGREES[pattern]:
        valid = np.asarray(j.validity)
        assert (got & valid).tolist() == _oracle(pattern, ROWS, anchored)


@pytest.mark.parametrize("ascii", [False, True])
@pytest.mark.parametrize("pattern", [r"[^o]{3,40}\b\w+", CS.ERR, CS.ISO])
def test_pos_tables_equal_pallas(pattern, ascii):
    """K2b's per-char tables, expanded per position by the plain helpers
    (`_memb_plain`, `_uid_plane`), equal the planes the Pallas kernel is
    fed (`PallasNFA._pos_tables`: W32 membership words, NCCLASS lanes past
    word 0, and the closure variants), on ASCII rows against its ASCII
    route and on every row against its 64K-table route."""
    strs = [s for s in ROWS if s is None or s.isascii()] if ascii else ROWS
    t, j = _pair(strs)
    jchars, jnch, chars, nch = _mats(j)
    nfa = trx._get_nfa(pattern)
    assert isinstance(nfa, nfa_words.NFAWords) and nfa.W32 > 1
    jm, ju = PallasNFA(jrx.get_program(pattern))._pos_tables(jchars, jnch, ascii)
    np.testing.assert_array_equal(nfa._memb_plain(chars).numpy(), np.asarray(jm).astype(np.int64))
    uid = nfa._uid_plane(chars, nch)
    if uid is None:
        assert (np.asarray(ju) == 0).all()
    else:
        np.testing.assert_array_equal(uid.numpy(), np.asarray(ju))


#: rows with non-ASCII (BMP and astral), null and empty rows for the
#: kernel routes: few enough in the first column that the torch engines
#: would take their ASCII pass there, most rows in the second
_ODD = ["naïve timeout", "🎉 timeout🎉", "fatal: ошибка", "#日本 #x_1", None, "", "𝔘 error 𝔘", "\n#a"]
KERNEL_COLUMNS = {
    "ascii_heavy": [s and CS._cut(s, 120) for s in CS.make_logs(56, seed=9)] + _ODD,
    "mostly_nonascii": _ODD * 3 + ["plain error #tag"],
}


@pytest.mark.parametrize("name", list(KERNEL_COLUMNS))
@pytest.mark.parametrize("pattern", [r"#\w+", r"\btimeout\b", CS.ERR, CS.ISO])
def test_kernel_routes_make_one_engine_call(monkeypatch, name, pattern):
    """contains_re / match_re on the K2 and K2b routes call the engine once
    over all rows of an unbucketed column, whatever its non-ASCII share
    (the kernels read the full char tables), and equal the JAX package."""
    strs = KERNEL_COLUMNS[name]
    t, j = _pair(strs)
    assert jlayout.length_buckets(j) is None
    nfa = trx._get_nfa(pattern)
    cls, meth = (nfa_bits.NFABits, "_matches_bits") if nfa.I <= 32 else (nfa_words.NFAWords, "_matches_words")
    assert isinstance(nfa, cls)
    calls = []
    real = getattr(cls, meth)

    def counted(self, chars, *a, **k):
        calls.append(int(chars.shape[0]))
        return real(self, chars, *a, **k)

    monkeypatch.setattr(cls, meth, counted)
    for fn_t, fn_j in ((trx.contains_re, jrx.contains_re), (trx.match_re, jrx.match_re)):
        calls.clear()
        np.testing.assert_array_equal(fn_t(t, pattern).numpy(), np.asarray(fn_j(j, pattern)))
        assert calls == [len(strs)]


@pytest.mark.parametrize("pattern", [CS.ERR, CS.MONTH])
def test_facade_contains_and_match(pattern):
    strs = [s and CS._cut(s, 120) for s in CS.make_logs(40, seed=8)] + ["on january 12 a fatal error", None, ""]
    got = tnv.to_device(strs, device="cpu")
    want = jnv.to_device(strs)
    assert got.contains(pattern) == want.contains(pattern)
    assert got.match(pattern) == want.match(pattern)
    assert got.contains(pattern) == [None if s is None else re.search(pattern, s) is not None for s in strs]


@pytest.fixture(scope="module")
def smoke_sets():
    """chip_smoke's matcher sets at a small size: its log and long-row
    generators, its filters and its split of the sets."""
    return CS._matcher_sets(CS.make_logs(64, seed=2), CS.make_long_logs(3, seed=3))


@pytest.mark.parametrize("set_name", ["logs", "logs_big", "long"])
def test_chip_smoke_matcher_routes(smoke_sets, set_name):
    """Each matcher set of chip_smoke.py takes the engine it is there to
    drive (MATCHER_ROUTES, as _RouteLog records it), K2b in one call over
    all rows, and agrees with Python `re` on every row."""
    [(_, strs, filters)] = [s for s in smoke_sets if s[0] == set_name]
    t = tcol.from_host_strings(strs, "cpu")
    for _, pattern in filters:
        for anchored, fn in ((False, trx.contains_re), (True, trx.match_re)):
            with CS._RouteLog() as log:
                got = fn(t, pattern)
            assert log.engines == CS.MATCHER_ROUTES[set_name]
            if set_name == "logs":
                assert [(c["rows"], c["launches"]) for c in log.calls] == [(len(strs), 0)]  # plain walk
            assert got.tolist() == _oracle(pattern, strs, anchored)
