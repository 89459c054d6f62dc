"""Port parity for the regex ops built on capture groups and the
multi-pattern pass: extract, extract_record, replace_multi_re and
replace_with_backrefs, custrings_tpu_torch against custrings_tpu on the
same rows, compared exactly, replaying tests/test_regex.py's,
tests/test_backref_device.py's and tests/test_replace_multi.py's cases;
count / findall_record / replace_re on uncertified programs and programs
of over 32 instructions; route.stream_expand_spans against the JAX one;
the four facade methods; and chip_smoke.py's regex phase with its oracles
(held to the JAX package) and its kernel captures, on the CPU."""

import re

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import pallas_route as jroute
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import route as troute
from custrings_tpu_torch.regex import ops as trx

from test_backref_device import CASES as BACKREF_CASES
from test_backref_device import _oracle as backref_oracle
from test_replace_multi import HSTRS, STOP_WORDS, STOPPED
from test_torch_split_ws import CS, fast_reference_compiles, pair, same_column  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

EXTRA = ["a@b c@d", "the that ththat", "", None, "x@y@z w@v", "aé@b thé@x", "1.2.3.4 and 10.20.300.40 9.9.9.9",
         "http://a.b/c https://x é http://", "#a_b #x1 #__ #" + "w" * 75, "Flight:HU7934 Flight:ZZ", "ab abc ab"]
#: one row set for the parity tests and the regex phase, so that the JAX
#: package compiles each program once per file (its compiles are most of
#: this file's time): the edge rows, a few log lines, then tweet rows
ROWS = EXTRA + [CS._cut(x, 64) for x in CS.make_logs(6, seed=2)] + CS.make_corpus(160, seed=3, max_bytes=64)
#: the DFS route's rows (its JAX reference runs a per-row while_loop, ~0.1 s
#: a row on the CPU)
DFS_ROWS = ROWS[:24]
_PAIRS = {}


def _rows_pair():
    if "rows" not in _PAIRS:
        _PAIRS["rows"] = pair(ROWS)
    return _PAIRS["rows"]


def _host(c):
    return tcol.to_host_strings(c)


FLIGHTS = ["ALA-PEK Flight:HU7934", "HKT-PEK Flight:CA822", "FRA-PEK Flight:LA8769", "FRA-PEK Flight:LH7332",
           "", None, "Flight:ZZ"]


def test_extract_flights():
    """tests/test_regex.py::test_extract's rows and expectations, which
    that test holds the JAX package to."""
    t, _ = pair(FLIGHTS)
    got = trx.extract(t, r"Flight:([A-Z]+)(\d+)")
    assert _host(got[0]) == ["HU", "CA", "LA", "LH", None, None, None]
    assert _host(got[1]) == ["7934", "822", "8769", "7332", None, None, None]


@pytest.mark.parametrize("pattern", [r"(\w+)@(\w+)", r"th(e|at)", r"(\d{1,3}\.){3}(\d{1,3})", r"(a)|(b)",
                                     r"(\w*)", r"#\w+", CS.REGEX_WORDS])
def test_extract_parity(pattern):
    """Seeded rows on every route of the first match (K5, ordered,
    min-plus for the regex phase's 40-instruction eight-word pattern), groups that take
    no part, empty groups and a pattern without groups ([])."""
    t, j = _rows_pair()
    got, want = trx.extract(t, pattern), jrx.extract(j, pattern)
    assert len(got) == len(want) == trx.get_program(pattern).groups_count
    for a, b in zip(got, want):
        same_column(a, b)


def test_extract_record_facade():
    """tests/test_regex.py::test_extract_record_api's rows and
    expectations (which that test holds the JAX facade to), and a pattern
    without groups."""
    s = ["ALA-PEK Flight:HU7934", "", None, "Flight:ZZ"]
    got = tnv.to_device(s, device="cpu").extract_record(r"Flight:([A-Z]+)(\d+)")
    assert [r.to_host() for r in got] == [["HU", "7934"], [None, None], [None, None], [None, None]]
    assert tnv.to_device(s, device="cpu").extract_record(r"Flight") == []


def test_replace_multi_cases():
    """tests/test_regex.py's single-pass and tie cases, with the
    expectations that test holds the JAX package to."""
    for strs, pats, reps, want in ((["a1 b2 c3"], [r"a\d", r"b\d"], ["b9", "X"], ["b9 X c3"]),
                                   (["abc"], [r"ab", r"abc"], ["1", "2"], ["1c"])):
        t, _ = pair(strs)
        assert _host(trx.replace_multi_re(t, pats, reps)) == want


@pytest.mark.parametrize("pats,reps,jax", [
    ([r"https?://\S+", r"@\w+", r"#\w+"], ["URL", "USER", "TAG"], True),
    ([r"the", r"th(e|at)", r"a|ab"], ["1", "22", ""], True),
    ([r"\w+@\w+", r"\d+"], "N", False),
    ([r"(\w+)@(\w+)"], ["é😀"], False),
])
def test_replace_multi_parity(pats, reps, jax):
    """Against chip_smoke's per-row oracle and, for the first two, the JAX
    package (the K5, ordered and uncertified programs, ties, an empty
    replacement); one str or a one-entry list serves every pattern."""
    t, j = _rows_pair()
    got = trx.replace_multi_re(t, pats, reps)
    if jax:
        same_column(got, jrx.replace_multi_re(j, pats, reps))
    rl = reps if isinstance(reps, list) else [reps]
    rl = rl * len(pats) if len(rl) == 1 else rl
    assert _host(got) == [CS.replace_multi_py(s, [re.compile(p) for p in pats], rl) for s in ROWS]


def test_replace_multi_errors_and_empty():
    t, _ = pair(["a"])
    with pytest.raises(ValueError):
        trx.replace_multi_re(t, ["a", "b", "c"], ["1", "2"])
    e, _ = pair([])
    assert _host(trx.replace_multi_re(e, ["a"], ["b"])) == []
    n, _ = pair(["xyz", None])
    assert _host(trx.replace_multi_re(n, ["q"], ["b"])) == ["xyz", None]


def test_replace_multi_facade():
    """tests/test_replace_multi.py's cases on the port's facade, with the
    expectations that file holds the JAX facade to: literal passes with a
    scalar and with paired nvstrings replacements, and 130 \\b-anchored
    patterns sharing one replacement."""
    s = tnv.to_device(HSTRS, device="cpu")
    got = s.replace_multi(tnv.to_device(["the ", "a ", "in "], device="cpu"), " ", regex=False)
    assert got.to_host() == [" quick brown fox jumps over  lazy dog", " fat cat lays next to  other accénted cat",
                             " slow moving turtlé cannot catch  bird", "", None]
    pairs = s.replace_multi(tnv.to_device([" dog", " cat", " bird"], device="cpu"),
                            tnv.to_device([" DOG", " CAT", " BIRD"], device="cpu"), regex=False)
    assert pairs.to_host()[2] == "a slow moving turtlé cannot CATch the BIRD"
    assert s.replace_multi(["\\b" + w + "\\b" for w in STOP_WORDS], [""]).to_host() == STOPPED


@pytest.mark.parametrize("pat,tpl,strs", BACKREF_CASES)
def test_backref_cases(pat, tpl, strs):
    """tests/test_backref_device.py's cases against its Python re oracle,
    which that file holds the JAX package to on the same rows."""
    t, _ = pair(strs)
    assert _host(trx.replace_with_backrefs(t, pat, tpl)) == backref_oracle(pat, tpl, strs)


@pytest.mark.parametrize("pat,tpl", [(r"(\w+)@(\w+)", r"\2 at \1"), (r"(\w+)@(\w+)", r"<\0|\2>"),
                                     (r"th(e|at)", r"[\1\1]"), (r"#\w+", r"\0\0"), (r"(a)|(b)", r"\2\1-"),
                                     (r"(\d{1,3}\.){3}(\d{1,3})", r"\2")])
def test_backref_parity(pat, tpl):
    t, j = _rows_pair()
    same_column(trx.replace_with_backrefs(t, pat, tpl), jrx.replace_with_backrefs(j, pat, tpl))


def test_backref_fuzz():
    """tests/test_backref_device.py::test_backref_fuzz's seeded rows (all
    six trials) against its Python re oracle, which that test holds the
    JAX package to on the same rows."""
    rng = np.random.default_rng(42)
    pats = [r"(\w+)@(\w+)", r"(\d+)", r"(a+)(b*)"]
    tpls = [r"\2_\1", r"<\1>", r"\1"]
    for trial in range(6):
        strs = ["".join(rng.choice(list("ab1@ xy"), rng.integers(0, 20))) for _ in range(30)]
        t, _ = pair(strs)
        for pat, tpl in zip(pats, tpls):
            assert _host(trx.replace_with_backrefs(t, pat, tpl)) == backref_oracle(pat, tpl, strs), (trial, pat)


@pytest.mark.parametrize("pattern", [r"https?://\S+", r"th(e|at)", r"(\d{1,3}\.){3}\d{1,3}", r"#\w{1,70}\b",
                                     r"#\w{33,}\b"])
def test_span_ops_on_every_engine(pattern):
    """count, findall_record and replace_re on programs K5 does not take
    (uncertified, or over 32 instructions: min-plus, ordered, DFS; a|ab
    and a{40} are test_torch_regex_spans.py's)."""
    t, j = pair(DFS_ROWS) if trx.get_program(pattern).I > 128 else _rows_pair()
    assert trx.get_program(pattern)._span_bits() is None
    np.testing.assert_array_equal(trx.count_re(t, pattern).numpy(), np.asarray(jrx.count_re(j, pattern)))
    got, want = trx.findall_record(t, pattern), jrx.findall_record(j, pattern)
    same_column(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.row_offsets.numpy(), np.asarray(want.row_offsets))
    same_column(trx.replace_re(t, pattern, "Z"), jrx.replace_re(j, pattern, "Z"))


def test_stream_expand_spans_matches_jax():
    """route.stream_expand_spans against the JAX one: spans of random sizes
    (zero and dead ones among them) packed into a stream, each to its
    output start."""
    rng = np.random.default_rng(9)
    nS = 300
    sizes = rng.integers(0, 7, nS).astype(np.int32)
    ok = rng.random(nS) < 0.8
    live = ok & (sizes > 0)
    gaps = rng.integers(0, 5, nS).astype(np.int32)
    starts = (np.cumsum(gaps + np.where(ok, sizes, 0)) - np.where(ok, sizes, 0)).astype(np.int32)
    total = int(np.where(live, sizes, 0).sum())
    dom = total + 64
    stream = np.zeros(dom, np.uint8)
    stream[:total] = rng.integers(1, 255, total)
    out_cap = int(starts[-1] + sizes[-1] + 8)
    got = troute.stream_expand_spans(torch.from_numpy(stream), torch.tensor(total, dtype=torch.int32),
                                     torch.from_numpy(starts), torch.from_numpy(sizes), torch.from_numpy(ok), out_cap)
    want = jroute.stream_expand_spans(stream, np.int32(total), starts, sizes, ok, out_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_facade_methods_match_jax():
    """The four new facade methods against the JAX facade."""
    s, js = tnv.to_device(ROWS, device="cpu"), jnv.to_device(ROWS)
    got, want = s.extract(r"(\w+)@(\w+)"), js.extract(r"(\w+)@(\w+)")
    assert [c.to_host() for c in got] == [c.to_host() for c in want]
    assert [r.to_host() for r in s.extract_record(r"th(e|at)")] == [r.to_host() for r in js.extract_record(r"th(e|at)")]
    pats, reps = [r"https?://\S+", r"@\w+", r"#\w+"], ["URL", "USER", "TAG"]
    assert (s.replace_multi(tnv.to_device(pats, device="cpu"), tnv.to_device(reps, device="cpu")).to_host()
            == s.replace_multi(pats, reps).to_host())
    assert (s.replace_with_backrefs(r"(\w+)@(\w+)", r"\2 at \1").to_host()
            == js.replace_with_backrefs(r"(\w+)@(\w+)", r"\2 at \1").to_host())


def test_regex_phase_on_cpu(monkeypatch):
    """chip_smoke.py's regex phase at a few hundred rows on the CPU, every
    op against its oracle, and the oracles held to the JAX package on the
    same rows (Python re differs from the reference at \\b, which the
    oracle writes as a change of IS_ALPHANUM)."""
    sizes = {"REGEX_IP_ROWS": len(ROWS), "REGEX_RECORD_ROWS": len(ROWS), "REGEX_WORDS_ROWS": len(ROWS),
             "REGEX_DFS_ROWS": len(DFS_ROWS)}
    for name, n in sizes.items():
        monkeypatch.setattr(CS, name, n)
    strs = logs = ROWS
    res, times, _, launches = CS._run_regex(torch, strs, logs, device="cpu")
    want = CS.regex_oracle(strs, logs, *sizes.values())
    assert CS._check_regex(want, res) == {k: 0 for k in want}
    assert set(times) >= set(want) and not any(launches.values())
    js = jnv.to_device(strs)
    assert [c.to_host() for c in js.extract(CS.REGEX_EMAIL)] == want["extract"]
    assert js.replace_with_backrefs(CS.REGEX_EMAIL, CS.REGEX_WHOLE).to_host() == want["replace_with_backrefs(\\0)"]
    assert js.replace_multi(list(CS.REGEX_MULTI[0]), list(CS.REGEX_MULTI[1])).to_host() == want["replace_multi"]
    assert list(js.count(CS.REGEX_URL)) == want["count"]
    assert js.replace(CS.REGEX_IP, "IP").to_host() == want["replace(ip)"]
    assert [c.to_host() for c in js.extract(CS.REGEX_WORDS)] == want["extract(8 words)"]
    assert list(jnv.to_device(DFS_ROWS).count(CS.REGEX_DFS)) == want["count(dfs)"]
    # the reference's \b is not Python's: '_' is no word char there
    edge = ["#__ x", "#a_b"]
    assert [len(re.findall(CS.REGEX_DFS, x)) for x in edge] == [1, 1]
    assert CS.regex_oracle(edge, [], 1, 1, 1, 2)["count(dfs)"] == [0, 1]
    assert list(jnv.to_device(edge).count(CS.REGEX_DFS)) == [0, 1]


def test_regex_kernel_shapes_on_cpu():
    """chip_smoke._regex_kernel_shapes on the CPU: every capture is found
    and each case's two sides (both plain here) agree."""
    cases = CS._regex_kernel_shapes(torch, ROWS, device="cpu")
    assert [c[0] for c in cases] == ["route_expand", "route_compact", "span_all"]
    for _, _, _, shapes in cases:
        for label, kern, plain, extra in shapes:
            a, b = kern(), plain()
            a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), label
            assert extra["bound"][0] > 0
