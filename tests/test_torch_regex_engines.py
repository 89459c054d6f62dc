"""Port parity for the regex span engines and routers: DeviceProgram's
nfa_spans (min-plus), ordered_spans (ordered closure), run_spans (the
per-row DFS), spans_exec, spans_single and all_spans with capture groups,
custrings_tpu_torch against custrings_tpu on the same char matrices,
compared exactly.  The inputs are tests/test_ordered_engine.py's CORPUS
and AMBIGUOUS patterns at every group id, with search windows, a seeded
random-pattern fuzz, and one program on each route (K5's plain version,
min-plus, ordered, DFS)."""

import numpy as np
import pytest
import torch

from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.regex.ops import get_program as jget
from custrings_tpu_torch.regex import device as tdevice
from custrings_tpu_torch.regex.ops import get_program as tget

from test_ordered_engine import AMBIGUOUS, CORPUS
from test_torch_split_ws import fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

_MATS = {}


def _mats(rows):
    """(JAX chars, nch) at the width test_ordered_engine uses, and the same
    matrices as torch tensors."""
    key = tuple(rows)
    if key not in _MATS:
        col = jcol.from_host_strings(list(rows))
        chars, nch = jlayout.char_matrix(col, max(jlayout.max_row_bytes(col), 2))
        _MATS[key] = (chars, nch, torch.from_numpy(np.array(chars)), torch.from_numpy(np.array(nch)))
    return _MATS[key]


def _same(got, want, what):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("pattern", AMBIGUOUS)
def test_exact_engines_every_group(pattern):
    """ordered_spans, run_spans and spans_exec at every group id, and
    nfa_spans where the program is longest_safe, equal the JAX engines.
    The port's DFS is held to the JAX ordered engine here, which
    tests/test_ordered_engine.py holds to the JAX DFS on these rows; the
    JAX DFS itself is compared in the windows and route tests."""
    chars, nch, tc, tn = _mats(CORPUS)
    jd, td = jget(pattern), tget(pattern)
    n = len(CORPUS)
    z, no = np.zeros(n, np.int32), np.full(n, -1, np.int32)
    for g in range(jd.groups_count + 1):
        want = jd.ordered_spans(chars, nch, z, no, g)
        _same(td.ordered_spans(tc, tn, _t(z), _t(no), g), want, f"ordered g{g}")
        _same(td.spans_exec(tc, tn, _t(z), _t(no), g), want, f"spans_exec g{g}")
        _same(td.run_spans(tc, tn, _t(z), _t(no), g), want, f"run_spans g{g}")
    if jd.prog.longest_safe:
        _same(td.nfa_spans(tc, tn, _t(z)), jd.nfa_spans(chars, nch, z), "nfa_spans")


@pytest.mark.parametrize("pattern", [r"a|b", r"(ab)+", r"(\w+)@(\w+)"])
def test_exact_engines_windows(pattern):
    """Begins past 0 and closed windows [begin, end) (extract's usage),
    and start positions for nfa_spans."""
    chars, nch, tc, tn = _mats(CORPUS)
    jd, td = jget(pattern), tget(pattern)
    n = len(CORPUS)
    rng = np.random.default_rng(5)
    begins = rng.integers(0, 4, n).astype(np.int32)
    ends = np.where(rng.random(n) < 0.5, -1, begins + 2).astype(np.int32)
    for g in range(jd.groups_count + 1):
        _same(td.ordered_spans(tc, tn, _t(begins), _t(ends), g),
              jd.ordered_spans(chars, nch, begins, ends, g), f"ordered g{g}")
        _same(td.run_spans(tc, tn, _t(begins), _t(ends), g),
              jd.run_spans(chars, nch, begins, ends, g), f"run_spans g{g}")
    if jd.prog.longest_safe:
        _same(td.nfa_spans(tc, tn, _t(begins)), jd.nfa_spans(chars, nch, begins), "nfa_spans")


def test_random_pattern_fuzz():
    """Seeded random small patterns over a random a/b corpus: the port's
    ordered and DFS engines equal the JAX ordered engine."""
    rng = np.random.default_rng(17)
    atoms = ["a", "b", "ab", "a|b", "a+", "b*", "a+?", "(a|b)", "a{1,2}", "(ab|a)", "b?"]
    rows = tuple("".join(rng.choice(list("ab "), size=rng.integers(0, 9))) for _ in range(40))
    chars, nch, tc, tn = _mats(rows)
    n = len(rows)
    z, no = np.zeros(n, np.int32), np.full(n, -1, np.int32)
    tried = 0
    for _ in range(10):
        pat = "".join(rng.choice(atoms, size=rng.integers(1, 4)))
        try:
            jd = jget(pat)
        except Exception:
            continue
        td = tget(pat)
        want = jd.ordered_spans(chars, nch, z, no, 0)
        _same(td.ordered_spans(tc, tn, _t(z), _t(no), 0), want, pat)
        _same(td.run_spans(tc, tn, _t(z), _t(no), 0), want, pat)
        tried += 1
    assert tried >= 6


ROUTES = [
    ("K5", r"(\w+)@(\w+)"),
    ("min-plus", "(a)" + "a" * 38),
    ("ordered", r"th(e|at)|(a)(b)"),
    ("DFS", r"#\w{1,70}\b"),
]
ROUTE_ROWS = tuple(CORPUS + ["#tag and #a_b_c, #x", "#" + "w" * 75 + " #é", "th the that thé", "a" * 45, "ab ab"])


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(tdevice.DeviceProgram, name)

        def wrapped(self, *a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(self, *a, **k)

        monkeypatch.setattr(tdevice.DeviceProgram, name, wrapped)
    return calls


@pytest.mark.parametrize("route,pattern", ROUTES)
def test_routes(route, pattern, monkeypatch):
    """spans_single and all_spans with every group equal the JAX package,
    each on its route: K5 (the span passes' plain version), min-plus for a
    longest_safe program of 40 instructions, the ordered engine for an
    uncertified one, the DFS for one of 142 instructions."""
    chars, nch, tc, tn = _mats(ROUTE_ROWS)
    jd, td = jget(pattern), tget(pattern)
    n = len(ROUTE_ROWS)
    assert route != "DFS" or td.I > 128
    assert (td._span_bits() is not None) == (route == "K5")
    calls = _spy(monkeypatch, ["nfa_spans", "ordered_spans", "run_spans"])
    z = np.zeros(n, np.int32)
    m, b, e = td.spans_single(tc, tn, _t(z))
    jm, jb, je = jd.spans_single(chars, nch, z)
    _same((m, b, e), (jm, jb, je), "spans_single")
    engine = {"K5": None, "min-plus": "nfa_spans", "ordered": "ordered_spans", "DFS": "run_spans"}[route]
    assert calls == ([engine] if engine else [])
    valid = np.asarray([s is not None for s in ROUTE_ROWS])
    groups = tuple(range(1, jd.groups_count + 1))
    Rcap = int(chars.shape[1]) + 2
    got = td.all_spans(tc, tn, torch.from_numpy(valid), Rcap, groups=groups)
    want = jd.all_spans(chars, nch, valid, Rcap, True, False, groups)
    _same(got[:3], want[:3], "all_spans")
    for (gb, ge), (jb_, je_) in zip(got[3] if groups else [], want[3] if groups else []):
        _same((gb, ge), (jb_, je_), "group planes")
    counts = td.all_spans(tc, tn, torch.from_numpy(valid), Rcap, counts_only=True)
    _same(counts[0], want[0], "counts only")
    assert counts[1].shape == (n, 1) and bool((counts[1] == -1).all())


def test_all_spans_ascii_hint_and_rcap():
    """The ordered route with the packed-bit predicates on ASCII rows, and
    a round cap below the rows' match counts, equal the JAX package."""
    rows = tuple(r for r in CORPUS if r.isascii())
    chars, nch, tc, tn = _mats(rows)
    jd, td = jget(r"a|ab"), tget(r"a|ab")
    valid = np.ones(len(rows), bool)
    for Rcap in (2, int(chars.shape[1]) + 2):
        _same(td.all_spans(tc, tn, torch.from_numpy(valid), Rcap, True),
              jd.all_spans(chars, nch, valid, Rcap, True, True), f"Rcap {Rcap}")


def test_empty_inputs():
    td = tget(r"th(e|at)")
    tc = torch.zeros((0, 4), dtype=torch.int32)
    tn = torch.zeros(0, dtype=torch.int32)
    for eng in (td.ordered_spans, td.run_spans):
        assert all(x.shape == (0,) for x in eng(tc, tn, tn, tn, 1))
    counts, B, E, planes = td.all_spans(tc, tn, tn.bool(), 3, groups=(1,))
    assert counts.shape == (0,) and B.shape == (0, 3) and planes[0][0].shape == (0, 3)
