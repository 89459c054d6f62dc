"""Port parity for the delimiter split and the size-changing literal
replace: split_record / split_columns (both `_delim_split` branches), the
split's extents bodies, expand_to / expand_arrays, the shrinking and
growing replace_literal, and the facade methods on them, against
custrings_tpu on the same host strings (and Python str as a second
oracle).  Compared exactly: token counts, valid rows' bytes, offsets and
validity, never buffer capacities (they differ by design)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import custrings_tpu.column as jcolumn
import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import modify as jmod
from custrings_tpu.ops import shift_compact as jshift
from custrings_tpu.ops import split as jsp
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import modify as tmod
from custrings_tpu_torch.ops import shift_compact as tshift
from custrings_tpu_torch.ops import split as tsp

from test_torch_regex_spans import ROWS

STRS = ROWS[:400] + [
    "a,b,,c", ",", "", None, "one", "x  y ", "ééaé", "aaaa", "the,the theme", "é,é é",
    "thethe", "aaa aa a",
]


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


T, J = _pair(STRS)


def _same_column(t, j):
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    assert tcol.to_host_strings(t) == jcol.to_host_strings(j)


def _py_split(s, d, n):
    return None if s is None else s.split(d, n if n > 0 else -1)


DELIMS = [" ", ",", "é", "aa"]


@pytest.mark.parametrize("branch", ["fused", "counts_first"])
@pytest.mark.parametrize("n", [-1, 2])
@pytest.mark.parametrize("delim", DELIMS)
def test_split_record_and_columns_parity(monkeypatch, delim, n, branch):
    if branch == "counts_first":
        monkeypatch.setattr(tsp, "BOUND_SYNC_THRESHOLD", 64)
        monkeypatch.setattr(jcolumn, "BOUND_SYNC_THRESHOLD", 64)
    got, want = tsp.split_record(T, delim, n), jsp.split_record(J, delim, n)
    _same_column(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.row_offsets.numpy(), np.asarray(want.row_offsets))
    np.testing.assert_array_equal(got.row_validity.numpy(), np.asarray(want.row_validity))
    toks = tcol.to_host_strings(got.tokens)
    ro = got.row_offsets.numpy()
    rec = [None if s is None else toks[ro[i] : ro[i + 1]] for i, s in enumerate(STRS)]
    assert rec == [_py_split(s, delim, n) for s in STRS]
    cols, jcols = tsp.split_columns(T, delim, n), jsp.split_columns(J, delim, n)
    assert len(cols) == len(jcols)
    for a, b in zip(cols, jcols):
        _same_column(a, b)


@pytest.mark.parametrize("n", [-1, 2])
@pytest.mark.parametrize("delim", [" ", "aa"])
@pytest.mark.parametrize("body", ["_delim_body", "_delim_extents_stream"])
def test_split_extents_bodies_parity(body, delim, n):
    tail_t, tail_j = tlayout.tail_plane(T), None
    counts = getattr(tsp, body)(T, None, delim, n, tail_t)
    jcounts = getattr(jsp, body)(J, None, delim, n, False, tail_j)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    tcap = 4096
    c, s, e = getattr(tsp, body)(T, tcap, delim, n, tail_t)
    jc, js, je = getattr(jsp, body)(J, tcap, delim, n, False, tail_j)
    total = int(counts.sum())
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy()[:total], np.asarray(js)[:total])
    np.testing.assert_array_equal(e.numpy()[:total], np.asarray(je)[:total])


def test_split_without_a_delimiter_raises():
    with pytest.raises(NotImplementedError, match="whitespace"):
        tsp.split_record(T)
    for fn in (tsp.rsplit_record, tsp.rsplit_columns):
        with pytest.raises(NotImplementedError, match="rsplit"):
            fn(T, " ")
    with pytest.raises(ValueError):
        tsp.split_record(T, "")


@pytest.mark.parametrize("out_cap", [None, 700, 1500])
def test_expand_to_matches_jax(out_cap):
    rng = np.random.default_rng(5)
    n = 1000
    live = rng.random(n) < 0.6
    dist = np.maximum.accumulate(rng.integers(0, 3, n)).astype(np.int32)
    cap = n if out_cap is None else out_cap
    live &= np.arange(n) + dist < min(cap, n)  # the roll network's domain
    vals = rng.integers(0, 256, n).astype(np.uint8)
    if out_cap is None:
        (g,), gp = tshift.expand_arrays(torch.from_numpy(live), torch.from_numpy(dist), [torch.from_numpy(vals)])
        (w,), wp = jshift.expand_arrays(jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(vals)])
    else:
        (g,), gp = tshift.expand_to(torch.from_numpy(live), torch.from_numpy(dist), [torch.from_numpy(vals)], cap)
        (w,), wp = jshift.expand_to(jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(vals)], cap)
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


REPLACES = [
    ("the", "THEE", -1),  # grow by 1: the streaming writer
    ("the", "THEEEE", -1),  # grow by 3
    ("the", "THEE", 1),  # quota: the plan + expansion writer
    ("aa", "bbb", -1),  # bordered pattern
    ("é", "eee", 2),
    ("thethethe", "x" * 12, -1),  # over 8 bytes
    ("the", "T", -1),  # shrink: the plan + compaction writer
    ("the", "", -1),  # delete
    ("aa", "b", 1),
    ("é", "e", -1),
]


@pytest.mark.parametrize("pat,repl,n", REPLACES)
def test_size_changing_replace_parity(pat, repl, n):
    got = tmod.replace_literal(T, pat, repl, n)
    _same_column(got, jmod.replace_literal(J, pat, repl, n))
    want = [None if s is None else s.replace(pat, repl, n if n >= 0 else -1) for s in STRS]
    assert tcol.to_host_strings(got) == want


def test_size_changing_replace_over_sync_threshold(monkeypatch):
    """The shrink over BOUND_SYNC_THRESHOLD syncs its exact size first."""
    monkeypatch.setattr(tmod, "BOUND_SYNC_THRESHOLD", 64)
    monkeypatch.setattr(jcolumn, "BOUND_SYNC_THRESHOLD", 64)
    _same_column(tmod.replace_literal(T, "the", "T"), jmod.replace_literal(J, "the", "T"))


def test_facade_split_and_grow_replace():
    s, js = tnv.to_device(STRS, device="cpu"), jnv.to_device(STRS)
    rec = [None if r is None else r.to_host() for r in s.split_record(" ")]
    assert rec == [None if r is None else r.to_host() for r in js.split_record(" ")]
    assert rec == [_py_split(x, " ", -1) for x in STRS]
    cols = [c.to_host() for c in s.split(",", 2)]
    assert cols == [c.to_host() for c in js.split(",", 2)]
    for repl in ("THEE", "T"):
        r = s.replace("the", repl, regex=False).to_host()
        assert r == js.replace("the", repl, regex=False).to_host()
        assert r == [None if x is None else x.replace("the", repl) for x in STRS]
