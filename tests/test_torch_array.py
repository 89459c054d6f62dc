"""Port parity for the row moves: append, scatter, scalar_scatter,
remove_strings, order and sort at every stype (1 = byte length, 2 =
name, 3 = both), direction and null placement, and the facade's gather,
sublist and add_strings, against custrings_tpu on the same host strings
(Pallas kernels in interpret mode) and a stable Python sort.

The port sorts by stable LSD passes at every size, so ties keep row
order.  The JAX `order` below 2^17 rows sorts with the row ids outside
its keys, so ties may come out in another order there (ROADMAP Queue 3):
its indices are held to the port's where they are a stable order, and
its sorted strings always."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import array as jarray
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import array as tarray

from test_torch_attrs_find import COLS
from test_torch_split_ws import CS, fast_reference_compiles, pair, same_column  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

STRS, T, J = COLS["mixed"]
# ties: repeated rows, rows equal up to embedded NULs and lengths
SORT_STRS = STRS + ["a", "a\x00", "a", "", None, "ab", "a\x00b", "Hello"] * 2
ST, SJ = pair(SORT_STRS)


def _stable(perm, strs, stype):
    """perm lists tied rows (same null flag, length and bytes as stype
    keys them) in increasing row order."""
    def key(i):
        s = strs[i]
        if s is None:
            return (None,)
        b = s.encode()
        return (len(b) if stype & 1 else 0, b if stype & 2 else b"")

    return all(key(a) != key(b) or a < b for a, b in zip(perm, perm[1:]))


@pytest.mark.parametrize("stype", [1, 2, 3])
@pytest.mark.parametrize("asc,nullfirst", [(True, True), (False, False), (True, False), (False, True)])
def test_order_sort_parity(stype, asc, nullfirst):
    got = tarray.order(ST, stype, asc, nullfirst).tolist()
    assert got == CS.order_py(SORT_STRS, stype, asc, nullfirst)
    want = np.asarray(jarray.order(SJ, stype, asc, nullfirst)).tolist()
    assert [SORT_STRS[i] for i in want] == [SORT_STRS[i] for i in got]
    if _stable(want, SORT_STRS, stype):
        assert want == got
    same_column(tarray.sort(ST, stype, asc, nullfirst), jarray.sort(SJ, stype, asc, nullfirst))


def test_sort_reference_expectations():
    corpus = ["abc", "defghi", None, "jkl", "mno", "pqr", "stu", "dog and cat", "accénted", ""]
    Tc, _ = pair(corpus)
    assert tcol.to_host_strings(tarray.sort(Tc, 1)) == [
        None, "", "abc", "jkl", "mno", "pqr", "stu", "defghi", "accénted", "dog and cat"]
    assert tcol.to_host_strings(tarray.sort(Tc, 2)) == [
        None, "", "abc", "accénted", "defghi", "dog and cat", "jkl", "mno", "pqr", "stu"]
    assert tarray.order(Tc, 1).tolist() == [2, 9, 0, 3, 4, 5, 6, 1, 8, 7]
    assert tarray.order(Tc, 2).tolist() == [2, 9, 0, 8, 1, 7, 3, 4, 5, 6]
    assert tarray.order(Tc, 3).tolist() == [2, 9, 0, 3, 4, 5, 6, 1, 8, 7]
    Tp, _ = pair(["pear", "apple", None, "fig", "apple"])
    assert tcol.to_host_strings(tarray.sort(Tp, 2, False, False)) == ["pear", "fig", "apple", "apple", None]
    assert tarray.order(pair([])[0]).tolist() == []


def test_append_parity():
    parts = [STRS[:50], [None, ""], [], STRS[50:]]
    got = tarray.append([pair(p)[0] for p in parts])
    same_column(got, jarray.append([pair(p)[1] for p in parts]))
    assert tcol.to_host_strings(got) == [s for p in parts for s in p]


def test_scatter_parity():
    other = ["X", None, "é😀", "", "Z"]
    idx = [3, -1, 0, 17, -40]
    To, Jo = pair(other)
    got = tarray.scatter(T, To, idx)
    same_column(got, jarray.scatter(J, Jo, np.asarray(idx)))
    want = list(STRS)
    for k, i in enumerate(idx):
        want[i] = other[k]
    assert tcol.to_host_strings(got) == want
    Tx, _ = pair(["a", "b", "c", "d"])
    assert tcol.to_host_strings(tarray.scatter(Tx, pair(["X", "Y"])[0], [1, 3])) == ["a", "X", "c", "Y"]


def test_scalar_scatter_and_remove_parity():
    To, Jo = pair(["ß!"])
    idx = [0, 5, 7, -2]
    got = tarray.scalar_scatter(T, To, idx)
    same_column(got, jarray.scalar_scatter(J, Jo, np.asarray(idx)))
    want = list(STRS)
    for i in idx:
        want[i] = "ß!"
    assert tcol.to_host_strings(got) == want
    drop = [1, 2, 9, -1]
    got = tarray.remove_strings(T, drop)
    same_column(got, jarray.remove_strings(J, drop))
    gone = {i % len(STRS) for i in drop}
    assert tcol.to_host_strings(got) == [s for i, s in enumerate(STRS) if i not in gone]


def test_facade_array_ops():
    s, js = tnv.to_device(SORT_STRS, device="cpu"), jnv.to_device(SORT_STRS)
    for stype in (1, 2, 3):
        assert s.sort(stype).to_host() == js.sort(stype).to_host()
        assert s.sort(stype, False, False).to_host() == js.sort(stype, False, False).to_host()
    assert s.order(2) == CS.order_py(SORT_STRS, 2, True, True)
    for idx in ([0, 3, 2, 0], [-1, 0], np.array([5, 1])):
        assert s.gather(idx).to_host() == js.gather(idx).to_host()
        assert s.sublist(idx).to_host() == js.sublist(idx).to_host()
    mask = [i % 3 == 0 for i in range(len(SORT_STRS))]
    assert s.gather(mask).to_host() == js.gather(mask).to_host()
    assert s.scatter(["X", None], [1, -1]).to_host() == js.scatter(["X", None], [1, -1]).to_host()
    assert s.scalar_scatter("Z", [0, 3]).to_host() == js.scalar_scatter("Z", [0, 3]).to_host()
    assert s.remove_strings([0, 2]).to_host() == js.remove_strings([0, 2]).to_host()
    extra, jextra = tnv.to_device(["q", None], device="cpu"), jnv.to_device(["q", None])
    assert s.add_strings(extra).to_host() == js.add_strings(jextra).to_host()
    assert s.add_strings([extra, s]).to_host() == js.add_strings([jextra, js]).to_host()
