"""Port parity for the literal search: find / rfind (with char windows),
contains, count_literal and the facade's contains(regex=False), against
custrings_tpu on the same host strings (Pallas K3 in interpret mode) and
Python str.  Positions are char indexes; -1 = no match, -2 = null row."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import find as jfind
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import find as tfind

from test_torch_split_ws import STRS, fast_reference_compiles, pair  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

T, J = pair(STRS)
# at a row's start or end, absent, multi-byte, overlapping, NUL, empty
PATS = [" ", "the", "a", "aa", "é", "😀", "日本語", "\x00", "zzz", "#", ""]


def _py_find(s, p, start, end, right):
    if s is None:
        return -2
    if not p:
        return -1
    return s.rfind(p, start, end) if right else s.find(p, start, end)


@pytest.mark.parametrize("pat", PATS)
def test_find_rfind_parity(pat):
    for start, end in ((0, None), (2, None), (1, 6), (3, 2)):
        for right, fn, jfn in ((False, tfind.find, jfind.find), (True, tfind.rfind, jfind.rfind)):
            got = fn(T, pat, start, end)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(J, pat, start, end)))
            assert got.tolist() == [_py_find(s, pat, start, end, right) for s in STRS]


def _overlapping(s, p):
    return sum(s.startswith(p, i) for i in range(len(s)))


@pytest.mark.parametrize("pat", PATS)
def test_contains_and_count_literal_parity(pat):
    got = tfind.contains(T, pat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfind.contains(J, pat)))
    assert got.tolist() == [s is not None and pat != "" and pat in s for s in STRS]
    cnt = tfind.count_literal(T, pat)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jfind.count_literal(J, pat)))
    assert cnt.tolist() == [0 if s is None or not pat else _overlapping(s, pat) for s in STRS]


def test_facade_literal_contains():
    s, js = tnv.to_device(STRS, device="cpu"), jnv.to_device(STRS)
    for pat in ("the", "é", "aa"):
        got = s.contains(pat, regex=False)
        assert got == js.contains(pat, regex=False)
        assert got == [None if x is None else pat in x for x in STRS]
