"""Port parity for replace_re and the span ops' facade methods (count,
findall_record, findall, regex replace): test_torch_regex_spans.py's
seeded rows (nulls, empties, non-ASCII) through custrings_tpu and
custrings_tpu_torch, compared exactly, plus Python `re` as a second
oracle."""

import re

import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.regex import ops as trx

from test_torch_regex_spans import CASES, ROWS, _cols, _same_column

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


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
