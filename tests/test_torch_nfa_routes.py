"""Port parity for contains_re / match_re through the K2, K2b and vector
routes below the chunk threshold, on an ASCII-heavy, a mostly non-ASCII
and a length-bucketed column, against `custrings_tpu.regex.ops`."""

import numpy as np
import pytest
import torch

from custrings_tpu.ops import layout as jlayout
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch.regex import ops as trx

from test_torch_nfa_words import CS, ROWS, _pair

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


def _columns():
    rng = np.random.default_rng(4)
    logs = [s and CS._cut(s, 120) for s in CS.make_logs(60, seed=6)]
    ascii_heavy = [s for s in logs if s is None or s.isascii()] + ROWS[:14]
    mostly_na = [s for s in ROWS if s is None or not s.isascii()] * 4 + ["plain error"]
    # two length buckets, of widths 128 and 320: the chunked route's test
    # lowers the threshold to 256, between them
    buckets = ["s %d" % i for i in range(300)] + [
        "#ü " + "the timeout " * int(k) + ("fatal" if k % 2 else "") for k in rng.integers(22, 27, 30)
    ]
    return {"ascii_heavy": ascii_heavy, "mostly_nonascii": mostly_na, "bucketed": buckets}


def _route_parity(name, pattern):
    strs = _columns()[name]
    t, j = _pair(strs)
    if name == "bucketed":
        assert [b.width for b in jlayout.length_buckets(j)] == [128, 320]
    for fn_t, fn_j in ((trx.contains_re, jrx.contains_re), (trx.match_re, jrx.match_re)):
        np.testing.assert_array_equal(fn_t(t, pattern).numpy(), np.asarray(fn_j(j, pattern)))


@pytest.mark.parametrize("name", ["ascii_heavy", "mostly_nonascii", "bucketed"])
@pytest.mark.parametrize("pattern", [r"\btimeout\b", CS.ERR, "a{300}"])
def test_contains_and_match_routes(name, pattern):
    """K2, K2b and the vector engine, below the chunk threshold."""
    _route_parity(name, pattern)
