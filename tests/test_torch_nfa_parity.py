"""Port parity for contains_re / match_re on K2's programs against the JAX
ops, on an ASCII-heavy, a mostly non-ASCII and a length-bucketed column
built from test_torch_nfa.py's rows (non-ASCII, astral, null and empty
rows)."""

import numpy as np
import pytest
import torch

from custrings_tpu.ops import layout as jlayout
from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch.regex import ops as trx

from test_torch_nfa import ROWS, _pair

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


def _columns():
    rng = np.random.default_rng(2)
    ascii_heavy = ["row %d the #t%d" % (i, i) for i in range(60)] + ROWS
    mostly_na = ROWS * 3
    buckets = ["s %d" % i for i in range(300)] + ["#ü" + "the " * int(k) for k in rng.integers(120, 150, 30)]
    return {"ascii_heavy": ascii_heavy, "mostly_nonascii": mostly_na, "bucketed": buckets}


@pytest.mark.parametrize("name", ["ascii_heavy", "mostly_nonascii", "bucketed"])
@pytest.mark.parametrize("pattern", [r"#\w+", r"\bthe\b", r"^ab", r"[^a-z ]+"])
def test_contains_and_match_parity(name, pattern):
    strs = _columns()[name]
    t, j = _pair(strs)
    if name == "bucketed":
        assert jlayout.length_buckets(j) is not None
    np.testing.assert_array_equal(
        trx.contains_re(t, pattern).numpy(), np.asarray(jrx.contains_re(j, pattern))
    )
    np.testing.assert_array_equal(
        trx.match_re(t, pattern).numpy(), np.asarray(jrx.match_re(j, pattern))
    )
