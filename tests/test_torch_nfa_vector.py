"""Port parity for the vector engine over programs of more than 256
instructions (`DeviceProgram.nfa_matches`) against the JAX engine and
Python `re`, on test_torch_nfa_words.py's rows (non-ASCII, astral, null
and empty rows)."""

import numpy as np
import pytest
import torch

from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch.regex import nfa_words
from custrings_tpu_torch.regex import ops as trx

from test_torch_nfa_words import CS, ROWS, _mats, _oracle, _pair

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)


#: rows past 256 chars only for the program that needs them (a{300}), so
#: BIG runs at the rows' own width of 128
LONG = {CS.BIG: [], "a{300}": ["a" * 300, "a" * 299 + "b"]}


@pytest.mark.parametrize("pattern", [CS.BIG, "a{300}"])
def test_vector_engine_over_256_insts(pattern):
    strs = ROWS + LONG[pattern] + ["on monday, january 3: connection refused"]
    t, j = _pair(strs)
    jchars, jnch, chars, nch = _mats(j)
    dp, jdp = trx.get_program(pattern), jrx.get_program(pattern)
    assert dp.I > nfa_words.MAX_INSTS and trx._get_nfa(pattern) is None
    for anchored in (False, True):
        got = dp.nfa_matches(chars, nch, anchored).numpy()
        np.testing.assert_array_equal(got, np.asarray(jdp.nfa_matches(jchars, jnch, anchored)))
        assert (got & np.asarray(j.validity)).tolist() == _oracle(pattern, strs, anchored)
