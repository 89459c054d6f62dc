"""Port parity for the chunked engine (`nfa_matches_chunked`) against the
JAX one and the vector engine, and contains_re / match_re on the chunked
route with the threshold lowered in both packages."""

import numpy as np
import pytest
import torch

from custrings_tpu.regex import ops as jrx
from custrings_tpu_torch.regex import ops as trx

from test_torch_nfa_routes import _route_parity
from test_torch_nfa_words import CS, ROWS, _mats, _pair

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

#: long rows kept under 128 chars, so the padded width stays the rows' 128
CHUNK_CORPUS = ROWS + ["x" * 50 + "Hello world !" + "y" * 40, "world" * 20, "ab\n" * 35 + "x"]


@pytest.mark.parametrize("pattern", [r"\w+", r"[Hh]ello [Ww]orld", r"\bworld\b", r"^x", r"o$", CS.ERR])
def test_chunked_vs_jax(pattern):
    """Chunk sizes that do and do not divide the padded width."""
    t, j = _pair(CHUNK_CORPUS)
    jchars, jnch, chars, nch = _mats(j)
    assert chars.shape[1] == 128
    dp, jdp = trx.get_program(pattern), jrx.get_program(pattern)
    for anchored in (False, True):
        want = dp.nfa_matches(chars, nch, anchored).numpy()
        for G in (16, 64, 100):
            got = dp.nfa_matches_chunked(chars, nch, anchored, G).numpy()
            np.testing.assert_array_equal(got, np.asarray(jdp.nfa_matches_chunked(jchars, jnch, anchored, G)))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ascii_heavy", "mostly_nonascii", "bucketed"])
@pytest.mark.parametrize("pattern", [r"\btimeout\b", CS.ERR])
def test_contains_and_match_chunked_route(monkeypatch, name, pattern):
    """The chunked engine, with the threshold lowered on both sides so that
    every width takes it (and, in the bucketed column, one width only)."""
    thresh = "256" if name == "bucketed" else "128"
    monkeypatch.setenv("CUSTRINGS_CHUNK_THRESHOLD", thresh)
    assert trx._chunk_threshold() == int(thresh)
    _route_parity(name, pattern)
