"""Port parity for K5: the plain span passes of custrings_tpu_torch
(`regex/span_bits.py`) against the JAX package's `SpanBits.single`, whose
two Pallas kernels run in interpret mode here.  Exact (matched, begin,
end) on the bit-engine test corpus plus seeded rows, from position 0 and
from seeded random start positions.

The JAX executor is built directly (`SpanBits(PallasNFA(dp))`), so the
comparison does not depend on the CUSTRINGS_SPAN_BITS routing switch or on
the program cache it sets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from custrings_tpu.regex import ops as jrx
from custrings_tpu.regex.pallas_nfa import PallasNFA
from custrings_tpu.regex.pallas_spans import SpanBits as JSpanBits
from custrings_tpu_torch.regex import ops as trx
from custrings_tpu_torch.regex.nfa_bits import NFABits
from custrings_tpu_torch.regex.span_bits import SpanBits, span_bits_ok

CORPUS = [
    "", "a", "the", "that", "ththat", "thethat", "a@b", "a@b@c",
    "user@host tail", " x@y ", "aaa", "no match here!", "@", "a@",
    "@b", "the end", "end the", "that that", "a b@c the",
    "ém@oji café",
]

_TOKENS = ["the", "that", "a", "aa", "end", "x@y", "#tag", "#", "@", " ", " ",
           "b", "théé", "日本", "\n", "_1", "then", "!"]


def _rows(n=40, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = "".join(rng.choice(_TOKENS, rng.integers(0, 12)).tolist())
        out.append(s[:40])
    return out


def _mat(texts):
    L = max(max((len(t) for t in texts), default=1), 1)
    chars = np.zeros((len(texts), L), np.int32)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        lens[i] = len(t)
        chars[i, : len(t)] = [ord(c) for c in t]
    return chars, lens


TEXTS = CORPUS + _rows()
PATTERNS = [r"#\w+", "the|that", r"(\w+)@(\w+)", "a*", r"\bthe\b", "^the", "end$"]


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_span_passes_equal_pallas_interpret(pattern, start):
    chars, lens = _mat(TEXTS)
    rng = np.random.default_rng(3)
    sp = np.zeros(len(TEXTS), np.int32) if start == "zero" else rng.integers(0, lens + 1).astype(np.int32)
    jdp = jrx.get_program(pattern)
    want = JSpanBits(PallasNFA(jdp)).single(jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(sp))
    sb = SpanBits(NFABits(trx.get_program(pattern)))
    got = sb.single(torch.from_numpy(chars), torch.from_numpy(lens), torch.from_numpy(sp))
    for g, w, name in zip(got, want, ("matched", "begin", "end")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{pattern} {name}")
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32


@pytest.mark.parametrize("pattern", [r"#\w+", r"\bthe\b"])
def test_ascii_tables_give_the_same_spans(pattern):
    texts = [t for t in TEXTS if t.isascii()]
    chars, lens = (torch.from_numpy(a) for a in _mat(texts))
    sb = SpanBits(NFABits(trx.get_program(pattern)))
    a = sb.single(chars, lens, 0, ascii=True)
    b = sb.single(chars, lens, 0, ascii=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_uncertified_program_is_refused():
    dp = trx.get_program("a|ab")  # prefix-ambiguous: priority and longest differ
    assert not span_bits_ok(dp.prog)
    with pytest.raises(ValueError, match="longest_safe or end_unique"):
        SpanBits(NFABits(dp))
