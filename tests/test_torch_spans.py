"""Port parity for K5: the plain span passes of custrings_tpu_torch
(`regex/span_bits.py`) against the JAX package.  Exact (matched, begin,
end) against `SpanBits.single`, whose two Pallas kernels run in interpret
mode here, on the bit-engine test corpus plus seeded rows, from position
0 and from seeded random start positions; exact (counts, begins, ends)
of `DeviceProgram.all_spans` (`SpanBits._all_plain`) against the JAX
package's `all_spans` on its own CPU route, null rows included; and the
span kernel's char tables against the per-position planes the Pallas
kernels are fed.

The JAX executor is built directly (`SpanBits(PallasNFA(dp))`), so the
comparison does not depend on the CUSTRINGS_SPAN_BITS routing switch or on
the program cache it sets."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from custrings_tpu import column as jcol
from custrings_tpu.regex import ops as jrx
from custrings_tpu.regex.pallas_nfa import PallasNFA
from custrings_tpu.regex.pallas_spans import SpanBits as JSpanBits
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.regex import ops as trx
from custrings_tpu_torch.regex.device import DeviceProgram
from custrings_tpu_torch.regex.nfa_bits import NFABits
from custrings_tpu_torch.regex.nfa_words import NFAWords
from custrings_tpu_torch.regex.span_bits import SpanBits, span_bits_ok

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

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


def _valid(n, seed=5):
    """Seeded validity with ~1 row in 6 null."""
    return np.random.default_rng(seed).random(n) >= 1 / 6


@pytest.mark.parametrize("counts_only", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_all_spans_equal_jax(pattern, counts_only):
    chars, lens = _mat(TEXTS)
    valid = _valid(len(TEXTS))
    Rcap = chars.shape[1] + 2
    want = jrx.get_program(pattern).all_spans(
        jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(valid), Rcap, True, False, (), counts_only
    )
    got = trx.get_program(pattern).all_spans(
        torch.from_numpy(chars), torch.from_numpy(lens), torch.from_numpy(valid), Rcap,
        counts_only=counts_only,
    )
    for g, w, name in zip(got, want, ("counts", "begins", "ends")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{pattern} {name}")
    assert got[0].dtype == torch.int32 and got[1].shape == (len(TEXTS), 1 if counts_only else Rcap)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("pattern", ["a*", "the|that", r"\bthe\b"])
def test_all_spans_round_cap_below_the_counts(pattern):
    chars, lens = _mat(TEXTS + ["thethethe the that", "aaa a a aa", "the the the x"])
    valid = _valid(chars.shape[0], seed=6)
    want = jrx.get_program(pattern).all_spans(
        jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(valid), 2, True, False, (), False
    )
    got = trx.get_program(pattern).all_spans(
        torch.from_numpy(chars), torch.from_numpy(lens), torch.from_numpy(valid), 2
    )
    assert int(np.asarray(jrx.get_program(pattern).all_spans(
        jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(valid), 8, True, False, (), True
    )[0]).max()) > 2  # the cap cuts some rows
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=pattern)


_TABLE_TEXTS = ["", "the cat_1 sat", "a\nb", "café über naïve", "日本語 テキスト", "😀 the 𝔘x",
                "#ü_1 é@ß", "x😀y\n𝔘\n", "ÀÉÎ ĳ ǅ", "tab\tend"]


@pytest.mark.parametrize("pattern", [r"#\w+", r"(\w+)@(\w+)", r"\bthe\b", r"[^a-z]+x", r"[\U0001F600-\U0001F64F]|[a-c]",
                                     r"^\W\s", r"\d+\D"])
def test_char_tables_equal_k2_planes(pattern):
    """The class words and closure variants from K2's char tables (ASCII
    set, BMP table, explicit ranges above the BMP, ctx_map), expanded per
    position by the plain helpers, equal the planes the Pallas kernels are
    fed (`PallasNFA._pos_tables`), on every row and, on the ASCII rows,
    against its ASCII route."""
    nfa = NFABits(trx.get_program(pattern))
    jnfa = PallasNFA(jrx.get_program(pattern))
    chars_np, lens_np = _mat(_TABLE_TEXTS)
    chars, lens = torch.from_numpy(chars_np), torch.from_numpy(lens_np)
    got = nfa._memb_plain(chars)[..., 0]
    planes = nfa._uid_plane(chars, lens)
    assert (planes is None) == (nfa.U == 1)
    ascii_rows = [i for i, t in enumerate(_TABLE_TEXTS) if t.isascii()]
    for rows, ascii in ((list(range(len(_TABLE_TEXTS))), False), (ascii_rows, True)):
        jm, ju = jnfa._pos_tables(jnp.asarray(chars_np[rows]), jnp.asarray(lens_np[rows]), ascii)
        np.testing.assert_array_equal(got[rows].numpy(), np.asarray(jm)[..., 0].astype(np.int64))
        if planes is None:
            assert (np.asarray(ju) == 0).all()
        else:
            np.testing.assert_array_equal(planes[rows].numpy(), np.asarray(ju))


def test_span_ops_build_no_position_planes():
    """The port has no per-position plane builder (K2, K2b and K5 compute
    predicates and closure variants from the chars); the span ops
    (count_re, findall_record, replace_re) still equal the JAX package's."""
    for cls in (NFABits, NFAWords, DeviceProgram, SpanBits):
        assert not hasattr(cls, "_pos_tables") and not hasattr(cls, "position_uid"), cls
    rows = TEXTS + [None, "ün@ï the", "😀 #tag"]
    col, jc = tcol.from_host_strings(rows, "cpu"), jcol.from_host_strings(rows)
    got = trx.count_re(col, r"\bthe\b").numpy()
    np.testing.assert_array_equal(got, np.asarray(jrx.count_re(jc, r"\bthe\b")))
    assert got.sum() > 0
    found, jfound = trx.findall_record(col, r"#\w+"), jrx.findall_record(jc, r"#\w+")
    np.testing.assert_array_equal(found.row_offsets.numpy(), np.asarray(jfound.row_offsets))
    replaced = tcol.to_host_strings(trx.replace_re(col, r"(\w+)@(\w+)", "E"))
    assert replaced == jcol.to_host_strings(jrx.replace_re(jc, r"(\w+)@(\w+)", "E"))
