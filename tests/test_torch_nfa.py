"""Port parity for K2 and the regex tables: the compiler copy and the
DeviceProgram tables of custrings_tpu_torch equal custrings_tpu's, the
plain bit matcher equals the Pallas bit kernel in interpret mode and
Python `re`, and contains_re equals the JAX op on a long program
(contains_re / match_re on K2's columns are in test_torch_nfa_parity.py)."""

import re

import numpy as np
import pytest
import torch

from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.regex import compiler as jcomp
from custrings_tpu.regex import ops as jrx
from custrings_tpu.regex.pallas_nfa import PallasNFA
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.regex import compiler as tcomp
from custrings_tpu_torch.regex import ops as trx

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

PATTERNS = [r"#\w+", r"^ab", r"a.c", r"[0-9]+x", r"\bthe\b", r"[^a-z ]+"]

ROWS = [
    "ab the #tag",
    "xab",
    "abc a-c aéc",
    "12x 7y",
    "other theme",
    "the",
    "",
    None,
    "#日本 und #ü",
    "tschüß!",
    "lower only",
    "🎉 a🎉c #x",
    "##",
    "then the end",
]


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


@pytest.mark.parametrize("pattern", PATTERNS + [r"(a|b)*c{2,3}", r"\d\s\W", r"x$"])
def test_compiler_copy_tables_equal(pattern):
    a, b = tcomp.compile_pattern(pattern), jcomp.compile_pattern(pattern)
    for name in ("types", "next_ids", "args", "start_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.start_id, a.groups_count, a.longest_safe, a.end_unique) == (
        b.start_id, b.groups_count, b.longest_safe, b.end_unique
    )
    assert [(c.builtins, tuple(c.ranges)) for c in a.classes] == [
        (c.builtins, tuple(c.ranges)) for c in b.classes
    ]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_device_program_tables_equal(pattern):
    t, j = trx.get_program(pattern), jrx.get_program(pattern)
    for name in ("closure_unique", "ctx_map", "class_tab", "cls_lo", "cls_hi",
                 "next_mat", "is_end", "start_vec", "cls_ascii", "alnum_ascii"):
        # uint32 words are held as int32 bit patterns in the port
        np.testing.assert_array_equal(
            getattr(t, name).numpy().astype(np.int64) & 0xFFFFFFFF,
            np.asarray(getattr(j, name)).astype(np.int64) & 0xFFFFFFFF, err_msg=name,
        )


def _oracle(pattern, strs, anchored):
    rx = re.compile(pattern)
    f = rx.match if anchored else rx.search
    return [s is not None and f(s) is not None for s in strs]


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_matches_bits_vs_pallas_and_re(monkeypatch, pattern, anchored):
    monkeypatch.setenv("CUSTRINGS_PALLAS_NFA", "1")
    t, j = _pair(ROWS)
    jchars, jnch = jlayout.char_matrix(j)
    chars, nch = torch.from_numpy(np.array(jchars)), torch.from_numpy(np.array(jnch))
    assert chars.shape[1] == 128  # the smallest width bucket: interpret mode stays quick
    nfa = trx._get_nfa(pattern)
    want_p = np.asarray(PallasNFA(jrx.get_program(pattern))._matches_bits(jchars, jnch, anchored, False))
    got = nfa._matches_bits(chars, nch, anchored).numpy()
    np.testing.assert_array_equal(got, want_p)
    valid = np.asarray(j.validity)
    assert (got & valid).tolist() == _oracle(pattern, ROWS, anchored)


@pytest.mark.parametrize("pattern", [r"#\w+", r"\bthe\b", r"^ab"])
def test_ascii_route_equals_general_route(pattern):
    """On ASCII rows the torch engine's ASCII route (packed-bit
    predicates) equals K2, which reads the full char tables."""
    strs = [s for s in ROWS if s is None or s.isascii()]
    t, _ = _pair(strs)
    from custrings_tpu_torch.ops import layout

    chars, nch = layout.char_matrix(t)
    nfa = trx._get_nfa(pattern)
    for anchored in (False, True):
        np.testing.assert_array_equal(
            trx.get_program(pattern).nfa_matches(chars, nch, anchored, True).numpy(),
            nfa.matches(chars, nch, anchored).numpy(),
        )


def test_long_program_parity():
    """A 41-instruction program (K2b's route since the dense matcher came)
    equals the JAX package."""
    strs = ["abc", "a" * 40, "b" + "a" * 41, None, "", "a" * 39]
    t, j = _pair(strs)
    np.testing.assert_array_equal(trx.contains_re(t, "a" * 40).numpy(), np.asarray(jrx.contains_re(j, "a" * 40)))
    assert trx.contains_re(t, "a" * 40).tolist() == [False, True, True, False, False, False]
