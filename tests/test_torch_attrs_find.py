"""Port parity for the row attributes and the rest of the literal search:
len, byte_count, the nine is* predicates, find_from, startswith, endswith,
compare, match_strings, find_multiple and the facade's search methods,
against custrings_tpu on the same host strings (Pallas K3 in interpret
mode) and against Python where its semantics are the JAX package's.

The predicates follow the JAX package, not `str`: the flag table is BMP
only (a code point above it has no flags), and islower/isupper hold for
a non-empty row without a letter of the other case ("123")."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import attrs as jattrs
from custrings_tpu.ops import find as jfind
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import attrs as tattrs
from custrings_tpu_torch.ops import find as tfind

from test_torch_split_ws import fast_reference_compiles, pair  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

#: words of every case class, multi-char casings, sigmas, titlecase (ǅ),
#: numerics (Ⅻ, ½, ٣), 4-byte UTF-8, NUL, signs
TOKENS = ["Hello", "WORLD", "the", "a", "ß", "straße", "ŉo", "ΐ", "ΣΑΣ", "ς", "σ", "ÀÉÎ", "õü",
          "İ", "ẞ", "😀", "x😀y", "日本語", "\x00", "a\x00b", "123", "+12", "-", "-7", "RT", "!",
          "m", "mm", "é", "naïve", "ǅ", "Ⅻ", "½", "٣", " ", "aaa", "Tʼ"]
SEPS = [" ", " ", "  ", "\t", "\n", " \n\t"]
SPECIALS = [None, "", " ", "   ", "\t\n", "a", "A", "1", "½", "٣٣", "Ⅻ", "😀", "ǅ", "\x00",
            "m", "ma", "l", "n", "+", "-12", "RT!", "RT @x !"]


def mixed_rows(n: int = 240, seed: int = 0):
    """Seeded rows of 1-5 tokens joined by whitespace, a quarter with
    leading or trailing " \\n\\t" runs, and nulls, empty and
    whitespace-only rows, then SPECIALS."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.random()
        if k < 0.04:
            out.append(None)
        elif k < 0.07:
            out.append("")
        elif k < 0.10:
            out.append("".join(SEPS[i] for i in rng.integers(0, len(SEPS), 2).tolist()))
        else:
            toks = [TOKENS[i] for i in rng.integers(0, len(TOKENS), rng.integers(1, 6)).tolist()]
            row = toks[0] + "".join(SEPS[rng.integers(len(SEPS))] + t for t in toks[1:])
            if rng.random() < 0.25:
                row = SEPS[rng.integers(len(SEPS))] + row + SEPS[rng.integers(len(SEPS))]
            out.append(row)
    return out + SPECIALS


STRS = mixed_rows()
ASCII = [s for s in STRS if s is None or s.isascii()]
COLS = {"mixed": (STRS, *pair(STRS)), "ascii": (ASCII, *pair(ASCII))}
PREDICATES = ["isalnum", "isalpha", "isdigit", "isspace", "isdecimal", "isnumeric",
              "islower", "isupper", "is_empty"]


@pytest.mark.parametrize("cols", sorted(COLS))
@pytest.mark.parametrize("op", PREDICATES + ["len_chars", "byte_count"])
def test_attrs_parity(op, cols):
    _, T, J = COLS[cols]
    np.testing.assert_array_equal(getattr(tattrs, op)(T).numpy(), np.asarray(getattr(jattrs, op)(J)))


def test_predicate_semantics():
    strs = ["123", "abc", "ABC", "aBc", "", None, "½", "٣", "Ⅻ", "😀", "ǅ", " \t", "ß", "ΣΑΣ"]
    T, _ = pair(strs)
    # no letter of the other case: digits, numerals (Ⅻ is not alpha),
    # whitespace and 4-byte chars pass both; titlecase ǅ passes neither
    assert tattrs.islower(T).tolist() == [True, True, False, False, False, False, True, True, True, True,
                                          False, True, True, False]
    assert tattrs.isupper(T).tolist() == [True, False, True, False, False, False, True, True, True, True,
                                          False, True, False, True]
    # a code point past the 16-bit table has no flags
    assert tattrs.isalnum(T).tolist() == [s is not None and s != "" and s.isalnum() and s != "😀"
                                          for s in strs]
    assert tattrs.is_empty(T).tolist() == [s is None or s == "" for s in strs]


@pytest.mark.parametrize("pat", ["the", "a", "é", "😀", "", "\x00"])
def test_find_from_parity(pat):
    strs, T, J = COLS["mixed"]
    rng = np.random.default_rng(3)
    starts = rng.integers(-2, 12, len(strs)).astype(np.int32)
    ends = rng.integers(-3, 20, len(strs)).astype(np.int32)
    for st, en in ((None, None), (starts, None), (starts, ends)):
        got = tfind.find_from(T, pat, st, en)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfind.find_from(J, pat, st, en)))


@pytest.mark.parametrize("pat", ["", "R", "RT", "!", "😀", "ß", "a\x00", "Hello WORLD"])
def test_startswith_endswith_parity(pat):
    strs, T, J = COLS["mixed"]
    for t_fn, j_fn, py in ((tfind.startswith, jfind.startswith, str.startswith),
                           (tfind.endswith, jfind.endswith, str.endswith)):
        got = t_fn(T, pat)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_fn(J, pat)))
        assert got.tolist() == [s is not None and py(s, pat) for s in strs]


def _compare_py(s, pat):
    if s is None:
        return -1
    a, b = s.encode(), pat.encode()
    for t in range(len(b)):
        if t >= len(a):
            return -1
        if a[t] != b[t]:
            return a[t] - b[t]
    return int(len(a) > len(b))


@pytest.mark.parametrize("pat", ["", "m", "Hello", "aaa", "é", "😀", "\x00", "RT !"])
def test_compare_parity(pat):
    for strs, T, J in COLS.values():
        got = tfind.compare(T, pat)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfind.compare(J, pat)))
        assert got.tolist() == [_compare_py(s, pat) for s in strs]


def test_compare_reference_case():
    T, _ = pair(["aaa", "aab", "aa", "aaaa", None, "b"])
    assert np.sign(tfind.compare(T, "aaa").numpy()).tolist() == [0, 1, -1, 1, -1, 1]


def test_match_strings_parity():
    strs, T, J = COLS["mixed"]
    others = [strs[::-1], strs, [s if i % 3 else (s or "") + "x" for i, s in enumerate(strs)],
              [None if i % 4 == 0 else s for i, s in enumerate(strs)]]
    for other in others:
        To, Jo = pair(other)
        got = tfind.match_strings(T, To)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfind.match_strings(J, Jo)))
        assert got.tolist() == [a == b for a, b in zip(strs, other)]
    Ta, _ = pair(["abc", "def", None, "gh"])
    Tb, _ = pair(["abc", "xef", None, "ghi"])
    assert tfind.match_strings(Ta, Tb).tolist() == [True, False, True, False]


def test_find_multiple_parity():
    strs, T, J = COLS["mixed"]
    targets = ["the", None, "é", "😀", "a", "\x00"]
    Tt, Jt = pair(targets)
    got = tfind.find_multiple(T, Tt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfind.find_multiple(J, Jt)))
    T2, _ = pair(["hello", "goodbye", None])
    assert tfind.find_multiple(T2, pair(["o", "bye"])[0]).tolist() == [[4, -1], [1, 4], [-2, -2]]


def test_facade_attrs_and_search():
    strs = COLS["mixed"][0]
    s, js = tnv.to_device(strs, device="cpu"), jnv.to_device(strs)
    for m in PREDICATES + ["len"]:
        assert getattr(s, m)() == getattr(js, m)(), m
    vals, jvals = np.zeros(len(strs), np.int32), np.zeros(len(strs), np.int32)
    assert s.byte_count(vals) == js.byte_count(jvals)
    np.testing.assert_array_equal(vals, jvals)
    assert s.null_count() == js.null_count() and s.null_count(True) == js.null_count(True)
    assert s.compare("m") == js.compare("m")
    assert s.startswith("RT") == js.startswith("RT") and s.endswith("!") == js.endswith("!")
    assert s.find("a", 1, 9) == js.find("a", 1, 9) and s.rfind("😀") == js.rfind("😀")
    starts = list(range(len(strs)))
    assert s.find_from("a", [k % 7 for k in starts]) == js.find_from("a", [k % 7 for k in starts])
    assert s.find_multiple(["a", "é"]) == js.find_multiple(["a", "é"])
    assert s.match_strings(strs[::-1]) == js.match_strings(strs[::-1])
    words = tnv.to_device(["hello", "oxo", None], device="cpu")
    assert words.index("o") == [4, 0, None] and words.rindex("o") == [4, 2, None]
    with pytest.raises(ValueError):
        words.index("x")
    with pytest.raises(ValueError):
        words.rindex("h")
