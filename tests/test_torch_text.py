"""Port parity for nvtext: every function of `text/token.py`, `text/ngram.py`
and `text/distance.py`, and the `nvtext` facade, against custrings_tpu on
the same host strings (Pallas K3 in interpret mode, as the JAX package's
own tests run it on the CPU).  The cases mirror `tests/test_text.py`, then
run again on the seeded whitespace rows of `test_torch_split_ws.py`.
Compared exactly: valid rows' bytes, offsets, validity and numbers."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvtext as jnvtext
from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.text import distance as jdist
from custrings_tpu.text import ngram as jngram
from custrings_tpu.text import token as jtok
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch import nvtext as tnvtext
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.text import distance as tdist
from custrings_tpu_torch.text import ngram as tngram
from custrings_tpu_torch.text import token as ttok

from test_torch_split_ws import CS, STRS, fast_reference_compiles, pair, same_column  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

CORPUS = ["the quick fox jumped over the lazy dog",
          "the siamésé cat jumped under the sofa", None, ""]
ROWS = STRS[:160]
# tests/test_text.py's rows, then the seeded ones: one call of each op
# (one JAX compile) covers both
BOTH = CORPUS + ROWS


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def both(fn, jfn, strs, *args):
    """(port result, JAX result) of the same op on the same strings."""
    t, j = pair(strs)
    return fn(t, *args), jfn(j, *args)


@pytest.mark.parametrize("delimiter", [None, " ", ",;"])
def test_tokenize(delimiter):
    got, want = both(ttok.tokenize_record, jtok.tokenize_record, BOTH, delimiter)
    same_column(got.tokens, want.tokens)
    same(got.row_offsets, want.row_offsets)
    if delimiter is None:
        exp = [t for s in BOTH if s for t in tnv_split(s)]
        assert tcol.to_host_strings(got.tokens) == exp


def tnv_split(s):
    """The row's words: runs of code points above 0x20."""
    return [w for w in CS.ws_split(s, -1) if w]


def test_tokenize_multi_delim():
    got, want = both(ttok.tokenize, jtok.tokenize, ["a,b;c", "x,,y"], ",;")
    same_column(got, want)
    assert tcol.to_host_strings(got) == ["a", "b", "c", "x", "y"]


@pytest.mark.parametrize("delimiter", [" ", None])
def test_token_count(delimiter):
    got, want = both(ttok.token_count, jtok.token_count, BOTH, delimiter)
    same(got, want)
    if delimiter == " ":
        assert got.tolist()[:4] == [8, 7, 0, 0]


def test_unique_tokens():
    got, want = both(ttok.unique_tokens, jtok.unique_tokens, BOTH, " ")
    same_column(got, want)


def test_normalize_spaces():
    strs = ["  the\t quick  brown   fox ", "hello", None, "", "   "] + ROWS
    got, want = both(ttok.normalize_spaces, jtok.normalize_spaces, strs)
    same_column(got, want)
    assert tcol.to_host_strings(got) == [None if s is None else " ".join(tnv_split(s)) for s in strs]


@pytest.mark.parametrize("strs,tg,rp,delimiter", [
    (["the quick fox", "fox the", None, "foxx"], ["fox", "the"], ["bear", "a"], None),
    (ROWS, ["the", "aa", "é", "日本語"], ["THE", "", "e", "x y"], None),
    (ROWS, ["the", "a"], ["_"], " "),
], ids=["corpus", "ws_rows", "one_repl"])
def test_replace_tokens(strs, tg, rp, delimiter):
    (t, j), (tt, jt), (tr, jr) = pair(strs), pair(tg), pair(rp)
    same_column(ttok.replace_tokens(t, tt, tr, delimiter), jtok.replace_tokens(j, jt, jr, delimiter))


@pytest.mark.parametrize("delimiter", [" ", None])
def test_tokens_counts(delimiter):
    strs = ["a b a", "b b", None] + ROWS
    # a repeated target counts each token equal to it in both its columns
    (t, j), (tt, jt) = pair(strs), pair(["a", "b", "the", "aa", "é", "naïve", "x😀y", "", "the,the", "b"])
    got = ttok.tokens_counts(t, tt, delimiter)
    same(got, jtok.tokens_counts(j, jt, delimiter))
    assert got[:3, :2].tolist() == [[2, 1], [0, 2], [0, 0]]
    assert torch.equal(got[:, 9], got[:, 1])


def test_contains_and_strings_counts():
    strs = ["hello", "goodbye", None, "banana", "nana"] + ROWS
    (t, j), (tt, jt) = pair(strs), pair(["ell", "oo", "na", "an", "the", "aa", "é", "\x00", " ", ""])
    got = ttok.contains_strings(t, tt)
    same(got, jtok.contains_strings(j, jt))
    assert got[:3, :2].tolist() == [[True, False], [False, True], [False, False]]
    cnt = ttok.strings_counts(t, tt)
    same(cnt, jtok.strings_counts(j, jt))
    assert cnt[3:5, 2:4].tolist() == [[2, 2], [2, 1]]


def test_scatter_count():
    got, want = both(ttok.scatter_count, jtok.scatter_count, ["a", "b", None, "c"], [2, 0, 1, 3])
    same_column(got, want)


def _lev(a, b):
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        for k, cb in enumerate(b, 1):
            prev, dp[k] = dp[k], min(dp[k] + 1, dp[k - 1] + 1, prev + (ca != cb))
    return dp[-1]


@pytest.mark.parametrize("strs,target", [
    (["kitten", "sitting", "", None, "puffy"], "puppy"),
    (ROWS, "the quick"),
    (ROWS, ""),
], ids=["corpus", "ws_rows", "empty_target"])
def test_edit_distance_scalar(strs, target):
    got, want = both(tdist.edit_distance_scalar, jdist.edit_distance_scalar, strs, target)
    same(got, want)
    assert got.tolist() == [0 if s is None else _lev(s, target) for s in strs]


def test_edit_distance_scalar_bucketed():
    """Length buckets (at >= 256 rows with a long outlier) in both packages."""
    strs = ["word%d" % i for i in range(300)] + ["x" * 1500 + "puppy", "naïve 😀", None]
    t, j = pair(strs)
    assert tlayout.length_buckets(t) is not None and jlayout.length_buckets(j) is not None
    got = tdist.edit_distance_scalar(t, "puppy")
    same(got, jdist.edit_distance_scalar(j, "puppy"))
    assert got.tolist() == [0 if s is None else _lev(s, "puppy") for s in strs]


@pytest.mark.parametrize("a,b", [
    (["kitten", "flaw", None], ["sitting", "lawn", "x"]),
    (ROWS[:120], ROWS[40:160]),
], ids=["corpus", "ws_rows"])
def test_edit_distance_pairwise(a, b):
    (ta, ja), (tb, jb) = pair(a), pair(b)
    got = tdist.edit_distance_pairwise(ta, tb)
    same(got, jdist.edit_distance_pairwise(ja, jb))
    assert got.tolist() == [0 if x is None or y is None else _lev(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("strs,n,sep", [
    (["this", "is", "my", "favorite", "book"], 2, "_"),
    (["a", None, "", "b", "c"], 2, "-"),
    (["a", None, "b"], 3, "_"),
    (["a", "b", "c"], 1, "_"),
    (ROWS, 3, "é"),
], ids=["corpus", "nulls", "join", "one", "ws_rows"])
def test_ngrams(strs, n, sep):
    got, want = both(tngram.create_ngrams, jngram.create_ngrams, strs, n, sep)
    same_column(got, want)


def test_porter_measure():
    strs = ["tr", "ee", "tree", "trouble", "oats", "trees", "ivy", "troubles", "private", None,
            "yyy", "ayyy", "syzygy", "", "Yay", "naïvety"] + ROWS
    got, want = both(tdist.porter_stemmer_measure, jdist.porter_stemmer_measure, strs)
    same(got, want)
    assert got.tolist()[:10] == [0, 0, 0, 1, 1, 1, 1, 2, 2, 0]


def test_tokenize_multi_string_delims():
    corpus = ["a--b-c", "x<>y--z", "--", "plain", None, "a<>--b", "", "<>-"]
    delims = ["<>", "--", "-", ""]
    (t, j), (td, jd) = pair(corpus), pair(delims)
    got = ttok.tokenize_strings(t, td)
    same_column(got, jtok.tokenize_strings(j, jd))
    single, jsingle = pair(["-"])
    same_column(ttok.tokenize_strings(t, single), jtok.tokenize_strings(j, jsingle))


def test_nvtext_facade():
    """Every nvtext function through the facade against the port's ops
    (held to custrings_tpu above); the return shapes of three against the
    JAX facade; devptr as a numpy array and as a torch tensor."""
    s = tnv.to_device(ROWS, device="cpu")
    tg = tnv.to_device(["the", "aa", "é"], device="cpu")
    col, tcol_ = s._col, tg._col
    one = tnv.to_device(["_"], device="cpu")._col
    host = tcol.to_host_strings
    assert tnvtext.tokenize(s).to_host() == host(ttok.tokenize(col))
    assert tnvtext.tokenize(s, tg).to_host() == host(ttok.tokenize_strings(col, tcol_))
    assert tnvtext.unique_tokens(s).to_host() == host(ttok.unique_tokens(col))
    assert tnvtext.replace_tokens(s, tg, "_").to_host() == host(ttok.replace_tokens(col, tcol_, one))
    assert tnvtext.normalize_spaces(s).to_host() == host(ttok.normalize_spaces(col))
    assert tnvtext.strings_counts(s, tg) == ttok.strings_counts(col, tcol_).tolist()
    assert tnvtext.tokens_counts(s, tg) == ttok.tokens_counts(col, tcol_).tolist()
    assert tnvtext.edit_distance(s, s) == tdist.edit_distance_pairwise(col, col).tolist()
    assert tnvtext.porter_stemmer_measure(s) == tdist.porter_stemmer_measure(col).tolist()
    toks = tnvtext.tokenize(s)
    assert tnvtext.ngrams(toks, 2, "+").to_host() == host(tngram.create_ngrams(toks._col, 2, "+"))
    assert tnvtext.scatter_count(tg, [1, None, 2]).to_host() == ["the", "é", "é"]
    js = jnvtext.nvstrings(jcol.from_host_strings(ROWS))
    jtg = jnvtext.nvstrings(jcol.from_host_strings(["the", "aa", "é"]))
    assert tnvtext.token_count(s) == jnvtext.token_count(js)
    assert tnvtext.contains_strings(s, tg) == jnvtext.contains_strings(js, jtg)
    assert tnvtext.edit_distance(s, "the") == jnvtext.edit_distance(js, "the")
    want = np.asarray(jnvtext.token_count(js))
    np.testing.assert_array_equal(tnvtext.token_count(s, devptr=np.zeros(len(ROWS), np.int32)), want)
    out = torch.zeros(len(ROWS), dtype=torch.int32)
    assert tnvtext.token_count(s, devptr=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_chip_smoke_text_oracles():
    """chip_smoke.py's text-phase oracles on its own rewritten rows: the
    numpy DP against the textbook one, the Porter oracle and the rows'
    whitespace split against the port (itself held to custrings_tpu)."""
    rows = CS.make_text_rows(CS.make_corpus(300, seed=5), seed=6)
    assert any(r is not None and "\t" in r for r in rows) and any(r is not None and "\xa0" in r for r in rows)
    pairs = [(a, b) for a, b in zip(rows, rows[7:] + rows[:7]) if a is not None and b is not None][:60]
    assert CS.levenshtein_batch(pairs) == [_lev(a, b) for a, b in pairs]
    t, _ = pair(rows)
    toks = tcol.to_host_strings(ttok.unique_tokens(t, " "))
    assert [CS.porter_measure(w) for w in toks] == tdist.porter_stemmer_measure(pair(toks)[0]).tolist()
    got = ttok.tokenize_record(t, None)
    assert tcol.to_host_strings(got.tokens) == [w for r in rows if r is not None for w in tnv_split(r)]


def test_chip_smoke_text_kernel_captures():
    """chip_smoke.py's captures of K1, K1b and K4c at the text path's own
    calls find them on its rewritten rows (here on the CPU, where each
    wrapper is its plain version), and each case's plain side, chunked by
    rows, equals the wrapper's output."""
    rows = CS.make_text_rows(CS.make_corpus(300, seed=5), seed=6)
    cases = {name: shapes for name, _, _, shapes in CS._text_kernel_shapes(torch, rows, device="cpu")}
    assert sorted(cases) == ["route_compact", "window_bytes", "window_words"]
    labels = [label for shapes in cases.values() for label, *_ in shapes]
    for op in ("edit_distance to the target", "unique_tokens", "tokens_counts", "replace_tokens",
               "whitespace split writer"):
        assert any(op in label for label in labels), (op, labels)
    for shapes in cases.values():
        for label, kern, plain, extra in shapes:
            a, b = kern(), plain()  # K4c's cases give every plane and k0
            a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), label
            assert extra["bound"][0] > 0, label
