"""Port parity for the paddings (ljust, rjust, center, pad, zfill), repeat,
wrap, cat, fillna, insert and slice_replace, against custrings_tpu on the
same host strings (Pallas kernels in interpret mode), with Python oracles
beside it.  center's left side takes the smaller half (not str.center's
rule); wrap turns every char <= ' ' into ' ' and breaks at a line's last
space once it reaches the width (chip_smoke.wrap_py)."""

import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import combine as jcombine
from custrings_tpu.ops import modify as jmodify
from custrings_tpu.ops import pad as jpad
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import combine as tcombine
from custrings_tpu_torch.ops import modify as tmodify
from custrings_tpu_torch.ops import pad as tpad

from test_torch_attrs_find import COLS
from test_torch_split_ws import CS, fast_reference_compiles, pair, same_column  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

STRS, T, J = COLS["mixed"]


def _padded(s, width, fill, side):
    p = max(width - len(s), 0)
    left = {"l": 0, "r": p, "c": p // 2}[side]
    return fill * left + s + fill * (p - left)


@pytest.mark.parametrize("width", [0, 5, 12])
def test_pad_family_parity(width):
    for side, t_fn, j_fn in (("l", tpad.ljust, jpad.ljust), ("r", tpad.rjust, jpad.rjust),
                             ("c", tpad.center, jpad.center)):
        got = t_fn(T, width, "*" if side == "c" else None)
        same_column(got, j_fn(J, width, "*" if side == "c" else None))
        fill = "*" if side == "c" else " "
        assert tcol.to_host_strings(got) == [None if s is None else _padded(s, width, fill, side)
                                             for s in STRS]


@pytest.mark.parametrize("fill", ["é", "😀", "ß"])
def test_pad_multibyte_fill(fill):
    """A multi-byte fill char stays whole on both sides: the JAX package
    indexes the right side's fill from the row's start and splits it
    (ROADMAP Queue 3), so this is held to Python."""
    for side, t_fn in (("l", tpad.ljust), ("r", tpad.rjust), ("c", tpad.center)):
        got = tcol.to_host_strings(t_fn(T, 13, fill))
        assert got == [None if s is None else _padded(s, 13, fill, side) for s in STRS]
    # where the right fill starts on a multiple of its width, both agree
    Te, Je = pair(["ab", "abcd", None, ""])
    same_column(tpad.ljust(Te, 7, "é"), jpad.ljust(Je, 7, "é"))


def test_pad_reference_cases():
    corpus = ["abc", "abcdefgh", None, ""]
    Tc, _ = pair(corpus)
    for t_fn, py in ((tpad.ljust, str.ljust), (tpad.rjust, str.rjust), (tpad.center, str.center)):
        assert tcol.to_host_strings(t_fn(Tc, 6)) == [None if s is None else py(s, 6) for s in corpus]
    s = tnv.to_device(corpus, device="cpu")
    assert s.pad(6).to_host() == s.rjust(6).to_host()
    assert s.pad(6, "right").to_host() == s.ljust(6).to_host()
    assert s.pad(6, "both", "-").to_host() == s.center(6, "-").to_host()


@pytest.mark.parametrize("width", [0, 5, 12])
def test_zfill_parity(width):
    got = tpad.zfill(T, width)
    same_column(got, jpad.zfill(J, width))
    assert tcol.to_host_strings(got) == [None if s is None else s.zfill(width) for s in STRS]
    Tz, _ = pair(["42", "-42", "+3", "text", None, "", "-", "+"])
    assert tcol.to_host_strings(tpad.zfill(Tz, 5)) == ["00042", "-0042", "+0003", "0text", None, "00000",
                                                        "-0000", "+0000"]


@pytest.mark.parametrize("reps", [0, 1, 3])
def test_repeat_parity(reps):
    got = tpad.repeat(T, reps)
    same_column(got, jpad.repeat(J, reps))
    assert tcol.to_host_strings(got) == [None if s is None else s * max(reps, 1) for s in STRS]


@pytest.mark.parametrize("width", [1, 5, 10, 40])
def test_wrap_parity(width):
    got = tpad.wrap(T, width)
    same_column(got, jpad.wrap(J, width))
    assert tcol.to_host_strings(got) == [CS.wrap_py(s, width) for s in STRS]


def test_wrap_reference_cases():
    import pandas as pd

    s = ["quick brown fox jumped over lazy brown dog", None, "hello there, accéntéd world", ""]
    Tw, _ = pair(s)
    for width in (10, 20, 50):
        want = [None if x is None else e for x, e in zip(s, pd.Series(s).str.wrap(width))]
        assert tcol.to_host_strings(tpad.wrap(Tw, width)) == want
        assert [CS.wrap_py(x, width) for x in s] == want


@pytest.mark.parametrize("sep,na_rep", [(None, None), ("|", "-"), (":", None), ("é😀", "∅")])
def test_cat_parity(sep, na_rep):
    other = [None if i % 5 == 0 else s for i, s in enumerate(STRS[::-1])]
    To, Jo = pair(other)
    got = tcombine.cat(T, To, sep, na_rep)
    same_column(got, jcombine.cat(J, Jo, sep, na_rep))

    def side(x):
        return na_rep if x is None else x

    assert tcol.to_host_strings(got) == [
        None if side(a) is None or side(b) is None else side(a) + (sep or "") + side(b)
        for a, b in zip(STRS, other)]


def test_cat_reference_cases():
    s1, s2 = pair(["hello", None, "goodbye"])[0], pair(["world", "globe", None])[0]
    assert tcol.to_host_strings(tcombine.cat(s1, s2, ":", "_")) == ["hello:world", "_:globe", "goodbye:_"]
    assert tcol.to_host_strings(tcombine.cat(s1, s2, ":")) == ["hello:world", None, None]
    with pytest.raises(ValueError):
        tcombine.cat(s1, pair(["x"])[0])


def test_fillna_parity():
    got = tmodify.fillna_scalar(T, "-é")
    same_column(got, jmodify.fillna_scalar(J, "-é"))
    assert tcol.to_host_strings(got) == ["-é" if s is None else s for s in STRS]
    other = [None if i % 3 else "r%d" % i for i in range(len(STRS))]
    To, Jo = pair(other)
    got = tmodify.fillna_column(T, To)
    same_column(got, jmodify.fillna_column(J, Jo))
    assert tcol.to_host_strings(got) == [o if s is None else s for s, o in zip(STRS, other)]


@pytest.mark.parametrize("start", [0, 2, -1, 100])
def test_insert_parity(start):
    got = tmodify.insert(T, start, "_é_")
    same_column(got, jmodify.insert(J, start, "_é_"))
    at = (lambda s: len(s)) if start < 0 else (lambda s: start)
    assert tcol.to_host_strings(got) == [None if s is None else s[: at(s)] + "_é_" + s[at(s):] for s in STRS]


@pytest.mark.parametrize("start,stop,repl", [(1, 3, "XY"), (0, None, ""), (2, 1, "é"), (-2, 3, "z"),
                                             (None, None, "q"), (3, -1, "😀")])
def test_slice_replace_parity(start, stop, repl):
    got = tmodify.slice_replace(T, start, stop, repl)
    same_column(got, jmodify.slice_replace(J, start, stop, repl))

    def py(s):
        n = len(s)
        a = min(max(start or 0, 0), n)
        b = n if stop is None or stop < 0 else min(stop, n)
        return s[:a] + repl + s[max(a, b):]

    assert tcol.to_host_strings(got) == [None if s is None else py(s) for s in STRS]


def test_facade_pad_combine():
    s, js = tnv.to_device(STRS, device="cpu"), jnv.to_device(STRS)
    for m, a in [("pad", (9, "both", "*")), ("ljust", (7,)), ("rjust", (7,)), ("center", (7,)),
                 ("zfill", (5,)), ("repeat", (2,)), ("wrap", (5,)), ("fillna", ("-",)),
                 ("insert", (2, "__")), ("slice_replace", (1, 3, "XY"))]:
        assert getattr(s, m)(*a).to_host() == getattr(js, m)(*a).to_host(), m
    assert s.cat(s, sep="|", na_rep="-").to_host() == js.cat(js, sep="|", na_rep="-").to_host()
    assert s.cat(STRS[::-1], sep=":").to_host() == js.cat(STRS[::-1], sep=":").to_host()
    assert s.cat(sep=",", na_rep="?").to_host() == js.cat(sep=",", na_rep="?").to_host()
    assert s.cat([s, s], sep="+").to_host() == js.cat([js, js], sep="+").to_host()
    assert s.fillna(s.upper()).to_host() == js.fillna(js.upper()).to_host()
