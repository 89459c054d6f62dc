"""Port parity for the char-level ops: the charwise engine (its ASCII
shortcut and its K4e byte layout), the case maps, translate, the char
slices (with a step) and get, and the strips, against custrings_tpu on
the same host strings (Pallas kernels in interpret mode), with Python
oracles where its semantics are the JAX package's.

The case table is BMP only and 1:1 (a multi-char casing takes its first
code point: "ß" upper is "S"), and strip's default set is " \\n\\t"."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu.ops import case as jcase
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import modify as jmodify
from custrings_tpu.ops import strip as jstrip
from custrings_tpu.ops import substr as jsubstr
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import case as tcase
from custrings_tpu_torch.ops import charwise, layout, shift_compact
from custrings_tpu_torch.ops import modify as tmodify
from custrings_tpu_torch.ops import strip as tstrip
from custrings_tpu_torch.ops import substr as tsubstr

from test_torch_attrs_find import COLS
from test_torch_split_ws import fast_reference_compiles, pair, same_column  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

KINDS = ["lower", "upper", "swapcase", "capitalize", "title"]


def test_encode_codepoints_and_char_counts():
    cps = np.array([0, 0x41, 0x7F, 0x80, 0xDF, 0x7FF, 0x800, 0x20AC, 0xFFFF, 0x10000, 0x1F600, 0x10FFFF],
                   np.int32)
    tb, tw = layout.encode_codepoints(torch.from_numpy(cps))
    jb, jw = jlayout.encode_codepoints(cps)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for i, cp in enumerate(cps.tolist()):
        assert bytes(tb[i, : tw[i]].tolist()) == chr(cp).encode("utf-8", "surrogatepass")
    for _, T, J in COLS.values():
        np.testing.assert_array_equal(layout.char_counts(T).numpy(), np.asarray(jlayout.char_counts(J)))


@pytest.mark.parametrize("cols", sorted(COLS))
@pytest.mark.parametrize("kind", KINDS)
def test_case_parity(kind, cols):
    _, T, J = COLS[cols]
    same_column(getattr(tcase, kind)(T), getattr(jcase, kind)(J))


def test_case_reference_cases():
    corpus = ["Hello", "WORLD", None, "aBcD", "ñÑ", "", "álpha BETA"]
    T, _ = pair(corpus)
    for kind in ("lower", "upper", "swapcase", "capitalize"):
        assert tcol.to_host_strings(getattr(tcase, kind)(T)) == [
            None if s is None else getattr(s, kind)() for s in corpus]
    T, _ = pair(["hello world", "a-b c", None, "ABC def"])
    assert tcol.to_host_strings(tcase.title(T)) == ["Hello World", "A-B C", None, "Abc Def"]
    # the 16-bit table's first code point of a multi-char casing
    got = tnv.to_device(["ß", "ŉo", "ΐ", "straße"], device="cpu").upper().to_host()
    assert got == ["S", "ʼO", "Ι", "STRASE"]


def test_case_bytes_shrink_and_grow():
    """İ (2 bytes) lowers to i (1) and ẞ (3) to ß (2): fewer bytes than the
    input; ɐ (2) uppers to Ɐ (3): more."""
    strs = ["İ", "ẞẞ x", "ɐbc", None, "", "İẞɐ" * 9]
    T, J = pair(strs)
    for kind in ("lower", "upper"):
        same_column(getattr(tcase, kind)(T), getattr(jcase, kind)(J))
    assert tcol.to_host_strings(tcase.lower(T))[:3] == ["i", "ßß x", "ɐbc"]
    assert tcol.to_host_strings(tcase.upper(T))[2] == "ⱯBC"
    assert tcol.to_host_strings(tcase.swapcase(T))[:3] == ["i", "ßß X", "ⱯBC"]


def test_charwise_paths_agree():
    """The ASCII shortcut and the K4e byte layout build the same column
    from the same body; on a non-ASCII column the engine's one expansion
    puts each char's codepoint at its first byte."""
    strs, T, _ = COLS["ascii"]
    fast = charwise.run_charwise(tcase._case_body, T, "upper", ascii_out=True)
    slow = charwise.run_charwise(tcase._case_body, T, "upper", ascii_out=False)
    np.testing.assert_array_equal(fast.offsets.numpy(), slow.offsets.numpy())
    assert tcol.to_host_strings(fast) == tcol.to_host_strings(slow) == [
        None if s is None else s.upper() for s in strs]
    calls = []
    expand_to = shift_compact.expand_to

    def logged(live, dist, arrays, out_cap, *rest):
        calls.append((live.shape[0], out_cap))
        return expand_to(live, dist, arrays, out_cap, *rest)

    shift_compact.expand_to = logged
    try:
        tcase.lower(COLS["mixed"][1])
        charwise.run_charwise(tcase._case_body, T, "lower", ascii_out=True)
    finally:
        shift_compact.expand_to = expand_to
    assert len(calls) == 1 and calls[0][1] >= calls[0][0]


def test_build_charwise_and_codepoint_gather():
    strs, T, _ = COLS["mixed"]
    get = charwise.input_codepoint_gather(T)
    nch = layout.char_counts(T)
    # each row reversed, char by char, with its own validity flipped
    co = layout.char_map(T).char_offsets[:-1]

    def cp_fn(rows, oc, valid, *, cidx, bcast):
        return get(bcast(co) + bcast(nch) - 1 - oc)

    out = charwise.build_charwise(T, nch, cp_fn, validity=~T.validity)
    host = tcol.to_host_strings(tcol.StringColumn(out.data, out.offsets, torch.ones_like(out.validity)))
    assert host == ["" if s is None else s[::-1] for s in strs]
    assert out.validity.tolist() == [s is None for s in strs]


TABLES = [
    {"l": "L", "o": None},
    {"a": "4", "e": None, "é": "e", "😀": None, "!": "¡", "t": "T"},
    {ord("ß"): "ss"[0], ord("x"): 0x1F600, ord("\x00"): None, ord(" "): "_"},
    [("a", "ä"), ("ä", "a")],
    {},
]


@pytest.mark.parametrize("table", range(len(TABLES)))
def test_translate_parity(table):
    """Against custrings_tpu for a deleting and widening table and for
    pairs; against str.translate for every dict."""
    strs, T, J = COLS["mixed"]
    tab = TABLES[table]
    got = tmodify.translate(T, tab)
    if table in (1, 3):
        same_column(got, jmodify.translate(J, tab))
    if isinstance(tab, dict):
        py = {ord(k) if isinstance(k, str) else k: v for k, v in tab.items()}
        assert tcol.to_host_strings(got) == [None if s is None else s.translate(py) for s in strs]


def test_translate_reference_tables():
    import string

    corpus = ["hello", "there", "world", "accéntéd", None, "", "Equations: 3+3=6; 3/4 < 1 and > 0"]
    T, _ = pair(corpus)
    for table in ({}, str.maketrans("e", "a"), str.maketrans("elh", "ELH"),
                  str.maketrans("", "", string.punctuation),
                  str.maketrans(string.punctuation, " " * len(string.punctuation))):
        assert tcol.to_host_strings(tmodify.translate(T, table)) == [
            None if x is None else x.translate(table) for x in corpus]


#: (start, stop, step, held to custrings_tpu too): the others to Python
SLICES = [(1, 4, None, True), (0, None, 2, True), (2, 40, 3, True), (-1, None, None, True),
          (0, None, -1, False), (0, 0, 1, False), (3, 1, 2, False), (1, None, 5, False),
          (5, 2, None, False), (0, 2, 1, False)]


@pytest.mark.parametrize("start,stop,step,jax", SLICES)
def test_slice_chars_parity(start, stop, step, jax):
    strs, T, J = COLS["mixed"]
    got = tsubstr.slice_chars(T, start, stop, step)
    if jax:
        same_column(got, jsubstr.slice_chars(J, start, stop, step))
    else:
        # a negative start or a stop <= 0 means the row's end; a negative
        # step takes no char (the window runs forward)
        s0 = start if start >= 0 else None
        e0 = stop if stop is not None and stop > 0 else None
        want = [None if x is None else (x[s0:e0:step] if s0 is not None and (step or 1) > 0 else "")
                for x in strs]
        assert tcol.to_host_strings(got) == want
    if start >= 0 and (stop is None or stop > 0) and (step or 1) > 0:
        assert tcol.to_host_strings(got) == [None if s is None else s[start:stop:step] for s in strs]


@pytest.mark.parametrize("i", [0, 2, 30])
def test_get_char_parity(i):
    strs, T, J = COLS["mixed"]
    got = tsubstr.get_char(T, i)
    same_column(got, jsubstr.get_char(J, i))
    assert tcol.to_host_strings(got) == [None if s is None else s[i: i + 1] for s in strs]


@pytest.mark.parametrize("to_strip", [None, "o H", "", "é😀 ", "\x00a"])
def test_strip_parity(to_strip):
    """Against custrings_tpu for the default and a multi-byte set, against
    str.strip for every set."""
    for strs, T, J in COLS.values():
        chars = " \n\t" if to_strip is None else to_strip
        for t_fn, j_fn, py in ((tstrip.strip, jstrip.strip, str.strip),
                               (tstrip.lstrip, jstrip.lstrip, str.lstrip),
                               (tstrip.rstrip, jstrip.rstrip, str.rstrip)):
            got = t_fn(T, to_strip)
            if to_strip in (None, "é😀 "):
                same_column(got, j_fn(J, to_strip))
            assert tcol.to_host_strings(got) == [None if s is None else py(s, chars) for s in strs]


def test_facade_charwise_ops():
    strs = COLS["mixed"][0]
    s, js = tnv.to_device(strs, device="cpu"), jnv.to_device(strs)
    for m, a in [("strip", ()), ("lower", ()), ("upper", ()), ("title", ()), ("capitalize", ()),
                 ("swapcase", ()), ("slice", (2, 40, 3)), ("get", (2,)), ("translate", (TABLES[1],))]:
        assert getattr(s, m)(*a).to_host() == getattr(js, m)(*a).to_host(), m
    starts = [k % 4 for k in range(len(strs))]
    stops = [k % 7 - 1 for k in range(len(strs))]
    assert s.slice_from(starts, stops).to_host() == js.slice_from(starts, stops).to_host()
    assert s.slice_from().to_host() == strs
    empty = tnv.to_device([], device="cpu")
    assert empty.lower().to_host() == [] and empty.strip().to_host() == [] and empty.slice(0, 2, 2).to_host() == []
