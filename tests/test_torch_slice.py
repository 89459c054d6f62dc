"""Port parity for the whole slice: ingest -> contains_re(#\\w+) ->
replace_literal("the", "THE") -> dictionary encode -> egress, through the
facades of both packages on the chip_smoke corpus (2,000 rows, seeded),
plus both encode routes and the width escalation held to custrings_tpu."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import custrings_tpu.nvcategory as jcat
import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import layout as jlayout
from custrings_tpu.ops import modify as jmod
from custrings_tpu.ops import unique as juq
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvcategory as tcat
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import modify as tmod
from custrings_tpu_torch.ops import unique as tuq


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CORPUS = CS.make_corpus(2000, seed=1)


def _pair(strs):
    j = jcol.from_host_strings(strs)
    t = tcol.from_numpy(np.asarray(j.data), np.asarray(j.offsets), np.asarray(j.validity), "cpu")
    return t, j


def test_corpus_shape():
    assert sum(s is None for s in CORPUS) > 0 and sum(s == "" for s in CORPUS) > 0
    assert sum(s is not None and not s.isascii() for s in CORPUS) > 20
    assert max(len(s.encode()) for s in CORPUS if s is not None) <= 280
    shared = [s for s in CORPUS if s is not None and s.startswith(CS._PREFIXES[0])]
    assert len(shared) > 2 and all(len(p.encode()) == 64 for p in CS._PREFIXES)
    assert len(set(CORPUS)) < len(CORPUS)


def test_slice_through_facades_matches_jax():
    s = tnv.to_device(CORPUS, device="cpu")
    js = jnv.to_device(CORPUS)
    assert s.size() == js.size() == len(CORPUS)
    hits = s.contains(CS.PATTERN)
    assert hits == js.contains(CS.PATTERN)
    r = s.replace("the", "THE", regex=False)
    jr = js.replace("the", "THE", regex=False)
    assert r.to_host() == jr.to_host()
    cat = tcat.from_strings(r)
    jc = jcat.from_strings(jr)
    assert cat.keys_size() == jc.keys_size()
    assert cat.keys().to_host() == jc.keys().to_host()
    assert cat.values() == jc.values()
    assert cat.size() == jc.size() == len(CORPUS)


def test_slice_matches_python_oracles():
    s = tnv.to_device(CORPUS, device="cpu")
    r = s.replace("the", "THE", regex=False)
    results = (s.contains(CS.PATTERN), r.to_host(), *_keys_values(r))
    bad, nkeys = CS._check_slice(CORPUS, results)
    assert not any(bad.values()), bad
    assert nkeys > 100


def _keys_values(r):
    cat = tcat.from_strings(r)
    return cat.keys().to_host(), cat.values(), cat.keys_size()


def test_encode_hashed_matches_jax_private():
    t, j = _pair(CORPUS)
    full = -(-jlayout.max_row_bytes(j) // 4) * 4
    assert full == -(-tlayout.max_row_bytes(t) // 4) * 4
    for width in (64, full):
        got = tuq._encode_hashed(t, width, full)
        want = juq._encode_hashed(j, width, full)
        values, key_rows, nkeys, amb, u, ucap = got
        jv, jk, jn, ja, ju, jucap = want
        assert (int(nkeys), bool(amb), int(u), ucap) == (int(jn), bool(ja), int(ju), jucap)
        np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(key_rows.numpy()[: int(nkeys)], np.asarray(jk)[: int(jn)])


def test_encode_sorted_matches_jax_private():
    t, j = _pair(CORPUS[:500])
    full = -(-jlayout.max_row_bytes(j) // 4) * 4
    ord_, ranks, values, first, amb = tuq._encode_sorted(t, 64, full)
    jord, jranks, jvalues, jfirst, jamb = juq._encode_sorted(j, 64, full)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    assert bool(amb) == bool(jamb)


def _prefix_column():
    p = CS._PREFIXES[0]
    strs = [p + " tail %03d zz" % i for i in range(40)] + [p + " tail 007 zz", p, None, "", "b"]
    return strs


@pytest.mark.parametrize("route", ["sorted", "hashed"])
def test_shared_prefix_escalates_width(monkeypatch, route):
    strs = _prefix_column()
    t, j = _pair(strs)
    full = -(-tlayout.max_row_bytes(t) // 4) * 4
    enc = tuq._encode_hashed if route == "hashed" else tuq._encode_sorted
    amb = enc(t, 64, full)[3 if route == "hashed" else 4]
    assert bool(amb), "rows sharing the 64-byte key prefix must be ambiguous at width 64"
    if route == "hashed":
        monkeypatch.setattr(tuq, "HASHED_MIN", 1)
        monkeypatch.setattr(juq, "HASHED_MIN", 1)
    keys, values = tuq.dictionary_encode(t)
    jkeys, jvalues = juq.dictionary_encode(j)
    assert tcol.to_host_strings(keys) == jcol.to_host_strings(jkeys)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
    want = sorted({s for s in strs if s is not None}, key=lambda s: s.encode())
    assert tcol.to_host_strings(keys) == [None] + want


@pytest.mark.parametrize(
    "pat,repl,n", [("the", "THE", -1), ("the", "THE", 1), ("aa", "bb", -1), ("é", "è", 2), ("x" * 9, "y" * 9, -1)]
)
def test_replace_same_length_parity(pat, repl, n):
    strs = ["the theme", "aaaa aaa", None, "", "ééé é", "x" * 20, "other the the"] * 3
    t, j = _pair(strs)
    got = tcol.to_host_strings(tmod.replace_literal(t, pat, repl, n))
    assert got == jcol.to_host_strings(jmod.replace_literal(j, pat, repl, n))


def test_size_changing_replace_raises():
    """Size-changing literal replace is ported now (held to custrings_tpu
    in test_torch_split.py); what still raises in the replace family is a
    regex replace whose span program the bit span passes cannot take."""
    t, j = _pair(["the", None, "a the"])
    got = tcol.to_host_strings(tmod.replace_literal(t, "the", "THEE"))
    assert got == jcol.to_host_strings(jmod.replace_literal(j, "the", "THEE")) == ["THEE", None, "a THEE"]
    with pytest.raises(NotImplementedError, match="ordered_spans"):
        tnv.nvstrings(t).replace("a|ab", "x")  # regex=True is the default


def test_kernel_launch_path_refuses_cpu_tensors():
    """The launch path takes CUDA tensors only: no CPU carry-on.  CPU
    tensors reach it never, since each wrapper routes them to its plain
    version first, so the kernel library is never loaded here."""
    from custrings_tpu_torch import kernels
    from custrings_tpu_torch.ops import scan

    with pytest.raises(ValueError, match="CUDA tensor"):
        scan._launch(torch.zeros(4, dtype=torch.int32), 0, "scan_sum")
    assert kernels._lib is None
    assert all(v == 0 for v in kernels.LAUNCHES.values())
