"""Port parity for nvcategory's string side: the keyset lookups
(`searchsorted_keys`, `first_not_less`), every function of `category.py`
and the `nvcategory` facade, held exactly to custrings_tpu (JAX on the
CPU) on seeded rows with nulls, empties, non-ASCII and 4-byte UTF-8, NUL,
and keys over 64 and over 256 bytes that share those prefixes (so the
encode's key width escalates), on both encode routes, on an unsorted
keyset built by chained merge_category; the cases of
tests/test_category.py replayed on both packages; the facade's surface;
and chip_smoke.py's category phase and its kernel captures on the CPU.
Compared: the keys' bytes within the offsets, their validity, the
values."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvcategory as jnvc
import custrings_tpu.nvstrings as jnv
from custrings_tpu import category as jcat
from custrings_tpu import column as jcol
from custrings_tpu.ops import array as jarray
from custrings_tpu.ops import unique as juq
from custrings_tpu_torch import category as tcat
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvcategory as tnvc
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import array as tarray
from custrings_tpu_torch.ops import layout as tlayout
from custrings_tpu_torch.ops import unique as tuq
from test_torch_split_ws import CS, fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

P64, P256 = CS._PREFIXES[0], CS._P256
POOL = [None, "", "a", "ab", "b", "bb", "é", "日本語", "😀", "x😀y", "a\x00b", "a\x00", "zz",
        P64, P64 + " tail", P64 + " tail 2", P64[:60] + "éé", P256, P256 + " x", P256 + " y", P256 + "😀",
        CS._PREFIXES[1]]
NEW = ["c", "é é", P64 + " new", P256 + " z", "\U0001F525", "ab\x00"]
S = ["eee", "aaa", "eee", "ddd", "ccc", "ccc", "ccc", "eee", "aaa"]
S2 = ["ggg", "fff", "hhh", "aaa", "fff", "fff", "ggg", "hhh", "bbb"]
ABF = ["a", "b", "b", "f", "c", "f"]
ABSENT = ["aa", "a\x00\x00", P64[:63], P64 + " tai", P256[:255], P256 + " x ", "zzz", "\x00", "é!"]


def seeded_rows(n: int, seed: int, pool):
    """n Zipf-ish draws from `pool`."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(pool) + 1)
    return [pool[i] for i in rng.choice(len(pool), n, p=p / p.sum())]


ROWS_A = seeded_rows(160, 1, POOL)
ROWS_B = seeded_rows(96, 2, POOL[8:] + NEW)
# rows of at most 64 bytes for the algebra and the facade: the JAX encode
# compiles a sort of (width / 4 + 3) operands for each row count and key
# width, and rows past 64 bytes add two widths of up to 70 operands
SHORT = [k for k in POOL + NEW if k is None or len(k.encode()) <= 64]
SHORT_A = seeded_rows(120, 3, SHORT)
SHORT_B = seeded_rows(64, 4, SHORT[6:] + ["new", "é new", "\U0001F525 new"])


def pair(strs):
    return tcol.from_host_strings(strs, "cpu"), jcol.from_host_strings(strs)


def same_cat(t, j):
    assert tcol.to_host_strings(t.keys) == jcol.to_host_strings(j.keys)
    assert t.values.tolist() == np.asarray(j.values).tolist()
    assert t.sorted_keys == j.sorted_keys


def test_rows_shape():
    assert None in ROWS_A and "" in ROWS_A and P256 + " x" in ROWS_A
    assert len(set(ROWS_A)) > 12 and set(ROWS_A) & set(ROWS_B) and set(ROWS_B) - set(ROWS_A)
    assert max(len(s.encode()) for s in ROWS_A if s) > 256


@pytest.fixture(scope="module")
def keysets():
    """ROWS_A's keyset, and ROWS_A's category merged with ROWS_B's (an
    unsorted keyset), in both packages; built once the module's fixture
    has made the JAX compiles cheap."""
    t, j = pair(ROWS_A)
    tb, jb = pair(ROWS_B)
    tm = tcat.merge_category(tcat.from_strings(t), tcat.from_strings(tb))
    jm = jcat.merge_category(jcat.from_strings(j), jcat.from_strings(jb))
    return {"sorted": (tuq.unique_strings(t), juq.unique_strings(j)), "unsorted": (tm.keys, jm.keys)}


def test_searchsorted_keys_matches_jax(keysets):
    tk, jk = keysets["sorted"]
    tq, jq = pair(POOL + NEW + ABSENT)
    got = tuq.searchsorted_keys(tk, tq)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(juq.searchsorted_keys(jk, jq)).tolist()
    keys = tcol.to_host_strings(tk)
    assert got.tolist() == [keys.index(s) if s in keys else -1 for s in POOL + NEW + ABSENT]


@pytest.mark.parametrize("keyset", ["sorted", "unsorted"])
def test_first_not_less_matches_jax(keysets, keyset):
    tk, jk = keysets[keyset]
    for q in [None, "", "a", "bb", "c", P64 + " u", P256 + " xx", "é", "\U0001F525\U0001F525"]:
        tq, jq = pair([q])
        assert int(tuq.first_not_less(tk, tq)) == int(juq.first_not_less(jk, jq)), q


def _lookups_match(tc, jc, few=("aa",)):
    """Every query at once through _lookup against the JAX package; the
    per-key functions on a few queries against it (each JAX lookup
    compiles its search anew, ~0.2 s) and on every query against
    chip_smoke's oracle."""
    queries = POOL + NEW + ABSENT
    tq, jq = pair(queries)
    got = tcat._lookup(tc.keys, tq, tc.sorted_keys)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(jcat._lookup(jc.keys, jq, jc.sorted_keys)).tolist()
    for q in few:
        assert tcat.value_of(tc, q) == jcat.value_of(jc, q), q
        assert tcat.get_value_bounds(tc, q) == jcat.get_value_bounds(jc, q), q
        assert tcat.indexes_for_key(tc, q).tolist() == np.asarray(jcat.indexes_for_key(jc, q)).tolist(), q
    want = CS._CatOracle(tcol.to_host_strings(tc.keys), tc.values.tolist())
    assert [tcat.value_of(tc, q) for q in queries] == [want.value(q) for q in queries] == got.tolist()
    assert [tcat.get_value_bounds(tc, q) for q in queries] == [want.bounds(q) for q in queries]
    assert [tcat.indexes_for_key(tc, q).tolist() for q in queries] == [want.indexes(q) for q in queries]


def test_lookups_and_gathers_match_jax(short):
    """The lookups on ROWS_A's keyset (keys past 64 and 256 bytes); the
    gathers on SHORT_A's (the short fixture's, whose gather and
    gather_and_remap the algebra test holds)."""
    t, j = pair(ROWS_A)
    tc, jc = tcat.from_strings(t), jcat.from_strings(j)
    same_cat(tc, jc)
    assert tc.size == jc.size and tc.keys_size == jc.keys_size
    assert tcol.to_host_strings(tcat.to_strings(tc)) == jcol.to_host_strings(jcat.to_strings(jc)) == ROWS_A
    _lookups_match(tc, jc)
    assert [tcat.value_for_index(tc, i) for i in (0, 7, 159)] == [jcat.value_for_index(jc, i) for i in (0, 7, 159)]
    (ta, _), jr = short
    ts, js = tcat.from_strings(ta._col), jr["cat"]._cat
    idx = np.random.default_rng(3).integers(0, ts.keys_size, 40)
    assert tcol.to_host_strings(tcat.gather_strings(ts, idx)) == jcol.to_host_strings(jcat.gather_strings(js, idx))
    same_cat(tcat.from_value_array(ts.keys, idx), jcat.from_value_array(js.keys, idx))
    for fn in (tcat.gather_strings, tcat.gather, tcat.gather_and_remap):
        with pytest.raises(IndexError):
            fn(ts, [0, ts.keys_size])


# one list of strings to remove (remove_strings, remove_keys) and one of
# keys to add or set (add_keys, set_keys), of one length and key width, so
# that one JAX encode program serves both
REMOVE = SHORT[::2] + ["zzz"]
KEYS_X = SHORT[1::2] + ["zz new"]


def _facade_pair(strs):
    return tnv.to_device(strs, device="cpu"), jnv.to_device(strs)


@pytest.fixture(scope="module")
def short():
    """SHORT_A's and SHORT_B's categories through both facades, and every
    op of the keyset algebra run once on the JAX facade: the core and the
    facade tests both hold the port to these results, so each JAX lookup
    and encode compiles once for the two."""
    (ta, ja), (tb, jb) = _facade_pair(SHORT_A), _facade_pair(SHORT_B)
    jc, jcb = jnvc.from_strings(ja), jnvc.from_strings(jb)
    jset = jc.set_keys(KEYS_X)
    j = {"cat": jc, "cat_b": jcb, "add_strings": jc.add_strings(jb),
         "remove_strings": jc.remove_strings(jnv.to_device(REMOVE)), "add_keys": jc.add_keys(KEYS_X),
         "remove_keys": jc.remove_keys(REMOVE), "set_keys": jset, "remove_unused_keys": jset.remove_unused_keys(),
         "merge_and_remap": jc.merge_and_remap(jcb), "merge_category": jc.merge_category(jcb),
         "gather": jc.gather([4, 1, 4, 0]), "gather_and_remap": jc.gather_and_remap([4, 1, 4])}
    return (ta, tb), j


def test_row_edits_and_keyset_algebra_match_jax(short):
    """Each op against the JAX package, and the JAX package against
    chip_smoke's oracle (_CatOracle), so the chip's checks are held to
    the same semantics."""
    (ta, tb), j = short

    def same(t, name, want):
        jr = j[name]._cat
        same_cat(t, jr)
        assert (jcol.to_host_strings(jr.keys), np.asarray(jr.values).tolist()) == (want.keys, want.values.tolist())

    tc, tcb = tcat.from_strings(ta._col), tcat.from_strings(tb._col)
    ca, cb = CS._CatOracle.encode(SHORT_A), CS._CatOracle.encode(SHORT_B)
    same(tc, "cat", ca)
    same(tcb, "cat_b", cb)
    same(tcat.add_strings(tc, tb._col), "add_strings", CS._CatOracle.encode(SHORT_A + SHORT_B))
    same(tcat.remove_strings(tc, tcol.from_host_strings(REMOVE, "cpu")), "remove_strings",
         CS._CatOracle.encode([r for r in SHORT_A if r not in REMOVE]))
    keys_x = tcol.from_host_strings(KEYS_X, "cpu")
    same(tcat.add_keys(tc, keys_x), "add_keys", ca.add_keys(KEYS_X))
    removed = tcat.remove_keys(tc, tcol.from_host_strings(REMOVE, "cpu"))
    same(removed, "remove_keys", ca.remove_keys(REMOVE))
    assert (removed.values == -1).any()
    assert tcol.to_host_strings(tcat.to_strings(removed)) == jcol.to_host_strings(jcat.to_strings(j["remove_keys"]._cat))
    set_t = tcat.set_keys(tc, keys_x)
    same(set_t, "set_keys", ca.set_keys(KEYS_X))
    assert (set_t.values == -1).any()
    same(tcat.remove_unused_keys(set_t), "remove_unused_keys", ca.set_keys(KEYS_X).remove_unused())
    same(tcat.merge_and_remap(tc, tcb), "merge_and_remap", ca.merge_and_remap(cb))
    same(tcat.merge_category(tc, tcb), "merge_category", ca.merge_category(cb))
    same_cat(tcat.gather(tc, [4, 1, 4, 0]), j["gather"]._cat)
    same_cat(tcat.gather_and_remap(tc, [4, 1, 4]), j["gather_and_remap"]._cat)


@pytest.mark.parametrize("route", ["sorted", "hashed"])
def test_encodes_on_both_routes_match_jax(monkeypatch, route):
    """from_strings of two columns (the width escalates past 64 and 256)
    on each of the encode's routes."""
    if route == "hashed":
        monkeypatch.setattr(tuq, "HASHED_MIN", 1)
        monkeypatch.setattr(juq, "HASHED_MIN", 1)
    t, j = pair(ROWS_A)
    tb, jb = pair(ROWS_B)
    tc, jc = tcat.from_strings(t, tb), jcat.from_strings(j, jb)
    same_cat(tc, jc)
    assert tcol.to_host_strings(tc.keys) == CS._CatOracle.encode(ROWS_A + ROWS_B).keys


def test_chained_merge_category_unsorted_keyset_matches_jax(short):
    """SHORT_A's category merged with SHORT_B's, then with KEYS_X's: the
    keyset is unsorted, and every lookup walks it (get_value_bounds on
    it held to the JAX package at one query and to the oracle at all)."""
    (ta, tb), j = short
    tm = tcat.merge_category(tcat.from_strings(ta._col), tcat.from_strings(tb._col))
    jm = j["merge_category"]._cat
    same_cat(tm, jm)
    tx, jx = pair(KEYS_X)
    tm, jm = tcat.merge_category(tm, tcat.from_strings(tx)), jcat.merge_category(jm, jcat.from_strings(jx))
    same_cat(tm, jm)
    assert not tm.sorted_keys
    _lookups_match(tm, jm, few=("bc",))


def test_get_value_bounds_walks_an_unsorted_keyset():
    """After merge_category a keyset is unsorted, and get_value_bounds
    walks it in that order.  On [None, a, b, é, c, zz] the JAX package
    gives (2, 3) for "bb" and for "d" (the walk stops at "é"), where the
    sorted keyset gives (3, 4) for "d"; the port gives the same.  The
    chained test holds the walk to the JAX package on the seeded rows."""
    def cat(rows):
        return tcat.from_strings(tcol.from_host_strings(rows, "cpu"))

    m = tcat.merge_category(cat([None, "a", "b", "é"]), cat(["c", "zz"]))
    assert not m.sorted_keys
    assert [tcat.get_value_bounds(m, q) for q in ("bb", "d", "é!")] == [(2, 3), (2, 3), (5, 6)]
    assert tcat.get_value_bounds(cat([None, "a", "b", "é", "c", "zz"]), "d") == (3, 4)


# ---------------------------------------------------------------- replays



def _out(x):
    """Host form of a case's result: strings of a column, lists of ints."""
    if hasattr(x, "keys") and hasattr(x, "values") and not isinstance(x, dict):
        return (_out(x.keys), _out(x.values))
    if hasattr(x, "validity"):
        return tuple(tcol.to_host_strings(x) if isinstance(x, tcol.StringColumn) else jcol.to_host_strings(x))
    if isinstance(x, (tuple, list)):
        return tuple(_out(v) for v in x)
    if isinstance(x, (int, bool)) or x is None:
        return x
    return tuple(np.asarray(x).tolist())


REPLAYS = {
    "basic": lambda C, d: (C.from_strings(d(S)), C.from_strings(d(S)).size, C.from_strings(d(S)).keys_size),
    "value_lookup": lambda C, d: (C.value_for_index(C.from_strings(d(S)), 7), C.value_of(C.from_strings(d(S)), "ccc"),
                                  C.value_of(C.from_strings(d(S)), "zzz"),
                                  C.indexes_for_key(C.from_strings(d(S)), "ccc")),
    "to_strings": lambda C, d: C.to_strings(C.from_strings(d(S))),
    "from_strings_multi": lambda C, d: C.from_strings(d(S), d(S2)),
    "add_strings": lambda C, d: C.add_strings(C.from_strings(d(S)), d(S)),
    "remove_strings": lambda C, d: C.remove_strings(C.from_strings(d(S)), d(["ccc", "aaa", "bbb"])),
    "gather_strings": lambda C, d: C.gather_strings(C.from_strings(d(S)), [0, 2, 0]),
    "add_keys": lambda C, d: C.add_keys(C.from_strings(d(ABF)), d(["a", "b", "c", "d"])),
    "remove_keys": lambda C, d: C.remove_keys(C.from_strings(d(ABF)), d(["b", "d"])),
    "set_keys": lambda C, d: C.set_keys(C.from_strings(d(ABF)), d(["b", "c", "e", "d"])),
    "remove_unused_keys": lambda C, d: C.remove_unused_keys(C.set_keys(C.from_strings(d(ABF)), d(["b", "c", "e", "d"]))),
    "gather": lambda C, d: C.gather(C.from_strings(d(ABF)), [1, 3, 2, 3, 1, 2]),
    "gather_and_remap": lambda C, d: C.gather_and_remap(C.from_strings(d(ABF)), [1, 3, 2, 3, 1, 2]),
    "merge_category": lambda C, d: C.merge_category(C.from_strings(d(S)), C.from_strings(d(S2))),
    "merge_and_remap": lambda C, d: C.merge_and_remap(C.from_strings(d(S)), C.from_strings(d(S2))),
    "category_with_nulls": lambda C, d: (C.from_strings(d(["b", None, "a", None, "b"])),
                                         C.to_strings(C.from_strings(d(["b", None, "a", None, "b"])))),
    "get_value_bounds": lambda C, d: tuple(C.get_value_bounds(C.from_strings(d(["b", "d", "f", "b"])), k)
                                           for k in ("d", "c", "a", "z")),
    "merge_category_chained": lambda C, d: _chained(C, d),
}


def _chained(C, d):
    nc = C.merge_category(C.from_strings(d(["a", "a", "d", "c", "c", "e"])), C.from_strings(d(ABF)))
    nc2 = C.merge_category(nc, C.from_strings(d(["b", "a", "a", "e", "g", "b"])))
    nc3 = C.remove_keys(nc2, d(["c"]))
    return (nc2, nc.sorted_keys, C.value_of(nc2, "b"), C.value_of(nc2, "g"), C.value_of(nc2, "zzz"),
            C.indexes_for_key(nc2, "b"), nc3, C.value_of(nc3, "b"))


@pytest.mark.parametrize("case", sorted(REPLAYS))
def test_category_cases_replayed_on_both_packages(case):
    fn = REPLAYS[case]
    got = _out(fn(tcat, lambda s: tcol.from_host_strings(s, "cpu")))
    want = _out(fn(jcat, jcol.from_host_strings))
    assert got == want


def test_absent_key_finds_no_rows():
    """The string indexes_for_key returns no rows for an absent key, even
    where removed keys left -1 values (the numeric one differs); on the
    replayed remove_keys case, whose programs are compiled by now."""
    got = [C.indexes_for_key(C.remove_keys(C.from_strings(d(ABF)), d(["b", "d"])), "zz")
           for C, d in ((tcat, lambda s: tcol.from_host_strings(s, "cpu")), (jcat, jcol.from_host_strings))]
    assert got[0].tolist() == np.asarray(got[1]).tolist() == []


def test_gather_out_of_range_raises_on_both_packages():
    for C, d in ((tcat, lambda s: tcol.from_host_strings(s, "cpu")), (jcat, jcol.from_host_strings)):
        cat = C.from_strings(d(S))
        for fn in (C.gather_strings, C.gather, C.gather_and_remap):
            with pytest.raises(IndexError):
                fn(cat, [0, 2, 0, 4])
    s = tnv.to_device(["a", "b", "c"], device="cpu")
    with pytest.raises(IndexError):
        s.gather([5])
    assert s.gather([-1]).to_host() == jnv.to_device(["a", "b", "c"]).gather([-1]).to_host() == ["c"]


@pytest.mark.parametrize("trial", [0, 1])
def test_hashed_encode_matches_sorted_encode_and_jax(trial):
    pool = ["apple", "pear", "b" * 80, "b" * 80 + "x", "", "zz", None,
            "common prefix " + "q" * 70, "common prefix " + "q" * 70 + "t"]
    strs = [pool[i] for i in np.random.default_rng(77 + trial).integers(0, len(pool), 200)]
    t, j = pair(strs)
    full = max(-(-max(len((s or "").encode()) for s in strs) // 4) * 4, 4)
    width = min(full, 16)
    ord_, _, values_s, first, amb_s = tuq._encode_sorted(t, width, full)
    values_h, key_rows, nkeys, amb_h, _, _ = tuq._encode_hashed(t, width, full)
    assert bool(amb_h) == bool(amb_s) == bool(juq._encode_sorted(j, width, full)[4])
    if not bool(amb_s):
        assert values_h.tolist() == values_s.tolist()
        assert [strs[i] for i in ord_[first].tolist()] == [strs[i] for i in key_rows[: int(nkeys)].tolist()]
    keys, values = tuq.dictionary_encode(t)
    jkeys, jvalues = juq.dictionary_encode(j)
    assert tcol.to_host_strings(keys) == jcol.to_host_strings(jkeys)
    assert values.tolist() == np.asarray(jvalues).tolist()


def test_key_words_stream_route_matches_k1b_and_jax(monkeypatch):
    strs = ["alpha", "be", "", "x" * 37, "héllo🎉", "alpha"]
    t, j = pair(strs)
    window = tarray._key_words(t, 40)
    monkeypatch.setattr(tlayout, "STREAM_VIEW_MIN", 0)
    assert torch.equal(tarray._key_words(t, 40), window)
    want = np.asarray(jarray._key_words_xla(j, 40)).astype(np.uint32)
    assert (window.numpy().view(np.uint32) == want).all()


# ---------------------------------------------------------------- facade


def test_facade_matches_jax(short):
    """Every nvcategory method through the port's facade against the JAX
    facade's results on the same calls (the short fixture's)."""
    (ta, tb), j = short
    jc, jcb = j["cat"], j["cat_b"]
    tc, tcb = tnvc.from_strings(ta), tnvc.from_strings(tb)

    def same(t, j):
        assert t.keys().to_host() == j.keys().to_host()
        assert t.values() == j.values()
        assert (t.size(), t.keys_size(), t.keys_type(), t.has_nulls()) == (
            j.size(), j.keys_size(), j.keys_type(), j.has_nulls())

    same(tc, jc)
    same(tcb, jcb)
    # the other constructors make the categories the fixture's ops made
    same(tnvc.from_strings(ta, tb), j["add_strings"])
    same(tnvc.from_strings_list([ta, SHORT_B], device="cpu"), j["add_strings"])
    same(tnvc.to_device(SHORT_B, device="cpu"), jcb)
    buf, offs, nulls = tcol.to_offsets_np(ta._col)
    same(tnvc.from_offsets(buf, offs, ta.size(), nulls, device="cpu"), jc)
    assert tc.get_cpointer() == jc.get_cpointer() == 0
    assert tc.values_cpointer() == tc._cat.values.data_ptr()
    out_t, out_j = np.zeros(len(SHORT_A), np.int32), np.zeros(len(SHORT_A), np.int32)
    assert (tc.values(out_t) == jc.values(out_j)).all()
    for q in ("é", "aa"):
        assert tc.value(q) == jc.value(q) and tc.get_value_bounds(q) == jc.get_value_bounds(q), q
    assert tc.indexes_for_key("é") == jc.indexes_for_key("é")
    assert tc.indexes_for_key(None, out_t) == jc.indexes_for_key(None, out_j) and (out_t == out_j).all()
    assert [tc.value_for_index(i) for i in range(5)] == [jc.value_for_index(i) for i in range(5)]
    assert tc.to_strings().to_host() == jc.to_strings().to_host() == SHORT_A
    assert tc.gather_strings([0, 3, 1]).to_host() == jc.gather_strings([0, 3, 1]).to_host()
    same(tc.gather([4, 1, 4, 0]), j["gather"])
    same(tc.gather_and_remap([4, 1, 4]), j["gather_and_remap"])
    same(tc.add_strings(tb), j["add_strings"])
    same(tc.remove_strings(tnv.to_device(REMOVE, device="cpu")), j["remove_strings"])
    same(tc.add_keys(KEYS_X), j["add_keys"])
    same(tc.add_keys(tnv.to_device(KEYS_X, device="cpu")), j["add_keys"])
    same(tc.remove_keys(REMOVE), j["remove_keys"])
    set_t = tc.set_keys(KEYS_X)
    same(set_t, j["set_keys"])
    same(set_t.remove_unused_keys(), j["remove_unused_keys"])
    same(tc.merge_category(tcb), j["merge_category"])
    same(tc.merge_and_remap(tcb), j["merge_and_remap"])


def test_facade_truncated_prefix_escalation_and_absent_key():
    """The literals of tests/test_category.py's test_truncated_prefix_escalation
    and test_indexes_for_key_absent, which hold the JAX package to them."""
    c = tnvc.to_device(["x" * 64 + "b", "x" * 64 + "ac"], device="cpu")
    assert list(c.keys()) == ["x" * 64 + "ac", "x" * 64 + "b"] and c.values() == [1, 0]
    assert (c.value("x" * 64 + "ac"), c.value("x" * 64 + "b")) == (0, 1)
    c2 = tnvc.to_device(["y" * 100, "y" * 100, "y" * 99 + "z"], device="cpu")
    assert list(c2.keys()) == ["y" * 100, "y" * 99 + "z"] and c2.values() == [0, 0, 1]
    assert len(np.asarray(tnvc.to_device(["a", "b", "a"], device="cpu").indexes_for_key("zzz"))) == 0


def test_facade_quirks_on_both_packages():
    """to_device of a nested list raises TypeError; bind_cpointer raises;
    keys_type() is "str"; one-column from_strings still works."""
    for mod, kw in ((tnvc, {"device": "cpu"}), (jnvc, {})):
        with pytest.raises(TypeError):
            mod.to_device([["a", "b"], ["c"]], **kw)
        with pytest.raises(NotImplementedError):
            mod.bind_cpointer(0)
        assert mod.to_device(["b", "a"], **kw).keys_type() == "str"
    assert tnvc.from_strings(tnv.to_device(S, device="cpu")).keys().to_host() == ["aaa", "ccc", "ddd", "eee"]


def _public(cls):
    return {n for n in vars(cls) if not n.startswith("_") and callable(getattr(cls, n))}


def test_facade_surface():
    assert len(_public(jnvc.nvcategory)) == 24 and len(_public(jnvc.numeric_category)) == 18
    assert _public(jnvc.nvcategory) <= _public(tnvc.nvcategory)
    assert _public(jnvc.numeric_category) <= _public(tnvc.numeric_category)
    funcs = {"to_device", "from_strings", "from_strings_list", "from_offsets", "from_numbers", "bind_cpointer"}
    assert funcs <= {n for n in dir(jnvc) if callable(getattr(jnvc, n))}
    assert all(callable(getattr(tnvc, n, None)) for n in funcs)


def test_new_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf, offs, nulls = tcol.to_offsets_np(tcol.from_host_strings(["a", None], "cpu"))
    for call in (lambda: tnvc.to_device(["a"]), lambda: tnvc.from_strings_list([["a"]]),
                 lambda: tnvc.from_offsets(buf, offs, 2, nulls), lambda: tnvc.from_numbers([1, 2])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------- chip_smoke


def test_chip_smoke_category_phase_on_cpu():
    """chip_smoke.py's category phase at 2,048 rows on the CPU: every
    method of both facades, every row against its oracles."""
    a, b, keys = CS.make_category_rows(2048, seed=8, nkeys=800, b_rows=512)
    assert len(set(keys)) == len(keys) == 1200 and sum(len(k.encode()) >= 256 for k in keys) == 32
    assert sum(not k.isascii() for k in keys) > 30
    nums = CS.make_numeric_columns(2048, seed=9, b_rows=512)
    res, _, _ = CS._run_category(torch, a, b, nums, device="cpu")
    bad = CS._check_category(a, b, nums, res)
    assert len(bad) > 100 and not any(bad.values()), {k: v for k, v in bad.items() if v}


def test_chip_smoke_category_kernel_captures_on_cpu():
    a, _, _ = CS.make_category_rows(2048, seed=8, nkeys=600, b_rows=16)
    nums = CS.make_numeric_columns(2048, seed=9, b_rows=16)
    cases = CS._category_kernel_shapes(torch, a, nums, device="cpu")
    assert [name for name, *_ in cases] == ["window_words", "scan_sum"]
    (_, _, _, words), (_, _, _, scans) = cases
    assert len(words) == 2 and words[0][0].startswith("i32[2048,")
    for label, kern, plain, extra in words + scans:
        assert torch.equal(kern(), plain()), label
        assert extra["bound"][0] > 0
