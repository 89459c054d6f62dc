"""Port parity for nvcategory's numeric side: every numeric_category
method and the numeric core (`numeric.py`) held exactly to custrings_tpu
(JAX on the CPU, inside jax.enable_x64(True) so int64 and float64 keep
their width) at int8, int32, int64, float32 and float64, on seeded values
with NaN, -NaN, +-0.0, +-inf, the dtype's extremes (INT64_MIN/MAX) and
Arrow bitmask nulls; keys compared bitwise.  Also the numeric quirks:
indexes_for_key's count, the rows of an absent key, "is null" arrays in
the key methods, NaN and -0.0 as keys, keys_type(); the cases of
tests/test_category.py replayed on both packages."""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import custrings_tpu.nvcategory as jnvc
from custrings_tpu import numeric as jnum
from custrings_tpu_torch import numeric as tnum
from custrings_tpu_torch import nvcategory as tnvc
from test_torch_split_ws import CS, fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

DTYPES = ("int8", "int32", "int64", "float32", "float64")


def normal_edges(dtype: str):
    """The dtype's edge values but the subnormals: XLA on the CPU flushes
    them to zero, so the JAX package makes them one key with 0.0 (the port
    keeps them apart, as the reference and numpy do;
    test_subnormals_are_keys_of_their_own)."""
    e = CS._numeric_edges(dtype)
    return e if dtype in CS._INT_RANGE else e[~((e != 0) & (np.abs(e) < np.finfo(dtype).tiny))]


def seeded(dtype: str, n: int, seed: int):
    """(values, Arrow null bitmask, is-null bools): draws from a pool of
    the dtype's edge values and a few others, ~15% null."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([normal_edges(dtype), rng.integers(-100, 100, 6).astype(dtype)])
    if dtype.startswith("float"):
        pool = np.concatenate([pool, np.array([1.5, -2.25, 1e-3], dtype)])
    vals = pool[rng.integers(0, len(pool), n)]
    isnull = rng.random(n) < 0.15
    return vals, np.packbits(~isnull, bitorder="little"), isnull


def bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.view(np.uint8).tobytes()


def same_num(t, j):
    assert bits(t.keys.numpy()) == bits(np.asarray(j.keys))
    assert t.keys_valid.tolist() == np.asarray(j.keys_valid).tolist()
    assert t.values.tolist() == np.asarray(j.values).tolist()


def lookups(vals, dtype):
    out = normal_edges(dtype).tolist() + vals[:4].tolist() + [7, -128]
    return out + ([float("nan"), -0.0, 0.5] if dtype.startswith("float") else [])


def same_oracle(j, want):
    assert bits(np.asarray(j.keys)) == bits(want.keys)
    assert np.asarray(j.keys_valid).tolist() == want.valid.tolist()
    assert np.asarray(j.values).tolist() == want.values.tolist()


EXTRA_NULL = np.arange(10) % 4 == 0
# lookups past the key type: 200 would wrap to the int8 key -56
OUT_OF_RANGE = {"int8": [200, -129, 1 << 70], "int32": [1 << 31, -(1 << 40)], "int64": [1 << 63, -(1 << 64)],
                "float32": [1e300, -1e300], "float64": [1e300]}


@pytest.mark.parametrize("dtype", DTYPES)
def test_numeric_core_matches_jax(dtype):
    """Each function against the JAX package, and the JAX package against
    chip_smoke's numpy oracle (_NumOracle), so the chip's checks are held
    to the same semantics."""
    va, _, na = seeded(dtype, 48, 1)
    vb, _, nb = seeded(dtype, 24, 2)
    want, wantb = CS._NumOracle.encode(va, ~na), CS._NumOracle.encode(vb, ~nb)
    with jax.enable_x64(True):
        tc, jc = tnum.from_numbers(va, na, device="cpu"), jnum.from_numbers(va, na)
        same_num(tc, jc)
        same_oracle(jc, want)
        assert tc.keys.dtype == getattr(torch, dtype)
        tcb, jcb = tnum.from_numbers(vb, nb, device="cpu"), jnum.from_numbers(vb, nb)
        assert bits(tnum.to_numbers(tc).numpy()) == bits(jnum.to_numbers(jc))
        idx = np.arange(0, tc.keys.shape[0], 2)
        assert bits(tnum.gather_numbers(tc, idx).numpy()) == bits(jnum.gather_numbers(jc, idx))
        for k in lookups(va, dtype):
            assert tnum.value_of(tc, k) == jnum.value_of(jc, k) == want.value(k), k
            assert tnum.indexes_for_key(tc, k).tolist() == np.asarray(jnum.indexes_for_key(jc, k)).tolist(), k
        for k in OUT_OF_RANGE[dtype]:
            if isinstance(k, int):  # a Python int past the key type raises on both, never wraps to a key
                for mod, c in ((tnum, tc), (jnum, jc)):
                    with pytest.raises(OverflowError):
                        mod.value_of(c, k)
            else:
                assert tnum.value_of(tc, k) == jnum.value_of(jc, k), k
        extra, extra_null = vb[:10], EXTRA_NULL
        added_j = jnum.add_keys(jc, extra, extra_null)
        same_num(tnum.add_keys(tc, extra, extra_null), added_j)
        same_oracle(added_j, want.add_keys(extra, extra_null))
        same_num(tnum.add_keys(tc, extra), jnum.add_keys(jc, extra))
        removed_t, removed_j = tnum.remove_keys(tc, extra, extra_null), jnum.remove_keys(jc, extra, extra_null)
        same_num(removed_t, removed_j)
        same_oracle(removed_j, want.remove_keys(extra, extra_null))
        set_t, set_j = tnum.set_keys(tc, extra, extra_null), jnum.set_keys(jc, extra, extra_null)
        same_num(set_t, set_j)
        same_oracle(set_j, want.set_keys(extra, extra_null))
        same_num(tnum.remove_unused_keys(set_t), jnum.remove_unused_keys(set_j))
        same_num(tnum.gather(tc, idx), jnum.gather(jc, idx))
        same_num(tnum.gather_and_remap(tc, idx[:3]), jnum.gather_and_remap(jc, idx[:3]))
        merged_t, merged_j = tnum.merge_category(tc, tcb), jnum.merge_category(jc, jcb)
        same_num(merged_t, merged_j)
        same_oracle(merged_j, want.merge_category(wantb))
        same_num(tnum.merge_category(merged_t, tc), jnum.merge_category(merged_j, jc))
        mr_j = jnum.merge_and_remap(jc, jcb)
        same_num(tnum.merge_and_remap(tc, tcb), mr_j)
        same_oracle(mr_j, want.merge_and_remap(wantb))
        for fn in (tnum.gather_numbers, tnum.gather):
            with pytest.raises(IndexError):
                fn(tc, [0, tc.keys.shape[0]])


@pytest.mark.parametrize("dtype", DTYPES)
def test_numeric_facade_matches_jax(dtype):
    """Every numeric_category method through both facades, nulls given to
    from_numbers as an Arrow bitmask, to the key methods as "is null"."""
    va, mask, _ = seeded(dtype, 48, 1)
    vb, maskb, _ = seeded(dtype, 24, 2)
    with jax.enable_x64(True):
        tc, jc = tnvc.from_numbers(va, mask, device="cpu"), jnvc.from_numbers(va, mask)
        tcb, jcb = tnvc.from_numbers(vb, maskb, device="cpu"), jnvc.from_numbers(vb, maskb)

        def same(t, j):
            assert (t.size(), t.keys_size(), t.keys_type()) == (j.size(), j.keys_size(), j.keys_type())
            assert bits(t.keys(np.empty(t.keys_size(), dtype))) == bits(j.keys(np.empty(j.keys_size(), dtype)))
            assert t.values() == j.values()

        same(tc, jc)
        assert tc.keys_type() == dtype
        assert bits(tc.to_numbers(np.empty(48, dtype))) == bits(jc.to_numbers(np.empty(48, dtype)))
        assert bits(np.asarray(tc.to_numbers(), dtype)) == bits(np.asarray(jc.to_numbers(), dtype))
        assert tc.values(np.zeros(48, np.int32)).tolist() == jc.values(np.zeros(48, np.int32)).tolist()
        assert [tc.value_for_index(i) for i in (0, 5, 47)] == [jc.value_for_index(i) for i in (0, 5, 47)]
        assert bits(tc.gather_numbers([0, 2, 0], np.empty(3, dtype))) == bits(
            jc.gather_numbers([0, 2, 0], np.empty(3, dtype)))
        for k in lookups(va, dtype)[::2]:
            assert tc.value(k) == jc.value(k), k
            out_t, out_j = np.full(48, -7, np.int32), np.full(48, -7, np.int32)
            assert tc.indexes_for_key(k, out_t) == jc.indexes_for_key(k, out_j) and (out_t == out_j).all(), k
            assert tc.indexes_for_key(k) == jc.indexes_for_key(k), k  # the count, not the rows
        extra, extra_null = vb[:10], EXTRA_NULL
        same(tc.add_keys(extra, extra_null), jc.add_keys(extra, extra_null))
        same(tc.remove_keys(extra, extra_null), jc.remove_keys(extra, extra_null))
        same(tc.set_keys(extra, extra_null), jc.set_keys(extra, extra_null))
        same(tc.set_keys(extra).remove_unused_keys(), jc.set_keys(extra).remove_unused_keys())
        same(tc.gather([1, 0, 1]), jc.gather([1, 0, 1]))
        same(tc.gather_and_remap([1, 0, 1]), jc.gather_and_remap([1, 0, 1]))
        same(tc.merge_category(tcb), jc.merge_category(jcb))
        same(tc.merge_and_remap(tcb), jc.merge_and_remap(jcb))


def test_float_key_order_and_signed_zero():
    """NaN after +inf as one key, -0.0 and +0.0 one key whose value is the
    first row's holding either (bitwise), on both packages."""
    # every case six values long (2.0 repeated), so the JAX encode compiles
    # once a dtype
    cases = [[0.0, -0.0, 1.0, np.nan, np.inf, -np.nan], [-0.0, 0.0, 1.0, 2.0, 2.0, 2.0],
             [1.0, -0.0, 0.0, 2.0, 2.0, 2.0], [-np.nan, np.nan, -np.inf, 2.0, 2.0, 2.0]]
    for vals in cases:
        for dtype in (np.float32, np.float64):
            a = np.array(vals, dtype)
            with jax.enable_x64(True):
                j = jnum.from_numbers(a)
            t = tnum.from_numbers(a, device="cpu")
            assert bits(t.keys.numpy()) == bits(np.asarray(j.keys)), vals
            assert t.values.tolist() == np.asarray(j.values).tolist()
    t = tnum.from_numbers(np.array(cases[0]), device="cpu")
    assert np.signbit(t.keys.numpy()).tolist() == [False] * 4
    assert np.signbit(tnum.from_numbers(np.array(cases[2]), device="cpu").keys.numpy()[0])


def test_subnormals_are_keys_of_their_own():
    """+-smallest subnormal, 0.0 and -0.0: three keys in the port, held to
    chip_smoke's numpy oracle (XLA on the CPU flushes subnormals, so the
    JAX package is not the reference here)."""
    for dtype in ("float32", "float64"):
        sub = np.finfo(dtype).smallest_subnormal
        vals = np.array([sub, 0.0, -sub, -0.0, sub, 1.0], dtype)
        t, want = tnum.from_numbers(vals, device="cpu"), CS._NumOracle.encode(vals, np.ones(6, bool))
        assert bits(t.keys.numpy()) == bits(want.keys) and t.keys.shape[0] == 4
        assert t.values.tolist() == want.values.tolist() == [2, 1, 0, 1, 2, 3]
        assert [tnum.value_of(t, k) for k in (-sub, -0.0, sub, 2.0)] == [0, 1, 2, -1]


def test_absent_key_finds_the_removed_rows():
    """For an absent key the numeric indexes_for_key returns the rows whose
    value is -1 (the string version returns none): 2 rows for key 99 after
    remove_keys([3]) on [3, 1, 3, 7]."""
    with jax.enable_x64(True):
        got = [mod.indexes_for_key(mod.remove_keys(mod.from_numbers(np.array([3, 1, 3, 7]), **kw), np.array([3])), 99)
               for mod, kw in ((tnum, {"device": "cpu"}), (jnum, {}))]
    assert got[0].tolist() == np.asarray(got[1]).tolist() == [0, 2]


def test_nulls_as_is_null_arrays_and_bitmask():
    """from_numbers takes an Arrow bitmask (bit set = valid); the key
    methods take bool "is null" arrays."""
    vals = np.array([5, 1, 5, 2], np.int32)
    mask = np.packbits(np.array([1, 0, 1, 1], bool), bitorder="little")
    with jax.enable_x64(True):
        tc, jc = tnvc.from_numbers(vals, mask, device="cpu"), jnvc.from_numbers(vals, mask)
        assert tc.values() == jc.values() == [2, 0, 2, 1]
        assert tc.keys() == jc.keys() == [1, 2, 5]  # the null key holds the value under the null
        added_t, added_j = tc.add_keys([9, 0], np.array([False, True])), jc.add_keys([9, 0], np.array([False, True]))
        assert added_t.keys() == added_j.keys() == [0, 2, 5, 9]
        assert added_t.values() == added_j.values()
        removed = tc.remove_keys([0], np.array([True]))
        assert removed.values() == jc.remove_keys([0], np.array([True])).values() == [1, -1, 1, 0]


# ---------------------------------------------------------------- replays

REPLAYS = {
    "numeric_basic": lambda N: N.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1], np.int32)),
    "numeric_float_keys": lambda N: N.from_numbers(np.array([2, 1, 1.25, 1.5, 1, 1.25, 1, 1, 2])),
    "numeric_to_numbers": lambda N: N.to_numbers(N.from_numbers(np.array([2, 1, 1.25, 1.5, 1, 1.25, 1, 1, 2]))),
    "numeric_indexes_for_key": lambda N: N.indexes_for_key(N.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1])), 1),
    "numeric_gather_numbers": lambda N: N.gather_numbers(N.from_numbers(np.array([1, 1.25, 1.5, 1, 1.25, 1, 1, 2])),
                                                         np.array([0, 2, 0], np.int32)),
    "numeric_nulls": lambda N: N.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1]),
                                              np.array([False, False, True, False, True, False, False, False,
                                                        False])),
    "numeric_algebra": lambda N: _algebra(N),
}


def _algebra(N):
    cat = N.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1], np.int32))
    return (N.add_keys(cat, np.array([5, 1], np.int32)), N.remove_keys(cat, np.array([2], np.int32)),
            N.remove_unused_keys(N.gather(cat, [0, 0, 1])),
            N.merge_and_remap(N.from_numbers(np.array([1, 3], np.int32)), N.from_numbers(np.array([2, 3], np.int32))))


def _out(x):
    if hasattr(x, "keys_valid"):
        return (bits(_out_array(x.keys)), _out(x.keys_valid), _out(x.values))
    if isinstance(x, tuple):
        return tuple(_out(v) for v in x)
    return tuple(np.asarray(x).tolist())


def _out_array(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the port's numeric module with from_numbers on the CPU, so that a case
# reads the same for both packages
T_NUM = types.SimpleNamespace(**{**vars(tnum), "from_numbers": functools.partial(tnum.from_numbers, device="cpu")})


@pytest.mark.parametrize("case", sorted(REPLAYS))
def test_numeric_cases_replayed_on_both_packages(case):
    with jax.enable_x64(True):
        want = _out(REPLAYS[case](jnum))
    assert _out(REPLAYS[case](T_NUM)) == want
