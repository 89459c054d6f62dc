"""Numeric dictionary encoding: the numeric_category core.

Port of `custrings_tpu/numeric.py` (cpp/src/category/numeric_category.inl,
instantiated for int8, int32, int64, float32 and float64): the keys are
the sorted unique values, each row's value the index of its key.  Order:
the null key first (its value is the least value under a null), then the
values; every NaN is one key after +inf, and -0.0 and +0.0 are one key
whose value is that of the first row holding either.

Torch has no uint64 and no lexsort, so each number is mapped to an int64
with the same order (`_ord_key`), rows are ordered by stable single-key
sorts, least significant key first, and ranked by a K3 scan; lookups are
`torch.searchsorted` over the mapped keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .category import appended_values, checked_indexes, remap_values, used_keys
from .column import _device
from .ops import segments
from .ops.array import lsd_order

_INT64_MAX = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class NumericCategory:
    keys: torch.Tensor  # unique values, sorted unless merge_category appended
    keys_valid: torch.Tensor  # bool[K]; False marks the null key
    values: torch.Tensor  # int32[rows]; -1 = unmapped


def _as_values(x, device, dtype=None) -> torch.Tensor:
    """A 1-D tensor of host numbers (numpy or a list) or a tensor on
    `device`, cast to `dtype` where one is given.  Host numbers are cast by
    numpy, as the JAX package's jnp.asarray casts them: a Python int
    outside the dtype's range raises OverflowError instead of wrapping."""
    if isinstance(x, torch.Tensor):
        return x.to(device) if dtype is None else x.to(device, dtype)
    np_dtype = None if dtype is None else torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np_dtype))).to(device)


def _is_null_mask(nulls, n: int, device) -> torch.Tensor:
    """bool[n] "is null" from None or a bool array."""
    if nulls is None:
        return torch.zeros(n, dtype=torch.bool, device=device)
    return _as_values(nulls, device, torch.bool)


def _ord_key(x: torch.Tensor) -> torch.Tensor:
    """int64 with the order of the numbers: ints widen; a float's bits,
    with every NaN made one positive NaN and -0.0 made +0.0, are read as a
    signed integer and the negatives' magnitude bits flipped."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        return torch.where(b < 0, b ^ _INT64_MAX, b)
    b = x.to(torch.float32).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def _from_tensor(arr: torch.Tensor, isnull: torch.Tensor) -> NumericCategory:
    n, dev = arr.shape[0], arr.device
    valid = ~isnull
    if n == 0:
        return NumericCategory(arr, valid, torch.zeros(0, dtype=torch.int32, device=dev))
    key = _ord_key(arr)
    order = lsd_order([valid.to(torch.int64), key])
    skey, svalid = key[order], valid[order]
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    neq[1:] = ((skey[1:] != skey[:-1]) | (svalid[1:] != svalid[:-1])) & (svalid[1:] | svalid[:-1])
    ranks = segments.cumsum(neq)
    values = torch.zeros(n, dtype=torch.int32, device=dev)
    values[order] = ranks
    first = neq.clone()
    first[0] = True
    key_rows = order[first]
    return NumericCategory(arr[key_rows], valid[key_rows], values)


def from_numbers(narr, nulls=None, *, device) -> NumericCategory:
    """Category of the numbers on `device`; `nulls` a bool "is null" array."""
    arr = _as_values(narr, _device(device))
    return _from_tensor(arr, _is_null_mask(nulls, arr.shape[0], arr.device))


def to_numbers(cat: NumericCategory, narep=0) -> torch.Tensor:
    """Each row's key; `narep` for a row whose key was removed."""
    if cat.keys.shape[0] == 0:
        return torch.full(cat.values.shape, narep, dtype=cat.keys.dtype, device=cat.keys.device)
    out = cat.keys[cat.values.clamp(0, cat.keys.shape[0] - 1).to(torch.int64)]
    return torch.where(cat.values >= 0, out, torch.full_like(out, narep))


def gather_numbers(cat: NumericCategory, indexes) -> torch.Tensor:
    idx = checked_indexes(indexes, cat.keys.shape[0], "gather_numbers")
    return cat.keys[torch.from_numpy(idx).to(cat.keys.device, torch.int64)]


def value_of(cat: NumericCategory, key) -> int:
    """Index of the key, -1 if absent (a NaN key on integer keys too)."""
    if cat.keys.shape[0] == 0:
        return -1
    if isinstance(key, float) and np.isnan(key) and not cat.keys.is_floating_point():
        return -1
    q = _as_values([key], cat.keys.device, cat.keys.dtype)
    return int(_searchsorted(cat.keys, cat.keys_valid, q, torch.ones(1, dtype=torch.bool, device=q.device))[0])


def indexes_for_key(cat: NumericCategory, key) -> torch.Tensor:
    """int32 rows whose value is value_of(key): for an absent key, the rows
    whose key was removed (-1)."""
    v = value_of(cat, key)
    return torch.nonzero(cat.values == v).flatten().to(torch.int32)


def _searchsorted(keys, keys_valid, queries, q_valid) -> torch.Tensor:
    """int32: index of each query in keys (any order) or -1.  NaN matches
    NaN, -0.0 matches +0.0; a null query maps to the first null key."""
    K, Q = keys.shape[0], queries.shape[0]
    if K == 0 or Q == 0:
        return torch.full((Q,), -1, dtype=torch.int32, device=queries.device)
    mk, mq = _ord_key(keys), _ord_key(queries)
    kv = keys_valid.to(torch.bool)
    idx_s = lsd_order([(~kv).to(torch.int64), mk])
    mk_s = mk[idx_s]
    nvalid = int(kv.sum())
    # the null keys sort last; raise them so they never shadow the search
    searchable = torch.where(torch.arange(K, device=keys.device) < nvalid, mk_s, _INT64_MAX)
    pos = torch.searchsorted(searchable, mq, side="left")
    posc = pos.clamp(max=K - 1)
    found = torch.where((pos < nvalid) & (mk_s[posc] == mq), idx_s[posc], -1)
    first_null = int(idx_s[nvalid]) if nvalid < K else -1
    return torch.where(q_valid.to(torch.bool), found, first_null).to(torch.int32)


def _remap(cat: NumericCategory, nk, nkv) -> torch.Tensor:
    """Values under a new keyset: old value -> old key -> new index or -1."""
    return remap_values(cat.values, _searchsorted(nk, nkv, cat.keys, cat.keys_valid))


def _unique_sorted(arr: torch.Tensor, isnull: torch.Tensor):
    sub = _from_tensor(arr, isnull)
    return sub.keys, sub.keys_valid


def _kept(cat: NumericCategory, keep: torch.Tensor) -> NumericCategory:
    rows = torch.nonzero(keep).flatten()
    nk, nkv = cat.keys[rows], cat.keys_valid[rows]
    return NumericCategory(nk, nkv, _remap(cat, nk, nkv))


def add_keys(cat: NumericCategory, keys, nulls=None) -> NumericCategory:
    """The keyset with `keys` added, sorted again; `nulls` a bool "is
    null" array."""
    add = _as_values(keys, cat.keys.device, cat.keys.dtype)
    ka = torch.cat([cat.keys, add])
    kv = torch.cat([cat.keys_valid, ~_is_null_mask(nulls, add.shape[0], add.device)])
    nk, nkv = _unique_sorted(ka, ~kv)
    return NumericCategory(nk, nkv, _remap(cat, nk, nkv))


def remove_keys(cat: NumericCategory, keys, nulls=None) -> NumericCategory:
    """The keyset without `keys`; their rows become -1."""
    q = _as_values(keys, cat.keys.device, cat.keys.dtype)
    hit = _searchsorted(cat.keys, cat.keys_valid, q, ~_is_null_mask(nulls, q.shape[0], q.device))
    drop = torch.zeros(cat.keys.shape[0], dtype=torch.bool, device=cat.keys.device)
    drop[hit[hit >= 0].to(torch.int64)] = True
    return _kept(cat, ~drop)


def remove_unused_keys(cat: NumericCategory) -> NumericCategory:
    return _kept(cat, used_keys(cat.values, cat.keys.shape[0]))


def set_keys(cat: NumericCategory, keys, nulls=None) -> NumericCategory:
    """The unique sorted `keys` as the keyset; rows of other keys become -1."""
    k = _as_values(keys, cat.keys.device, cat.keys.dtype)
    nk, nkv = _unique_sorted(k, _is_null_mask(nulls, k.shape[0], k.device))
    return NumericCategory(nk, nkv, _remap(cat, nk, nkv))


def gather(cat: NumericCategory, indexes) -> NumericCategory:
    idx = checked_indexes(indexes, cat.keys.shape[0], "gather")
    return NumericCategory(cat.keys, cat.keys_valid, torch.from_numpy(idx).to(cat.values.device))


def gather_and_remap(cat: NumericCategory, indexes) -> NumericCategory:
    return remove_unused_keys(gather(cat, indexes))


def merge_category(cat: NumericCategory, other: NumericCategory) -> NumericCategory:
    """Append-preserving merge, as the string category's: other's new keys
    follow this keyset in other's order."""
    o2c = _searchsorted(cat.keys, cat.keys_valid, other.keys, other.keys_valid)
    new_idx = torch.nonzero(o2c < 0).flatten()
    nk = torch.cat([cat.keys, other.keys[new_idx]])
    nkv = torch.cat([cat.keys_valid, other.keys_valid[new_idx]])
    return NumericCategory(nk, nkv, torch.cat([cat.values, appended_values(other.values, o2c, cat.keys.shape[0])]))


def merge_and_remap(cat: NumericCategory, other: NumericCategory) -> NumericCategory:
    """The sorted union of both keysets, both value columns remapped."""
    ka = torch.cat([cat.keys, other.keys.to(cat.keys.dtype)])
    kv = torch.cat([cat.keys_valid, other.keys_valid])
    nk, nkv = _unique_sorted(ka, ~kv)
    return NumericCategory(nk, nkv, torch.cat([_remap(cat, nk, nkv), _remap(other, nk, nkv)]))
