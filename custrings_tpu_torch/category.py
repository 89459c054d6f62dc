"""String dictionary encoding: the nvcategory core.

Port of `custrings_tpu/category.py`.  A Category is the keys (a
StringColumn, sorted and unique unless a merge_category appended to them)
and each row's value, int32, the index of its key; -1 marks a row whose
key was removed, and to_strings makes it a null row.  The build is the
encode of `ops/unique.py`; the keyset algebra (add, remove, set, merge) is
set operations on key tables: a lookup of each old key in the new keyset
(`searchsorted_keys`, K1b key words), then a gather of the values.
Index compaction stays on the device (`torch.nonzero`, K3 scans).  The
lookups and the encode are called through `ops.unique`'s module
attributes, so per-op tracing sees them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .column import StringColumn, from_host_strings
from .ops import array as array_ops
from .ops import layout, segments, unique
from .ops.split import _mask_column


@dataclasses.dataclass(frozen=True)
class Category:
    keys: StringColumn
    values: torch.Tensor  # int32[rows]; -1 = unmapped
    # merge_category appends the other keyset's new keys after this one's,
    # so a keyset can be unsorted; lookups then sort it first
    sorted_keys: bool = True

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @property
    def keys_size(self) -> int:
        return self.keys.size


def _lookup(keys: StringColumn, queries: StringColumn, keys_sorted: bool) -> torch.Tensor:
    """Index of each query in `keys` (-1 absent), for any keyset order."""
    if keys_sorted:
        return unique.searchsorted_keys(keys, queries)
    width = max(-(-layout.max_row_bytes(keys) // 4) * 4, 4)
    order = array_ops._order_impl(keys, width, array_ops.SORT_NAME, True, True)
    pos = unique.searchsorted_keys(array_ops.gather(keys, order), queries)
    return torch.where(pos >= 0, order[pos.clamp(0, max(keys.size - 1, 0)).to(torch.int64)], -1).to(torch.int32)


def checked_indexes(indexes, bound: int, what: str) -> np.ndarray:
    """Host int32 indexes; IndexError unless every one lies in [0, bound)."""
    idx = np.asarray(indexes.cpu() if isinstance(indexes, torch.Tensor) else indexes)
    if idx.size and (idx.min() < 0 or idx.max() >= bound):
        raise IndexError(f"{what}: index out of range")
    return idx.astype(np.int32)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int32)).to(device)


# The value side of the keyset algebra, shared with numeric.py: each takes
# the key lookup's result, so only the lookup differs between the two.


def remap_values(values: torch.Tensor, old_to_new: torch.Tensor) -> torch.Tensor:
    """Each row's value under a new keyset, old_to_new[value]; -1 stays -1."""
    if old_to_new.shape[0] == 0:
        return torch.full_like(values, -1)
    safe = values.clamp(0, old_to_new.shape[0] - 1).to(torch.int64)
    return torch.where(values >= 0, old_to_new[safe], -1).to(torch.int32)


def used_keys(values: torch.Tensor, nkeys: int) -> torch.Tensor:
    """bool[nkeys]: the keys some row's value names."""
    used = torch.zeros(nkeys, dtype=torch.bool, device=values.device)
    used[values[values >= 0].to(torch.int64)] = True
    return used


def appended_values(values: torch.Tensor, found: torch.Tensor, base: int) -> torch.Tensor:
    """merge_category's values for the other category: a key found in this
    keyset (found >= 0) keeps its index there, and a new key gets `base`
    plus its rank among the new keys, which are appended in order."""
    new = found < 0
    return remap_values(values, torch.where(new, base + segments.cumsum(new) - 1, found))


def from_strings(*cols: StringColumn) -> Category:
    col = cols[0] if len(cols) == 1 else array_ops.append(list(cols))
    return Category(*unique.dictionary_encode(col))


def from_value_array(keys: StringColumn, values) -> Category:
    if isinstance(values, torch.Tensor):
        return Category(keys, values.to(keys.device, torch.int32))
    return Category(keys, _index(values, keys.device))


def to_strings(cat: Category) -> StringColumn:
    """Each row's key (NVCategory.cu to_strings:977); -1 gives a null row."""
    idx = cat.values.clamp(0, max(cat.keys_size - 1, 0))
    out = array_ops.gather(cat.keys, idx)
    return _mask_column(out, out.validity & (cat.values >= 0))


def gather_strings(cat: Category, indexes) -> StringColumn:
    idx = checked_indexes(indexes, cat.keys_size, "gather_strings")
    return array_ops.gather(cat.keys, _index(idx, cat.keys.device))


def gather(cat: Category, indexes) -> Category:
    """The same keyset with values = indexes (NVCategory.cu:1142)."""
    idx = checked_indexes(indexes, cat.keys_size, "gather")
    return Category(cat.keys, _index(idx, cat.keys.device), cat.sorted_keys)


def gather_and_remap(cat: Category, indexes) -> Category:
    """gather, then drop the unused keys (NVCategory.cu:1084)."""
    return remove_unused_keys(gather(cat, indexes))


def value_for_index(cat: Category, idx: int) -> int:
    return int(cat.values[idx])


def value_of(cat: Category, key: str | None) -> int:
    """Index of key in the keyset, -1 if absent (NVCategory.cu:766)."""
    q = from_host_strings([key], cat.keys.device)
    return int(_lookup(cat.keys, q, cat.sorted_keys)[0])


def get_value_bounds(cat: Category, key: str | None) -> tuple[int, int]:
    """(v, v) when the key is present, else (p - 1, p) with p the first
    position whose key is not less than it, walking the keyset in its own
    order (NVCategory.cu get_value_bounds:795)."""
    v = value_of(cat, key)
    if v >= 0:
        return (v, v)
    pos = int(unique.first_not_less(cat.keys, from_host_strings([key], cat.keys.device)))
    return (pos - 1, pos)


def indexes_for_key(cat: Category, key: str | None) -> torch.Tensor:
    """int32 rows holding the key; none for an absent key (-1 would also
    match every row whose key was removed)."""
    v = value_of(cat, key)
    if v < 0:
        return torch.zeros(0, dtype=torch.int32, device=cat.values.device)
    return torch.nonzero(cat.values == v).flatten().to(torch.int32)


def add_strings(cat: Category, strs: StringColumn) -> Category:
    """The rows and strs' rows after them, encoded again (NVCategory.cu:926)."""
    return from_strings(array_ops.append([to_strings(cat), strs]))


def remove_strings(cat: Category, strs: StringColumn) -> Category:
    """The rows equal to none of strs, encoded again (NVCategory.cu:942)."""
    rows = to_strings(cat)
    hit = unique.searchsorted_keys(unique.unique_strings(strs), rows) >= 0
    return from_strings(array_ops.gather(rows, torch.nonzero(~hit).flatten()))


def _remap_values(cat: Category, new_keys: StringColumn, new_sorted: bool = True) -> torch.Tensor:
    """Values under a new keyset: old value -> old key -> new index or -1."""
    if cat.keys_size == 0:
        return torch.full_like(cat.values, -1)
    return remap_values(cat.values, _lookup(new_keys, cat.keys, new_sorted))


def _kept_keys(cat: Category, keep: torch.Tensor) -> Category:
    new_keys = array_ops.gather(cat.keys, torch.nonzero(keep).flatten())
    return Category(new_keys, _remap_values(cat, new_keys, cat.sorted_keys), cat.sorted_keys)


def add_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu add_keys_and_remap:1375)"""
    new_keys = unique.unique_strings(array_ops.append([cat.keys, keys]))
    return Category(new_keys, _remap_values(cat, new_keys))


def remove_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu remove_keys_and_remap:1482); their rows become -1."""
    return _kept_keys(cat, unique.searchsorted_keys(unique.unique_strings(keys), cat.keys) < 0)


def remove_unused_keys(cat: Category) -> Category:
    """(NVCategory.cu remove_unused_keys_and_remap:1567)"""
    return _kept_keys(cat, used_keys(cat.values, cat.keys_size))


def set_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu set_keys_and_remap:1708)"""
    new_keys = unique.unique_strings(keys)
    return Category(new_keys, _remap_values(cat, new_keys))


def merge_and_remap(cat: Category, other: Category) -> Category:
    """The sorted union of both keysets, both value columns remapped to it
    (NVCategory.cu merge_and_remap:1339)."""
    new_keys = unique.unique_strings(array_ops.append([cat.keys, other.keys]))
    return Category(new_keys, torch.cat([_remap_values(cat, new_keys), _remap_values(other, new_keys)]))


def merge_category(cat: Category, other: Category) -> Category:
    """Append-preserving merge (NVCategory.cu merge_category:1223): this
    keyset keeps its positions and other's new keys follow in other's
    order, so the keyset may be unsorted."""
    in1 = _lookup(cat.keys, other.keys, cat.sorted_keys)
    new_idx = torch.nonzero(in1 < 0).flatten()
    new_keys = array_ops.append([cat.keys, array_ops.gather(other.keys, new_idx)])
    return Category(new_keys, torch.cat([cat.values, appended_values(other.values, in1, cat.keys_size)]),
                    sorted_keys=cat.sorted_keys and new_idx.shape[0] == 0)
