"""nvcategory facade: dictionary encode of a string column.

Port of `from_strings` and the `keys` / `values` / `keys_size` / `size`
accessors of `custrings_tpu/nvcategory.py`, with `category.from_strings`
folded in: a category is the sorted unique keys plus each row's key rank.
The keyset algebra (add/remove/set/merge) is ROADMAP queue 1, item 2.
"""

from __future__ import annotations

from .nvstrings import nvstrings
from .ops.unique import dictionary_encode


class nvcategory:
    def __init__(self, keys, values):
        self._keys = keys  # StringColumn, sorted unique
        self._values = values  # int32[rows]

    def __repr__(self):
        return f"<custrings_tpu_torch.nvcategory keys={self.keys_size()} size={self.size()}>"

    def size(self):
        return int(self._values.shape[0])

    def keys_size(self):
        return self._keys.size

    def keys(self):
        return nvstrings(self._keys)

    def values(self):
        return self._values.cpu().tolist()


def from_strings(strs: nvstrings) -> nvcategory:
    """Category of one nvstrings instance."""
    return nvcategory(*dictionary_encode(strs._col))
