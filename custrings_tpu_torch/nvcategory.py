"""nvcategory facade: string and numeric dictionary encoding.

Port of `custrings_tpu/nvcategory.py`: the `nvcategory` class (all 24
methods of the JAX facade: sizes, keys and values, value lookups and
bounds, row adds and removes, gathers, the keyset algebra and both merges)
over `category.py`, the `numeric_category` class (its 18 methods) over
`numeric.py`, and the module functions `to_device`, `from_strings`,
`from_strings_list`, `from_offsets`, `from_numbers` (Arrow bitmask nulls)
and `bind_cpointer` (raises).  Return shapes are the JAX facade's.  A
function that makes a category from host data takes `device`, "cuda" by
default, and raises where that device is missing.
"""

from __future__ import annotations

import numpy as np

from . import category as _cat
from . import column as _col
from . import numeric as _num
from .nvstrings import nvstrings


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _fill_or_list(out: np.ndarray, narr):
    """Copy into `narr` and return it where it is a numpy array, else a
    list."""
    if isinstance(narr, np.ndarray):
        narr[: len(out)] = out
        return narr
    return out.tolist()


class nvcategory:
    """Sorted unique keys of a string column and each row's key index."""

    def __init__(self, cat: _cat.Category):
        self._cat = cat

    def __repr__(self):
        return f"<custrings_tpu_torch.nvcategory keys={self.keys_size()} size={self.size()}>"

    def size(self):
        return self._cat.size

    def keys_size(self):
        return self._cat.keys_size

    def keys(self, narr=None):
        return nvstrings(self._cat.keys)

    def keys_type(self):
        return "str"

    def get_cpointer(self):
        """No C++ instance stands behind a category here: 0."""
        return 0

    def values_cpointer(self):
        """Device address of the int32 values."""
        return self._cat.values.data_ptr()

    def has_nulls(self):
        """True when the keyset holds the null key."""
        return bool((~self._cat.keys.validity).any())

    def indexes_for_key(self, key, devptr=0):
        """Rows holding `key` as a list; with a numpy array, the rows are
        written into it and their count returned."""
        idx = _host(_cat.indexes_for_key(self._cat, key))
        if isinstance(devptr, np.ndarray):
            devptr[: len(idx)] = idx
            return len(idx)
        return idx.tolist()

    def value_for_index(self, idx):
        return _cat.value_for_index(self._cat, idx)

    def value(self, str):
        return _cat.value_of(self._cat, str)

    def get_value_bounds(self, str):
        return _cat.get_value_bounds(self._cat, str)

    def values(self, devptr=0):
        return _fill_or_list(_host(self._cat.values), devptr)

    def add_strings(self, nvs):
        return nvcategory(_cat.add_strings(self._cat, nvs._col))

    def remove_strings(self, nvs):
        return nvcategory(_cat.remove_strings(self._cat, nvs._col))

    def to_strings(self):
        return nvstrings(_cat.to_strings(self._cat))

    def gather_strings(self, indexes, count=0):
        return nvstrings(_cat.gather_strings(self._cat, indexes))

    def gather_and_remap(self, indexes, count=0):
        return nvcategory(_cat.gather_and_remap(self._cat, indexes))

    def gather(self, indexes, count=0):
        return nvcategory(_cat.gather(self._cat, indexes))

    def merge_category(self, cat2):
        return nvcategory(_cat.merge_category(self._cat, cat2._cat))

    def merge_and_remap(self, cat2):
        return nvcategory(_cat.merge_and_remap(self._cat, cat2._cat))

    def _keys_column(self, keys):
        if isinstance(keys, nvstrings):
            return keys._col
        return _col.from_host_strings(keys, self._cat.keys.device)

    def add_keys(self, keys, nulls=None):
        return nvcategory(_cat.add_keys(self._cat, self._keys_column(keys)))

    def remove_keys(self, keys, nulls=None):
        return nvcategory(_cat.remove_keys(self._cat, self._keys_column(keys)))

    def remove_unused_keys(self):
        return nvcategory(_cat.remove_unused_keys(self._cat))

    def set_keys(self, keys, nulls=None):
        return nvcategory(_cat.set_keys(self._cat, self._keys_column(keys)))


class numeric_category:
    """Sorted unique keys of a numeric column and each row's key index.
    The key methods take `nulls` as a bool "is null" array."""

    def __init__(self, cat: _num.NumericCategory):
        self._cat = cat

    def __repr__(self):
        return f"<custrings_tpu_torch.numeric_category keys={self.keys_size()} size={self.size()}>"

    def size(self):
        return int(self._cat.values.shape[0])

    def keys_size(self):
        return int(self._cat.keys.shape[0])

    def keys(self, narr=None):
        return _fill_or_list(_host(self._cat.keys), narr)

    def keys_type(self):
        """The keys' numpy dtype name."""
        return str(_host(self._cat.keys).dtype)

    def values(self, devptr=0):
        return _fill_or_list(_host(self._cat.values), devptr)

    def value_for_index(self, idx):
        return int(self._cat.values[idx])

    def value(self, key):
        return _num.value_of(self._cat, key)

    def indexes_for_key(self, key, idxs=None):
        """The COUNT of rows holding `key` without an array (the JAX
        facade's return), the rows written into a numpy array and their
        count with one, the rows themselves with anything else."""
        out = _host(_num.indexes_for_key(self._cat, key))
        if isinstance(idxs, np.ndarray):
            idxs[: len(out)] = out
        return len(out) if idxs is None or isinstance(idxs, np.ndarray) else out

    def to_numbers(self, narr=None, nulls=None):
        return _fill_or_list(_host(_num.to_numbers(self._cat)), narr)

    def gather_numbers(self, indexes, narr=None, nulls=None):
        return _fill_or_list(_host(_num.gather_numbers(self._cat, indexes)), narr)

    def add_keys(self, keys, nulls=None):
        return numeric_category(_num.add_keys(self._cat, keys, nulls))

    def remove_keys(self, keys, nulls=None):
        return numeric_category(_num.remove_keys(self._cat, keys, nulls))

    def remove_unused_keys(self):
        return numeric_category(_num.remove_unused_keys(self._cat))

    def set_keys(self, keys, nulls=None):
        return numeric_category(_num.set_keys(self._cat, keys, nulls))

    def gather(self, indexes, count=0):
        return numeric_category(_num.gather(self._cat, indexes))

    def gather_and_remap(self, indexes, count=0):
        return numeric_category(_num.gather_and_remap(self._cat, indexes))

    def merge_category(self, cat2):
        return numeric_category(_num.merge_category(self._cat, cat2._cat))

    def merge_and_remap(self, cat2):
        return numeric_category(_num.merge_and_remap(self._cat, cat2._cat))


def to_device(strs, device="cuda"):
    """Category of a list of Python str / None on `device`.  A nested list
    raises TypeError, as in the JAX package."""
    if strs and isinstance(strs[0], list):
        raise TypeError("to_device takes a list of str / None, not a list of lists")
    return nvcategory(_cat.from_strings(_col.from_host_strings(strs, device)))


def from_strings(*args):
    """Category of the rows of the given nvstrings, in turn."""
    return nvcategory(_cat.from_strings(*[a._col for a in args]))


def from_strings_list(list_, device="cuda"):
    """Category of the rows of a list of nvstrings or host lists."""
    cols = [a._col if isinstance(a, nvstrings) else _col.from_host_strings(a, device) for a in list_]
    return nvcategory(_cat.from_strings(*cols))


def from_offsets(sbuf, obuf, scount, nbuf=None, ncount=0, bdevmem=False, device="cuda"):
    """Category of Arrow host buffers: bytes, scount + 1 int32 offsets and
    an optional null bitmask (bit set = valid)."""
    return nvcategory(_cat.from_strings(_col.from_offsets_np(sbuf, obuf, scount, nbuf, device=device)))


def from_numbers(narr, nulls=None, device="cuda"):
    """numeric_category of host numbers; `nulls` an Arrow little-endian
    bitmask with a bit set for a valid row."""
    arr = np.asarray(narr)
    isnull = None
    if nulls is not None:
        bits = np.unpackbits(np.asarray(nulls).view(np.uint8).ravel(), bitorder="little")[: len(arr)]
        isnull = ~bits.astype(bool)
    return numeric_category(_num.from_numbers(arr, isnull, device=device))


def bind_cpointer(cptr, own=True):
    raise NotImplementedError("a category is not bound to a raw C++ instance pointer")
