"""nvstrings facade over the port's ops.

Port of the entry points of `custrings_tpu/nvstrings.py` that the ported
ops serve: `to_device`, `to_host`, `size`, `contains` (regex or literal),
`match`, `count`, `findall`, `findall_record`, `hash`, `replace` (literal
of any length, or regex for certified span programs), `join`,
`split_record`, `split`, `rsplit_record` and `rsplit` (on a delimiter or
on whitespace), `partition` and `rpartition`.  Return shapes are the JAX
facade's.  The rest of the ~95 methods follow the ROADMAP's queue 1.
"""

from __future__ import annotations

import functools

import torch

from . import column as _col
from .ops import combine as _combine
from .ops import find as _find
from .ops import hash as _hash
from .ops import modify as _modify
from .ops import split as _split
from .ops.substr import _span_column
from .regex import ops as _rx


class nvstrings:
    """A column of strings on one device."""

    def __init__(self, col: _col.StringColumn):
        self._col = col

    def __repr__(self):
        return f"<custrings_tpu_torch.nvstrings count={self.size()} device={self._col.device}>"

    def __len__(self):
        return self._col.size

    def to_host(self):
        return _col.to_host_strings(self._col)

    def size(self):
        return self._col.size

    def contains(self, pat, regex=True):
        """Per row: does `pat` occur (None for null rows)."""
        if not regex:
            return self._masked(_find.contains(self._col, pat))
        return self._masked(_rx.contains_re(self._col, pat))

    def match(self, pat):
        """Per row: does `pat` match at its start (None for null rows)."""
        return self._masked(_rx.match_re(self._col, pat))

    def hash(self):
        """Per row: MurmurHash3_32 (seed 31) of its bytes, as a Python int
        (None for null rows)."""
        return self._masked(_hash.hash_mm3(self._col))

    def _masked(self, res):
        vals = self._col.validity.cpu().tolist()
        return [b if v else None for b, v in zip(res.cpu().tolist(), vals)]

    def count(self, pat):
        """Per row: the number of non-overlapping matches (0 for null rows)."""
        return _rx.count_re(self._col, pat).cpu().tolist()

    def findall(self, pat):
        """nvstrings i holds each row's i-th match (null where none)."""
        return [nvstrings(c) for c in _rx.findall_columns(self._col, pat)]

    def findall_record(self, pat):
        """Per row: an nvstrings of its matches (None for null rows)."""
        return _records(_rx.findall_record(self._col, pat))

    def replace(self, pat, repl, n=-1, regex=True):
        """Replace occurrences of `pat` with `repl` in each row."""
        if regex:
            return nvstrings(_rx.replace_re(self._col, pat, repl, n))
        return nvstrings(_modify.replace_literal(self._col, pat, repl, n))

    def join(self, sep=""):
        """The whole column as one string, the rows joined by `sep` (null
        rows skipped)."""
        return nvstrings(_combine.join(self._col, sep))

    def split_record(self, delimiter=None, n=-1):
        """Per row: an nvstrings of its tokens (None for null rows); on
        whitespace runs when `delimiter` is None."""
        return _records(_split.split_record(self._col, delimiter, n))

    def rsplit_record(self, delimiter=None, n=-1):
        """split_record with the limit n applied from the right."""
        return _records(_split.rsplit_record(self._col, delimiter, n))

    def split(self, delimiter=None, n=-1):
        """nvstrings i holds each row's i-th token (null where none)."""
        return [nvstrings(c) for c in _split.split_columns(self._col, delimiter, n)]

    def rsplit(self, delimiter=None, n=-1):
        """split with the limit n applied from the right."""
        return [nvstrings(c) for c in _split.rsplit_columns(self._col, delimiter, n)]

    def partition(self, delimiter=" "):
        """Per row: an nvstrings [before, delimiter, after] of its first
        occurrence."""
        return _transpose_records(_split.partition(self._col, delimiter))

    def rpartition(self, delimiter=" "):
        """Per row: an nvstrings [before, delimiter, after] of its last
        occurrence."""
        return _transpose_records(_split.rpartition(self._col, delimiter))


class _Row(nvstrings):
    """One row of a record op's result (split_record, findall_record,
    partition, ...): its strings, read back with every other row's in one
    batch.  The CPU column behind them is built at its first use, so a
    caller that reads the strings never pays for a column a row."""

    def __init__(self, strs):
        self._strs = strs

    @functools.cached_property
    def _col(self):
        return _col.from_host_strings(self._strs, "cpu")

    def __len__(self):
        return len(self._strs)

    def size(self):
        return len(self._strs)

    def to_host(self):
        return list(self._strs)


def _records(tc):
    """TokenColumn -> list of per-row nvstrings (None for null rows), from
    one batched copy of the tokens to the host."""
    toks = _col.to_host_strings(tc.tokens)
    row_off = tc.row_offsets.cpu().tolist()
    return [_Row(toks[row_off[i] : row_off[i + 1]]) if ok else None
            for i, ok in enumerate(tc.row_validity.cpu().tolist())]


def _transpose_records(cols):
    """Columns of equal size -> per row, an nvstrings of that row of each
    column (partition, rpartition): the columns' rows interleaved into one
    column on the device, then cut into records as split_record's are."""
    n, k, dev = cols[0].size, len(cols), cols[0].device
    shift = torch.tensor([0] + [c.capacity for c in cols[:-1]], device=dev).cumsum(0)
    starts = torch.stack([c.offsets[:-1] for c in cols], 1) + shift.to(torch.int32)
    sizes = torch.stack([c.lengths() for c in cols], 1)
    valid = torch.stack([c.validity for c in cols], 1)
    rows = _span_column(torch.cat([c.data for c in cols]), starts.flatten(), sizes.flatten(), valid.flatten())
    step = torch.arange(n + 1, dtype=torch.int32, device=dev) * k
    return _records(_split.TokenColumn(rows, step, torch.ones(n, dtype=torch.bool, device=dev)))


def to_device(strs, device="cuda"):
    """nvstrings from a list of Python str / None on `device`; raises
    where that device is missing."""
    return nvstrings(_col.from_host_strings(strs, device))
