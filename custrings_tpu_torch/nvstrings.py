"""nvstrings facade over the port's ops.

Port of the entry points of `custrings_tpu/nvstrings.py` that the ported
ops serve: `to_device`, `to_host`, `size`, `contains`, `match`, `count`,
`findall`, `findall_record`, `hash`, `replace` (literal of any length, or
regex for certified span programs), `split_record` and `split` (with a
delimiter).  Return shapes are the JAX facade's.  The rest of the ~95
methods follow the ROADMAP's queue 1.
"""

from __future__ import annotations

import torch

from . import column as _col
from .ops import hash as _hash
from .ops import modify as _modify
from .ops import split as _split
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
            raise NotImplementedError(
                "literal contains (ops/find.py) is not ported yet: ROADMAP queue 1"
            )
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

    def split_record(self, delimiter=None, n=-1):
        """Per row: an nvstrings of its tokens (None for null rows)."""
        return _records(_split.split_record(self._col, delimiter, n))

    def split(self, delimiter=None, n=-1):
        """nvstrings i holds each row's i-th token (null where none)."""
        return [nvstrings(c) for c in _split.split_columns(self._col, delimiter, n)]


def _records(tc):
    """TokenColumn -> list of per-row nvstrings (None for null rows).  One
    batched copy of the tokens to the host; each row's nvstrings is a
    column of CPU tensors sliced from it."""
    toks = tc.tokens
    data = toks.data.cpu()
    offs = toks.offsets.cpu().numpy()
    offs_l = offs.tolist()
    val = toks.validity.cpu()
    row_off = tc.row_offsets.cpu().tolist()
    out = []
    for i, ok in enumerate(tc.row_validity.cpu().tolist()):
        if not ok:
            out.append(None)
            continue
        a, b = row_off[i], row_off[i + 1]
        lo = offs_l[a]
        o = torch.from_numpy(offs[a : b + 1] - lo)
        out.append(nvstrings(_col.StringColumn(data[lo : offs_l[b]], o, val[a:b])))
    return out


def to_device(strs, device="cuda"):
    """nvstrings from a list of Python str / None on `device`; raises
    where that device is missing."""
    return nvstrings(_col.from_host_strings(strs, device))
