"""nvstrings facade over the port's main-path ops.

Port of the entry points of `custrings_tpu/nvstrings.py` that the slice
runs: `to_device`, `to_host`, `size`, `contains` and `replace`.  The rest
of the ~95 methods follow the ROADMAP's queue 1.
"""

from __future__ import annotations

from . import column as _col
from .ops import modify as _modify
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
        res = _rx.contains_re(self._col, pat).cpu().tolist()
        vals = self._col.validity.cpu().tolist()
        return [b if v else None for b, v in zip(res, vals)]

    def replace(self, pat, repl, n=-1, regex=True):
        """Replace occurrences of `pat` with `repl` in each row."""
        if regex:
            raise NotImplementedError(
                "regex replace (replace_re and the span kernel K5) is not "
                "ported yet: ROADMAP queue 1"
            )
        return nvstrings(_modify.replace_literal(self._col, pat, repl, n))


def to_device(strs, device="cuda"):
    """nvstrings from a list of Python str / None on `device`; raises
    where that device is missing."""
    return nvstrings(_col.from_host_strings(strs, device))
