"""lstrip / rstrip / strip.

Port of `custrings_tpu/ops/strip.py` (strip.cu lstrip:30, strip:87,
rstrip:144).  The default set is " \\n\\t" exactly, as in the reference
(custring_view::lstrip), not `str.strip`'s whitespace.  Each row's first
and last char outside the set come from one prefix count of those chars
over the char domain (K3) and two binary searches in it; the rows are
then byte-sliced (`substr._slice_bytes`).
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0
from . import layout, substr


def _strip_window(col: StringColumn, to_strip, left: bool, right: bool):
    """(start, stop) char positions of each row after stripping."""
    cm = layout.char_map(col)
    nch = cm.nchars()
    cps = layout.codepoints(col)
    member = torch.zeros(cps.shape[0], dtype=torch.bool, device=col.device)
    for ch in set(" \n\t" if to_strip is None else to_strip):
        member |= cps == ord(ch)
    c = torch.arange(cps.shape[0], dtype=torch.int32, device=col.device)
    non = ~member & (c < cm.cs0[-1])
    nonc0 = cumsum0(non)
    nonc = nonc0[1:]
    co = cm.char_offsets.to(torch.int64)
    t0, t1 = nonc0[co[:-1]], nonc0[co[1:]]
    has = t1 > t0
    hi = max(cps.shape[0] - 1, 0)
    # the first non-member char of a row is the (t0 + 1)-th of the column,
    # the last one the t1-th
    cfirst = torch.searchsorted(nonc, t0 + 1).clamp(0, hi).to(torch.int32)
    clast = torch.searchsorted(nonc, t1).clamp(0, hi).to(torch.int32)
    starts = torch.where(has, cfirst - cm.char_offsets[:-1], nch) if left else torch.zeros_like(nch)
    stops = torch.where(has, clast - cm.char_offsets[:-1] + 1, 0) if right else nch
    return starts, torch.maximum(stops, starts)


def _strip_impl(col: StringColumn, to_strip, left: bool, right: bool) -> StringColumn:
    if col.size == 0:
        return col
    starts, stops = _strip_window(col, to_strip, left, right)
    return substr._slice_bytes(col, starts, stops, raw=True)


def lstrip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, True, False)


def rstrip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, False, True)


def strip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, True, True)
