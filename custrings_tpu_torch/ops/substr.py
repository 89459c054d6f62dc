"""Per-row character slices.

Port of `slice_from` and its helpers (`_char_window`, `_slice_bytes`)
from `custrings_tpu/ops/substr.py`.  Positions are
character indexes; a slice is a byte-range copy per row.  Reference
normalization: a negative start gives an empty result, and stop <= 0
means the end of the string (substr.cu:55).
"""

from __future__ import annotations

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, build_column, empty_column
from ..config import bucket_bytes
from . import layout


def _char_window(col: StringColumn, starts, stops):
    """Clamp per-row char [start, stop) and return their byte positions
    (start bytes, stop bytes)."""
    cm = layout.char_map(col)
    nch = cm.nchars()
    s = starts.to(torch.int32)
    s = torch.where(s < 0, nch, s)
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)), nch)
    e = stops.to(torch.int32)
    e = torch.where(e <= 0, nch, e)
    e = torch.minimum(torch.maximum(e, torch.zeros_like(e)), nch)
    e = torch.maximum(e, s)
    co = cm.char_offsets[:-1]
    return layout.char_byte_pos(col, co + s), layout.char_byte_pos(col, co + e)


def _span_column(src: torch.Tensor, starts, sizes, validity, capacity: int | None = None) -> StringColumn:
    """A column whose row i is src[starts[i] : starts[i] + sizes[i]]
    (without a capacity, the total is synced to size it)."""
    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(src, bcast(starts) + k)

    return build_column(sizes, validity, produce, capacity)


def _slice_bytes(col: StringColumn, starts, stops) -> StringColumn:
    """Byte ranges of the char windows, one row each.  The output is
    allocated at the input capacity (a bound) unless that is above
    BOUND_SYNC_THRESHOLD, where the exact total is synced."""
    if col.size == 0:
        return empty_column(0, col.device)
    sb, eb = _char_window(col, starts, stops)
    sizes = eb - sb
    bound = col.capacity if col.capacity <= BOUND_SYNC_THRESHOLD else int(sizes.sum())
    return _span_column(col.data, sb, sizes, col.validity, bucket_bytes(bound))


def slice_from(col: StringColumn, starts=None, stops=None) -> StringColumn:
    """Per-row start/stop char positions (substr.cu slice_from:85)."""
    n = col.size
    dev = col.device
    starts = (
        torch.zeros(n, dtype=torch.int32, device=dev)
        if starts is None
        else torch.as_tensor(starts, dtype=torch.int32, device=dev)
    )
    stops = (
        torch.full((n,), -1, dtype=torch.int32, device=dev)
        if stops is None
        else torch.as_tensor(stops, dtype=torch.int32, device=dev)
    )
    return _slice_bytes(col, starts, stops)
