"""Per-row character slices.

Port of `custrings_tpu/ops/substr.py`: `slice_chars` (with a step),
`slice_from`, `get_char` and their helpers (`_char_window`,
`_slice_bytes`).  Positions are character indexes.  A step of 1 is a
byte-range copy per row; any other step builds its rows char by char in
the charwise engine.  Reference normalization: a negative start gives an
empty result, and stop <= 0 means the end of the string (substr.cu:55).
"""

from __future__ import annotations

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, build_column, empty_column
from ..config import bucket_bytes
from . import charwise, layout


def _char_window(col: StringColumn, starts, stops, raw: bool = False):
    """Clamp per-row char [start, stop) into the row: (start char, stop
    char, start byte, stop byte).  Without `raw` a negative start means
    the row's end and a stop <= 0 the row's end (substr.cu:55); with it
    (strip, slice_replace) both are taken as given."""
    nch = layout.char_counts(col)
    zero = torch.zeros_like(nch)
    s = starts.to(torch.int32)
    if not raw:
        s = torch.where(s < 0, nch, s)
    s = torch.minimum(torch.maximum(s, zero), nch)
    e = stops.to(torch.int32)
    if not raw:
        e = torch.where(e <= 0, nch, e)
    e = torch.maximum(torch.minimum(torch.maximum(e, zero), nch), s)
    co = layout.char_map(col).char_offsets[:-1]
    return s, e, layout.char_byte_pos(col, co + s), layout.char_byte_pos(col, co + e)


def _span_column(src: torch.Tensor, starts, sizes, validity, capacity: int | None = None) -> StringColumn:
    """A column whose row i is src[starts[i] : starts[i] + sizes[i]]
    (without a capacity, the total is synced to size it)."""
    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(src, bcast(starts) + k)

    return build_column(sizes, validity, produce, capacity)


def _slice_bytes(col: StringColumn, starts, stops, raw: bool = False) -> StringColumn:
    """Byte ranges of the char windows, one row each.  The output is
    allocated at the input capacity (a bound) unless that is above
    BOUND_SYNC_THRESHOLD, where the exact total is synced."""
    if col.size == 0:
        return empty_column(0, col.device)
    _, _, sb, eb = _char_window(col, starts, stops, raw)
    sizes = eb - sb
    bound = col.capacity if col.capacity <= BOUND_SYNC_THRESHOLD else int(sizes.sum())
    return _span_column(col.data, sb, sizes, col.validity, bucket_bytes(bound))


def slice_chars(col: StringColumn, start=0, stop=None, step=None) -> StringColumn:
    """Chars start, start + step, ... before stop of every row (substr.cu
    slice:39)."""
    step = 1 if step in (None, 0) else int(step)
    n, dev = col.size, col.device
    starts = torch.full((n,), int(start or 0), dtype=torch.int32, device=dev)
    stops = torch.full((n,), -1 if stop is None else int(stop), dtype=torch.int32, device=dev)
    if step == 1:
        return _slice_bytes(col, starts, stops)
    s, e, _, _ = _char_window(col, starts, stops)
    counts = torch.clamp(-torch.div(s - e, step, rounding_mode="floor"), min=0)
    first = layout.char_map(col).char_offsets[:-1] + s
    cps = layout.codepoints(col)

    def cp_fn(rows, oc, valid, *, cidx, bcast):
        g = (bcast(first) + oc * step).clamp(0, cps.shape[0] - 1)
        return cps[g.to(torch.int64)]

    return charwise.build_charwise(col, counts, cp_fn)


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


def get_char(col: StringColumn, i: int) -> StringColumn:
    """The char at position i of each row (substr.cu get:32)."""
    return slice_chars(col, i, i + 1, 1)
