"""Char-level materialization: columns whose rows are sequences of output
characters, each a codepoint, with UTF-8 widths that may change.

Port of `custrings_tpu/ops/charwise.py` (`run_charwise`, `build_charwise`,
`input_codepoint_gather`).  Every output char of the column is enumerated
at once, as in the JAX package, in three steps with a sync after each of
the first two:

    count  the chars: one prefix sum of the per-row counts (K3), synced
           for the char capacity
    bytes  each char's codepoint and UTF-8 width, one prefix sum of the
           widths (K3), synced for the byte capacity
    write  the codepoints moved to their first byte by one monotone
           expansion with `placed` into the byte capacity (K4e), then a
           select at most 3 deep fills each continuation byte from the
           char it belongs to

When the caller knows that every output codepoint is below 128
(`ascii_out`), the bytes are the codepoints: no byte count, no sync and no
K4e.

A body returns (counts, validity, cp_fn).  cp_fn(rows, oc, valid, *,
cidx, bcast) gives the codepoint of every output char from its row, its
char index within the row, whether it is a real char, its global index,
and `bcast`, which broadcasts a per-row value to the chars (K3).
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0, empty_column, row_ids_from_offsets
from ..config import bucket_bytes
from . import layout, segments, shift_compact


def _utf8_byte_at(cp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Byte t (0..3) of cp's UTF-8 encoding, elementwise (garbage where t
    is past the width; callers mask)."""
    w = layout.utf8_width(cp)
    group = (cp >> ((w - 1 - t) * 6).clamp(min=0)) & torch.where(t == 0, 0x7FFFFFFF, 0x3F)
    lead_mask = torch.where(w == 1, 0x00, torch.where(w == 2, 0xC0, torch.where(w == 3, 0xE0, 0xF0)))
    lead_keep = torch.where(w == 1, 0x7F, torch.where(w == 2, 0x1F, torch.where(w == 3, 0x0F, 0x07)))
    return torch.where(t == 0, lead_mask | (group & lead_keep), 0x80 | (group & 0x3F)).to(torch.uint8)


def _write(counts: torch.Tensor, validity: torch.Tensor, cp_fn, ascii_out: bool) -> StringColumn:
    char_offsets = cumsum0(counts.to(torch.int32))
    ccap = bucket_bytes(int(char_offsets[-1]))
    dev = counts.device
    c = torch.arange(ccap, dtype=torch.int32, device=dev)
    crows = row_ids_from_offsets(char_offsets, ccap)

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, char_offsets, ccap)

    oc = c - bcast(char_offsets[:-1])
    cvalid = c < char_offsets[-1]
    cps = cp_fn(crows, oc, cvalid, cidx=c, bcast=bcast).to(torch.int32)
    if ascii_out:
        data = torch.where(cvalid, cps, 0).to(torch.uint8)
        return StringColumn(data, char_offsets, validity)
    cb0 = cumsum0(torch.where(cvalid, layout.utf8_width(cps), 0))
    out_offsets = cb0[char_offsets.clamp(max=ccap).to(torch.int64)]
    bcap = bucket_bytes(int(out_offsets[-1]))
    # char c's first byte goes to cb0[c]; the bytes inserted before it,
    # cb0[c] - c, never decrease
    (cpb,), placed = shift_compact.expand_to(cvalid, cb0[:ccap] - c, [cps], bcap)

    def sh(a, k):  # a moved k places right, zero-filled
        return torch.cat([torch.zeros(min(k, a.shape[0]), dtype=a.dtype, device=dev), a[: max(a.shape[0] - k, 0)]])

    m1, m2 = sh(placed, 1), sh(placed, 2)
    cp_q = torch.where(placed, cpb, torch.where(m1, sh(cpb, 1), torch.where(m2, sh(cpb, 2), sh(cpb, 3))))
    t = torch.where(placed, 0, torch.where(m1, 1, torch.where(m2, 2, 3)))
    q = torch.arange(bcap, dtype=torch.int32, device=dev)
    data = torch.where(q < out_offsets[-1], _utf8_byte_at(cp_q, t), 0).to(torch.uint8)
    return StringColumn(data, out_offsets, validity)


def run_charwise(body_fn, col: StringColumn, *args, ascii_out: bool = False) -> StringColumn:
    """Build the column body_fn(col, *args) -> (counts, validity, cp_fn)
    defines.  ascii_out: the caller's guarantee that every output
    codepoint is below 128."""
    if col.size == 0:
        return empty_column(0, col.device)
    counts, validity, cp_fn = body_fn(col, *args)
    return _write(counts, validity, cp_fn, ascii_out)


def build_charwise(col: StringColumn, out_char_counts: torch.Tensor, cp_fn,
                   validity: torch.Tensor | None = None) -> StringColumn:
    """A charwise column from counts and a cp_fn computed by the caller
    (validity: the input's by default); the output may widen."""
    if col.size == 0:
        return empty_column(0, col.device)
    return _write(out_char_counts, col.validity if validity is None else validity, cp_fn, False)


def input_codepoint_gather(col: StringColumn):
    """fn(global char index) -> that char's codepoint in `col`."""
    cps = layout.codepoints(col)

    def get(idx):
        return cps[idx.clamp(0, cps.shape[0] - 1).to(torch.int64)]

    return get
