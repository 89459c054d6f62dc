"""URL percent-encoding: `url_encode` and `url_decode`.

Port of `custrings_tpu/ops/urlencode.py` (cpp/src/strings/urlencode.cu
url_encode:130, url_decode:243).  The unreserved set is [0-9A-Za-z._~-]
(urlencode.cu:80-85); every other byte, each byte of a multi-byte UTF-8
char included, becomes %XX with upper-case hex.  Decoding turns '%' and
the two bytes after it into one byte wherever the row still holds those
two bytes (a non-hex digit counts as 0, so "%zz" decodes to 0x00).

    encode  each real byte j gets width 1 (kept) or 3 (%XX); their prefix
            sum ob0 (K3) places byte j at ob0[j], so dist = ob0[j] - j is
            non-negative and non-decreasing over the real bytes: one
            monotone expansion with `placed` (K4e,
            `shift_compact.expand_to`) moves every byte to its first slot,
            and a running max of the placed slots (K3) gives the second
            and third slot of a %XX their byte, as the JAX package's
            scatter and cummax do
    decode  which bytes start or sit inside an escape is a scan of a
            three-state machine (`segments.compose_scan`); the escape
            starts take their decoded byte, and the bytes to keep are one
            stable compaction (K7, `compact.compact_bytes`)
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0
from ..config import bucket_bytes
from . import compact, layout, segments, shift_compact


def _unreserved(b: torch.Tensor) -> torch.Tensor:
    return (((b >= ord("0")) & (b <= ord("9"))) | ((b >= ord("A")) & (b <= ord("Z")))
            | ((b >= ord("a")) & (b <= ord("z"))) | (b == ord(".")) | (b == ord("_"))
            | (b == ord("~")) | (b == ord("-")))


def _hex_char(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 10, ord("0") + v, ord("A") + v - 10).to(torch.uint8)


def url_encode(col: StringColumn) -> StringColumn:
    cap = col.capacity
    real = layout.valid_byte_mask(col)
    w = torch.where(real, torch.where(_unreserved(col.data), 1, 3), 0).to(torch.int32)
    ob0 = cumsum0(w)
    out_offsets = ob0[col.offsets.to(torch.int64)]
    bcap = bucket_bytes(int(out_offsets[-1]))
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    (moved,), placed = shift_compact.expand_to(real, ob0[:-1] - j, [col.data], bcap, True)
    q = torch.arange(bcap, dtype=torch.int32, device=col.device)
    qstart = segments.cummax(torch.where(placed, q, -1))
    t = q - qstart
    b = moved[qstart.clamp(min=0).to(torch.int64)]
    bi = b.to(torch.int32)
    byte = torch.where(t == 0, torch.where(_unreserved(b), b, ord("%")).to(torch.uint8),
                       torch.where(t == 1, _hex_char(bi >> 4), _hex_char(bi & 0xF)))
    data = torch.where((qstart >= 0) & (q < out_offsets[-1]), byte, 0).to(torch.uint8)
    return StringColumn(data, out_offsets, col.validity)


def _hex_val(c: torch.Tensor) -> torch.Tensor:
    return torch.where((c >= ord("0")) & (c <= ord("9")), c - ord("0"),
                       torch.where((c >= ord("A")) & (c <= ord("F")), c - ord("A") + 10,
                                   torch.where((c >= ord("a")) & (c <= ord("f")), c - ord("a") + 10, 0)))


def url_decode(col: StringColumn) -> StringColumn:
    if col.size == 0:
        return col
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    real = layout.valid_byte_mask(col)
    row_end = segments.row_end_positions(col.offsets, cap)
    b = col.data.to(torch.int32)
    is_pct = (b == ord("%")) & (j + 2 < row_end) & real
    # bytes of an escape still to skip, {0, 1, 2}: an escape starts at a
    # '%' outside another escape and covers the two bytes after it
    dom = torch.arange(3, dtype=torch.int32, device=col.device)
    T = torch.where((dom == 0) & is_pct[:, None], 2, (dom - 1).clamp(min=0))
    comp = segments.compose_scan(T)  # comp[j] = T_j o ... o T_0
    s_in = torch.cat([torch.zeros(1, dtype=comp.dtype, device=col.device), comp[:-1, 0]])
    start = is_pct & (s_in == 0)
    emit = real & ~((s_in > 0) & ~start)
    out_b = torch.where(start, (_hex_val(torch.roll(b, -1)) * 16 + _hex_val(torch.roll(b, -2))).to(torch.uint8),
                        col.data)
    ob0 = cumsum0(emit)
    out_offsets = ob0[col.offsets.to(torch.int64)]
    bcap = bucket_bytes(int(out_offsets[-1]))
    return StringColumn(compact.compact_bytes(out_b, emit, bcap), out_offsets, col.validity)
