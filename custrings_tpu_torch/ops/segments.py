"""Segment primitives for the flat byte domain.

Port of `custrings_tpu/ops/segments.py`.  Per-byte row attributes come
from a rows-sized scatter of per-row deltas plus one capacity-sized scan
(K3), never from a capacity-sized gather:

    broadcast_rows_to_bytes(v, offsets, cap)[j] == v[row_of(j)]
"""

from __future__ import annotations

import torch

from .scan import cummax_i32, cumsum_i32

__all__ = [
    "cumsum",
    "cummax",
    "broadcast_rows_to_bytes",
    "row_start_positions",
    "row_end_positions",
    "per_row_of_prefix",
    "compose_scan",
]


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum (K3)."""
    return cumsum_i32(x)


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 running maximum (K3)."""
    return cummax_i32(x)


def broadcast_rows_to_bytes(
    row_values: torch.Tensor, offsets: torch.Tensor, capacity: int
) -> torch.Tensor:
    """int32[capacity]: row_values[row_of(j)] for every byte position j.

    Per-row deltas are scattered at the row starts and prefix-summed;
    coincident starts of empty rows add up so the last (owning) row wins.
    Padding positions past offsets[-1] report the last row's value."""
    rv = row_values.to(torch.int32)
    deltas = torch.cat([rv[:1], rv[1:] - rv[:-1]])
    acc = torch.zeros(capacity + 1, dtype=torch.int32, device=rv.device)
    acc.index_add_(0, offsets[:-1].to(torch.int64), deltas)
    return cumsum(acc[:capacity])


def row_start_positions(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """int32[capacity]: byte position where j's row begins."""
    return broadcast_rows_to_bytes(offsets[:-1], offsets, capacity)


def row_end_positions(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """int32[capacity]: byte position where j's row ends (exclusive)."""
    return broadcast_rows_to_bytes(offsets[1:], offsets, capacity)


def per_row_of_prefix(prefix0: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-row totals from a byte-domain exclusive prefix int32[cap+1]."""
    o = offsets.to(torch.int64)
    return prefix0[o[1:]] - prefix0[o[:-1]]


def compose_scan(T: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of function composition: out[j] = T_j o ... o T_0.

    T is int[B, m]: T[j] maps an incoming state s (< m) to T[j, s].
    Hillis-Steele doubling with gathers along the state axis."""
    B, m = T.shape
    comp = T.to(torch.int64)
    ident = torch.arange(m, dtype=torch.int64, device=T.device).expand(B, m)
    s = 1
    while s < B:
        earlier = torch.cat([ident[: min(s, B)], comp[:-s]], dim=0)[:B]
        comp = torch.gather(comp, 1, earlier)
        s *= 2
    return comp.to(T.dtype)
