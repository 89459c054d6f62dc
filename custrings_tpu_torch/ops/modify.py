"""Literal replace, same-length case.

Port of `custrings_tpu/ops/modify.py`: `_has_border`, `_greedy_select`,
`_small_lookup`, `_replace_same_len` and `replace_literal`.  When the
replacement has the pattern's byte length, offsets do not change and the
write is one elementwise substitution off the column's memoized tail plane
(bytes left in the byte's valid row).

Size-changing replaces (the shrink and grow writers, `_replace_grow_stream`
and `_replace_write_route` in the JAX package) come with the stream
compaction and expansion kernels K4c/K4e in the next slice; they raise
NotImplementedError here.
"""

from __future__ import annotations

import torch

from ..column import StringColumn
from . import layout, segments
from .find import _match_mask, _pat_array
from .scan import cumsum_i32


def _has_border(pat: bytes) -> bool:
    """True if some proper prefix equals a suffix (matches can overlap)."""
    return any(pat[:k] == pat[-k:] for k in range(1, len(pat)))


def _greedy_select(match: torch.Tensor, m: int, bordered: bool) -> torch.Tensor:
    """Non-overlapping matches, picked left to right (match[] is already
    row-fenced).  Unbordered patterns cannot overlap, so every match is
    picked; bordered ones run a cover-state scan of function composition."""
    if m <= 1 or not bordered:
        return match
    dom = torch.arange(m, dtype=torch.int64, device=match.device)
    dec = (dom - 1).clamp(min=0)
    # byte j maps incoming cover state s to: m-1 if s == 0 and match[j],
    # else max(s-1, 0)
    T = torch.where((dom[None, :] == 0) & match[:, None], m - 1, dec[None, :])
    comp = segments.compose_scan(T)
    s_in = torch.cat([torch.zeros(1, dtype=torch.int64, device=match.device), comp[:-1, 0]])
    return match & (s_in == 0)


def _small_lookup(r: torch.Tensor, off: torch.Tensor, rl: int) -> torch.Tensor:
    """r[off] for a tiny table as a select ladder (no capacity gather)."""
    if rl > 8:
        return r[off.clamp(0, rl - 1).to(torch.int64)]
    out = r[rl - 1].expand(off.shape)
    for t in range(rl - 2, -1, -1):
        out = torch.where(off <= t, r[t], out)
    return out


def _replace_same_len(col: StringColumn, p, r, m: int, bordered: bool, n: int):
    """rl == m: (data, offsets) with every picked match overwritten."""
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    if m > 255:  # the tail plane saturates at 255: use the int32 fence
        row_end = layout.row_bounds_planes(col)[1]
        match = _match_mask(col.data, p) & (j + m <= row_end) & layout.valid_byte_mask(col)
    else:
        match = _match_mask(col.data, p) & (layout.tail_plane(col) >= m)
    picked = _greedy_select(match, m, bordered)
    if n >= 0:
        # keep the first n picks of each row
        pk0 = torch.cat(
            [torch.zeros(1, dtype=torch.int32, device=col.device), cumsum_i32(picked)]
        )
        base = segments.broadcast_rows_to_bytes(
            pk0[col.offsets[:-1].to(torch.int64)], col.offsets, cap
        )
        picked = picked & (pk0[:cap] - base < n)
    if m <= 8:
        # picked matches never overlap: at most one k in [0, m) has
        # picked[j-k], so m rolled selects find the covering match exactly
        off = torch.full((cap,), m, dtype=torch.int32, device=col.device)
        for k in range(m):
            pk = torch.roll(picked, k) & (j >= k) if k else picked
            off = torch.where(pk, k, off)
        inside = off < m
        rep = _small_lookup(r, off.clamp(max=m - 1), m)
    else:
        last_start = segments.cummax(torch.where(picked, j, -1))
        inside = (last_start >= 0) & (j - last_start < m)
        rep = _small_lookup(r, j - last_start, m)
    return torch.where(inside, rep, col.data), col.offsets


def replace_literal(col: StringColumn, pat, repl, n: int = -1) -> StringColumn:
    """Replace the first n (all when n < 0) non-overlapping occurrences of
    `pat` in each row with `repl` (same byte length only, for now)."""
    pat_b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    repl_b = (repl or "").encode("utf-8") if not isinstance(repl, bytes) else repl
    m, rl = len(pat_b), len(repl_b)
    if m == 0 or col.size == 0:
        return col
    if rl != m:
        raise NotImplementedError(
            "size-changing replace_literal (shrink/grow writers with the "
            "K4c/K4e stream kernels) is not ported yet: ROADMAP queue 1, item 4"
        )
    p = _pat_array(pat_b, col.device)
    r = _pat_array(repl_b, col.device)
    data, offs = _replace_same_len(col, p, r, m, _has_border(pat_b), n)
    return StringColumn(data, offs, col.validity)
