"""Literal replace.

Port of the literal replace of `custrings_tpu/ops/modify.py`:
`_has_border`, `_greedy_select`, `_small_lookup`, `_replace_same_len`,
`_replace_plan`, `_replace_count`, `_replace_write_route`,
`_replace_grow_stream`, `_replace_full` and `replace_literal`.

    same length   offsets do not change: one elementwise substitution off
                  the column's memoized tail plane (bytes left in the
                  byte's valid row)
    shrink        the replacement overwrites the head of each match in
                  place and the rest of the match is dropped: one stable
                  compaction (K4c)
    grow          kept bytes move right to their output positions (K4e)
                  and the gaps left are the replacement bytes; unbordered
                  patterns of at most 8 bytes without a quota take the
                  one-plane streaming writer
"""

from __future__ import annotations

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, cumsum0
from ..config import bucket_bytes
from . import layout, segments, shift_compact
from .find import _match_mask, _pat_array


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
        pk0 = cumsum0(picked)
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


def _replace_plan(col: StringColumn, p, m: int, bordered: bool, n: int):
    """Per-byte plan of a size-changing replace: (picked, inside,
    picks_in_row, covered_in_row, picks_per_row, row_start).  Row
    attributes come from segment scans, not capacity-sized gathers."""
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    row_start, row_end = layout.row_bounds_planes(col)
    match = _match_mask(col.data, p) & (j + m <= row_end) & layout.valid_byte_mask(col)
    picked = _greedy_select(match, m, bordered)
    starts = col.offsets[:-1].to(torch.int64)

    def in_row(prefix0):  # prefix0[j] minus its value at j's row start
        return prefix0[:cap] - segments.broadcast_rows_to_bytes(prefix0[starts], col.offsets, cap)

    if n >= 0:
        picked = picked & (in_row(cumsum0(picked)) < n)
    last_start = segments.cummax(torch.where(picked, j, -1))
    inside = (last_start >= 0) & (j - last_start < m)
    picks_before0 = cumsum0(picked)
    picks_per_row = segments.per_row_of_prefix(picks_before0, col.offsets)
    return picked, inside, in_row(picks_before0), in_row(cumsum0(inside)), picks_per_row, row_start


def _replace_count(col: StringColumn, p, m: int, bordered: bool, n: int) -> int:
    """nbytes + the number of picked matches (one sync)."""
    return int(col.offsets[-1] + _replace_plan(col, p, m, bordered, n)[4].sum())


def _replace_write_route(col: StringColumn, plan, r, m: int, rl: int, bcap: int):
    """Size-changing write as one monotone move.

    shrink (rl <= m): the replacement fits inside the match's byte span:
    overwrite the first rl match bytes in place, keep them, drop the rest;
    the stable compaction of the kept bytes is the output (K4c).
    grow (rl > m): kept bytes move right by out_pos - j, nondecreasing over
    kept lanes since every row only grows (K4e); the unplaced output gaps
    are exactly the rl-byte replacement zones."""
    picked, inside, picks_in_row, covered_in_row, picks_per_row, row_start = plan
    cap = col.capacity
    dev = col.device
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    out_offsets = cumsum0(col.lengths() + picks_per_row * (rl - m))
    keep = ~inside & layout.valid_byte_mask(col)
    if rl <= m:
        last_start = segments.cummax(torch.where(picked, j, -1))
        doff = j - last_start
        rep_zone = inside & (last_start >= 0) & (doff < rl)
        aug = torch.where(rep_zone, _small_lookup(r, doff, rl), col.data) if rl else col.data
        (data,), _ = shift_compact.compact_arrays(keep | rep_zone, [aug])
        return _fit(data, bcap), out_offsets
    out_pos = (
        segments.broadcast_rows_to_bytes(out_offsets[:-1], col.offsets, cap)
        + (j - row_start)
        - covered_in_row
        + picks_in_row * rl
    )
    dist = (out_pos - j).clamp(min=0)
    (moved,), placed = shift_compact.expand_to(keep, dist, [col.data], bcap)
    q = torch.arange(bcap, dtype=torch.int32, device=dev)
    last_placed = segments.cummax(torch.where(placed, q, -1))
    # gaps are k adjacent rl-byte replacement zones: index mod rl
    rep = _small_lookup(r, (q - last_placed - 1) % rl, rl)
    in_rep = ~placed & (q < out_offsets[-1])
    # moved is 0 wherever nothing was placed
    return torch.where(in_rep, rep, moved), out_offsets


def _fit(data: torch.Tensor, n: int) -> torch.Tensor:
    """data cut or zero-padded to n elements."""
    if data.shape[0] >= n:
        return data[:n]
    return torch.nn.functional.pad(data, (0, n - data.shape[0]))


def _replace_grow_stream(col: StringColumn, p, r, m: int, rl: int, bcap: int):
    """Growth writer for unbordered patterns of at most 8 bytes without a
    quota: one int32 plane and one expansion (K4e).  The first m
    replacement bytes are substituted in place (matches cannot overlap: an
    m-way rolled select finds the covering match), every byte of a valid
    row is kept, and byte j moves right by the growth times the picks
    strictly before its match, which is monotone on all lanes.  The
    unplaced output gaps are the (rl - m)-byte replacement tails."""
    g = rl - m
    cap = col.capacity
    dev = col.device
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    tail = layout.tail_plane(col)
    picked = _match_mask(col.data, p) & (tail >= m)
    off = torch.full((cap,), m, dtype=torch.int32, device=dev)
    for k in range(m):
        pk = torch.roll(picked, k) & (j >= k) if k else picked
        off = torch.where(pk, k, off)
    inside = off < m
    aug = torch.where(inside, _small_lookup(r, off.clamp(max=m - 1), m), col.data)
    pk0 = cumsum0(picked)
    dist = g * (pk0[1:] - inside.to(torch.int32))
    (moved,), placed = shift_compact.expand_to(tail > 0, dist, [aug], bcap)
    ppr = segments.per_row_of_prefix(pk0, col.offsets)
    out_offsets = cumsum0(col.lengths() + ppr * g)
    q = torch.arange(bcap, dtype=torch.int32, device=dev)
    in_gap = ~placed & (q < out_offsets[-1])
    if g == 1:
        rep = r[rl - 1].expand(bcap)
    else:
        last_placed = segments.cummax(torch.where(placed, q, -1))
        rep = _small_lookup(r, m + (q - last_placed - 1) % g, rl)
    return torch.where(in_gap, rep, moved), out_offsets


def _replace_full(col: StringColumn, p, r, m: int, rl: int, bordered: bool, n: int, bcap: int):
    """A size-changing replace into a buffer of bcap bytes."""
    if rl > m and not bordered and m <= 8 and n < 0:
        return _replace_grow_stream(col, p, r, m, rl, bcap)
    plan = _replace_plan(col, p, m, bordered, n)
    return _replace_write_route(col, plan, r, m, rl, bcap)


def replace_literal(col: StringColumn, pat, repl, n: int = -1) -> StringColumn:
    """Replace the first n (all when n < 0) non-overlapping occurrences of
    `pat` in each row with `repl`."""
    pat_b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    repl_b = (repl or "").encode("utf-8") if not isinstance(repl, bytes) else repl
    m, rl = len(pat_b), len(repl_b)
    if m == 0 or col.size == 0:
        return col
    p = _pat_array(pat_b, col.device)
    r = _pat_array(repl_b, col.device)
    bordered = _has_border(pat_b)
    if rl == m:
        data, offs = _replace_same_len(col, p, r, m, bordered, n)
        return StringColumn(data, offs, col.validity)
    if rl < m and col.capacity <= BOUND_SYNC_THRESHOLD:
        # a shrink cannot outgrow the input: allocate its capacity, no sync
        bcap = col.capacity
    else:
        nbytes = int(col.offsets[-1])
        npicks = _replace_count(col, p, m, bordered, n) - nbytes
        bcap = bucket_bytes(nbytes + npicks * max(rl - m, 0) + 1)
    data, offs = _replace_full(col, p, r, m, rl, bordered, n, bcap)
    return StringColumn(data, offs, col.validity)
