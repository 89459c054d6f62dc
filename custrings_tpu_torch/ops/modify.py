"""Literal replace, fillna, insert, slice_replace and translate.

Port of `custrings_tpu/ops/modify.py`: the literal replace
(`_has_border`, `_greedy_select`, `_small_lookup`, `_replace_same_len`,
`_replace_plan`, `_replace_count`, `_replace_write_route`,
`_replace_grow_stream`, `_replace_full`, `replace_literal`), and
`fillna_scalar`, `fillna_column`, `insert`, `slice_replace` (rows built
from pieces by `build_column`) and `translate` (the charwise engine).

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

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, build_column, cumsum0
from ..config import bucket_bytes
from . import charwise, layout, segments, shift_compact, substr
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
        (data,), _ = shift_compact.compact_arrays(keep | rep_zone, [aug], want_k0=False)
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


def _piece_byte(b: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """b[k] of a short constant (k clamped into it), 0 when b is empty."""
    if b.shape[0] == 0:
        return torch.zeros_like(k, dtype=torch.uint8)
    return b[k.clamp(0, b.shape[0] - 1).to(torch.int64)]


def fillna_scalar(col: StringColumn, repl: str) -> StringColumn:
    """Null rows become `repl` (modify.cu fillna:395)."""
    rb = _pat_array(repl, col.device)
    sizes = torch.where(col.validity, col.lengths(), rb.shape[0])
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        src = layout.gather_bytes(col.data, bcast(starts) + k)
        return torch.where(bcast(col.validity) == 1, src, _piece_byte(rb, k))

    return build_column(sizes, torch.ones_like(col.validity), produce)


def fillna_column(col: StringColumn, repl: StringColumn) -> StringColumn:
    """Null rows take the same row of `repl` (modify.cu fillna:444)."""
    use_repl = ~col.validity
    sizes = torch.where(use_repl, repl.lengths(), col.lengths())
    validity = torch.where(use_repl, repl.validity, col.validity)
    starts, rstarts = col.offsets[:-1], repl.offsets[:-1]

    def produce(rows, k, valid, bcast):
        a = layout.gather_bytes(col.data, bcast(starts) + k)
        b = layout.gather_bytes(repl.data, bcast(rstarts) + k)
        return torch.where(bcast(use_repl) == 1, b, a)

    return build_column(sizes, validity, produce)


def insert(col: StringColumn, start: int, repl: str) -> StringColumn:
    """`repl` inserted at char position `start` (-1: at the end)
    (modify.cu insert:494)."""
    return slice_replace(col, start, start, repl, insert_mode=True)


def slice_replace(col: StringColumn, start, stop, repl: str | None,
                  insert_mode: bool = False) -> StringColumn:
    """Chars [start, stop) of every row replaced by `repl`; a stop < 0 or
    None means the row's end (modify.cu slice_replace:35)."""
    rb = _pat_array(repl or "", col.device)
    rl = rb.shape[0]
    n, dev = col.size, col.device
    nch = layout.char_counts(col)
    s = torch.full((n,), int(start if start is not None else 0), dtype=torch.int32, device=dev)
    if insert_mode:
        s = torch.where(s < 0, nch, torch.minimum(s, nch))
        e = s
    else:
        e = torch.full((n,), -1 if stop is None else int(stop), dtype=torch.int32, device=dev)
        e = torch.where(e < 0, nch, torch.minimum(e, nch))
        s = torch.minimum(s.clamp(min=0), nch)
        e = torch.maximum(e, s)
    _, _, sb, eb = substr._char_window(col, s, e, raw=True)
    head = sb - col.offsets[:-1]
    sizes = head + rl + (col.offsets[1:] - eb)
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        h = bcast(head)
        head_b = layout.gather_bytes(col.data, bcast(starts) + k)
        tail_b = layout.gather_bytes(col.data, bcast(eb) + (k - h - rl).clamp(min=0))
        return torch.where(k < h, head_b, torch.where(k < h + rl, _piece_byte(rb, k - h), tail_b))

    return build_column(sizes, col.validity, produce)


def translate(col: StringColumn, table) -> StringColumn:
    """Chars mapped through a codepoint table (modify.cu translate:302):
    a dict {char or ord: char, ord or None} or (key, value) pairs; None
    deletes the char, as in `str.translate`.  The kept chars of each row
    are counted by one prefix count (K3)."""
    if col.size == 0:
        return col
    items = table.items() if isinstance(table, dict) else table
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    mapped = cps
    for k, v in items:
        src = ord(k) if isinstance(k, str) else int(k)
        dst = -1 if v is None else (ord(v) if isinstance(v, str) else int(v))
        mapped = torch.where(cps == src, dst, mapped)
    ncap = cps.shape[0]
    c = torch.arange(ncap, dtype=torch.int32, device=col.device)
    kept = (mapped >= 0) & (c < cm.cs0[-1])
    kpos0 = cumsum0(kept)
    counts = segments.per_row_of_prefix(kpos0, cm.char_offsets)
    # the k-th kept char of the column is input char in_for_out[k]
    in_for_out = torch.zeros(ncap + 1, dtype=torch.int32, device=col.device)
    in_for_out[torch.where(kept, kpos0[:-1], ncap).to(torch.int64)] = c
    base_rows = kpos0[cm.char_offsets[:-1].to(torch.int64)]

    def cp_fn(rows, oc, valid, *, cidx, bcast):
        g = in_for_out[(bcast(base_rows) + oc).clamp(0, ncap - 1).to(torch.int64)]
        return mapped[g.clamp(0, ncap - 1).to(torch.int64)]

    return charwise.build_charwise(col, counts, cp_fn)
