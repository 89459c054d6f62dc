"""Literal search: find / rfind / contains and the occurrence count.

Port of `_pat_array`, `_match_mask`, `_find_impl`, `find`, `rfind`,
`contains`, `count_literal` and `_count_literal_impl` from
`custrings_tpu/ops/find.py`.  The whole flat byte buffer is matched
against the pattern at every byte position at once (m shifted compares),
then per-row results come from one prefix count of the hits (K3).
Positions are CHARACTER indexes, as in the reference (find.cu; -1 = no
match, -2 = null row).  The rest of the family (startswith, compare,
find_multiple, ...) is not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..column import StringColumn, cumsum0
from . import layout, segments


@lru_cache(maxsize=4096)
def _pat_array_cached(b: bytes, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy()).to(device)


def _pat_array(pat: str | bytes, device) -> torch.Tensor:
    """uint8[m] tensor of the pattern's UTF-8 bytes on `device` (cached)."""
    b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    return _pat_array_cached(b, str(device))


def _match_mask(data: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """bool[capacity]: the pattern matches starting at byte j, ignoring
    rows.  Shifts wrap around the buffer end like jnp.roll; callers fence
    each match inside its row."""
    acc = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    for t in range(pat.shape[0]):
        acc &= torch.roll(data, -t) == pat[t]
    return acc


def _find_impl(col: StringColumn, pat: torch.Tensor, starts, ends, reverse: bool) -> torch.Tensor:
    """int32[rows]: char position of the first (last, with `reverse`)
    occurrence inside each row's char window [start, end), -1 where none,
    -2 for null rows.  The k-th hit of a row is found by a binary search
    in the hits' prefix count, so no capacity-sized segment reduce.  (Every
    caller of the JAX `_find_impl` passes `use_ranges=True`.)"""
    cm = layout.char_map(col)
    m = pat.shape[0]
    cap = col.capacity
    nch = cm.nchars()
    starts = starts.to(torch.int32).clamp(min=0)
    ends = ends.to(torch.int32)
    # end < 0 or past the row -> its char count (custring_view.inl:487-492)
    ends = torch.where((ends < 0) | (ends > nch), nch, ends)
    co = cm.char_offsets[:-1]
    spos = layout.char_byte_pos(col, co + torch.minimum(starts, nch))
    epos = layout.char_byte_pos(col, co + ends)
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    ok = (
        _match_mask(col.data, pat)
        & (j >= segments.broadcast_rows_to_bytes(spos, col.offsets, cap))
        & (j + m <= segments.broadcast_rows_to_bytes(epos, col.offsets, cap))
        & layout.valid_byte_mask(col)
    )
    okc0 = cumsum0(ok)
    o = col.offsets.to(torch.int64)
    t0, t1 = okc0[o[:-1]], okc0[o[1:]]
    k = t1 if reverse else t0 + 1
    # the k-th hit (1-based) is the first position whose inclusive count reaches k
    jpos = torch.searchsorted(okc0[1:], k).clamp(0, cap - 1)
    best = torch.where(t1 > t0, cm.cs0[jpos] - co, -1)
    if m == 0:
        best = torch.full_like(best, -1)  # find.cu: an empty target finds nothing
    return torch.where(col.validity, best, -2).to(torch.int32)


def _window(col: StringColumn, start, end):
    n = col.size
    starts = torch.full((n,), int(start), dtype=torch.int32, device=col.device)
    ends = torch.full((n,), -1 if end is None else int(end), dtype=torch.int32, device=col.device)
    return starts, ends


def find(col: StringColumn, pat, start=0, end=None) -> torch.Tensor:
    """Char position of the first occurrence within chars [start, end)."""
    return _find_impl(col, _pat_array(pat, col.device), *_window(col, start, end), False)


def rfind(col: StringColumn, pat, start=0, end=None) -> torch.Tensor:
    """Char position of the last occurrence within chars [start, end)."""
    return _find_impl(col, _pat_array(pat, col.device), *_window(col, start, end), True)


def contains(col: StringColumn, pat) -> torch.Tensor:
    """bool[rows]; null rows -> False (find.cu contains:237)."""
    return find(col, pat) >= 0


def count_literal(col: StringColumn, pat) -> torch.Tensor:
    """int32[rows]: occurrences of `pat` in each row, overlapping ones
    included; 0 for null rows and for an empty pattern."""
    p = _pat_array(pat, col.device)
    if p.shape[0] == 0:
        return torch.zeros(col.size, dtype=torch.int32, device=col.device)
    return _count_literal_impl(col, p)


def _count_literal_impl(col: StringColumn, p: torch.Tensor) -> torch.Tensor:
    m = p.shape[0]
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    ok = (
        _match_mask(col.data, p)
        & (j + m <= segments.row_end_positions(col.offsets, cap))
        & layout.valid_byte_mask(col)
    )
    cnt = segments.per_row_of_prefix(cumsum0(ok), col.offsets)
    return torch.where(col.validity, cnt, 0).to(torch.int32)
