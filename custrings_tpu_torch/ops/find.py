"""Literal search: find / rfind / contains, prefixes, compares and the
occurrence count.

Port of `custrings_tpu/ops/find.py`.  The whole flat byte buffer is
matched against the pattern at every byte position at once (m shifted
compares), then per-row results come from one prefix count of the hits
(K3).  Positions are CHARACTER indexes, as in the reference (find.cu; -1 =
no match, -2 = null row).  `compare` and `match_strings` read each row's
leading bytes from a padded view (the K1 window, `layout.padded_view`).
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


def find_from(col: StringColumn, pat, starts=None, ends=None) -> torch.Tensor:
    """find with per-row char windows [starts[i], ends[i]) (an end < 0
    means the row's end)."""
    n, dev = col.size, col.device
    starts = (torch.zeros(n, dtype=torch.int32, device=dev) if starts is None
              else torch.as_tensor(starts, dtype=torch.int32).to(dev))
    ends = (torch.full((n,), -1, dtype=torch.int32, device=dev) if ends is None
            else torch.as_tensor(ends, dtype=torch.int32).to(dev))
    return _find_impl(col, _pat_array(pat, dev), starts, ends, False)


def contains(col: StringColumn, pat) -> torch.Tensor:
    """bool[rows]; null rows -> False (find.cu contains:237)."""
    return find(col, pat) >= 0


def _prefix_suffix(col: StringColumn, pat: torch.Tensor, suffix: bool) -> torch.Tensor:
    """bool[rows]: the row starts (ends) with pat; False for null rows."""
    m = pat.shape[0]
    lens = col.lengths()
    start = col.offsets[1:] - m if suffix else col.offsets[:-1]
    acc = torch.ones(col.size, dtype=torch.bool, device=col.device)
    for t in range(m):
        acc &= layout.gather_bytes(col.data, start + t) == pat[t]
    return acc & (lens >= m) & col.validity


def startswith(col: StringColumn, pat) -> torch.Tensor:
    return _prefix_suffix(col, _pat_array(pat, col.device), False)


def endswith(col: StringColumn, pat) -> torch.Tensor:
    return _prefix_suffix(col, _pat_array(pat, col.device), True)


def compare(col: StringColumn, pat) -> torch.Tensor:
    """int32[rows]: 0 where the row equals pat; else the difference of the
    first differing bytes, -1 where the row is a proper prefix of pat and
    1 where pat is one of the row; -1 for null rows (find.cu compare:36)."""
    p = _pat_array(pat, col.device)
    m = p.shape[0]
    lens = col.lengths()
    if m == 0:
        res = (lens > 0).to(torch.int32)
    else:
        # the first m bytes of each row, zero past its length (K1)
        view = layout.padded_view(col, m).to(torch.int32)
        t = torch.arange(m, dtype=torch.int32, device=col.device)[None, :]
        off = (t >= lens[:, None]) | (view != p.to(torch.int32)[None, :])
        first = torch.where(off, t, m).amin(dim=1)
        at = view.gather(1, first.clamp(max=m - 1)[:, None].to(torch.int64))[:, 0]
        diff = torch.where(first >= lens, -1, at - p.to(torch.int32)[first.clamp(max=m - 1)])
        res = torch.where(first < m, diff, (lens > m).to(torch.int32))
    return torch.where(col.validity, res, -1).to(torch.int32)


def match_strings(col: StringColumn, other: StringColumn) -> torch.Tensor:
    """bool[rows]: the rows of the two columns are equal; two nulls match
    each other (find.cu match_strings:276)."""
    w = max(layout.max_row_bytes(col), layout.max_row_bytes(other))
    eq = (layout.padded_view(col, w) == layout.padded_view(other, w)).all(dim=1)
    eq &= col.lengths() == other.lengths()
    both_null = ~col.validity & ~other.validity
    return torch.where(col.validity & other.validity, eq, both_null)


def find_multiple(col: StringColumn, targets: StringColumn) -> torch.Tensor:
    """int32[rows, targets]: the first char position of each target in
    each row (-1 none, -2 null row); a null target searches for ""."""
    from ..column import to_host_strings

    found = [find(col, "" if t is None else t) for t in to_host_strings(targets)]
    if not found:
        return torch.zeros((col.size, 0), dtype=torch.int32, device=col.device)
    return torch.stack(found, dim=1)


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
