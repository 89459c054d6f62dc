"""Padding: repeat / pad / ljust / center / rjust / zfill / wrap.

Port of `custrings_tpu/ops/pad.py` (pad.cu repeat:31, pad:87, ljust:98,
center:160, rjust:228, zfill:290, wrap:361).  Widths are in characters
and the fill character may be multi-byte.  Every op but wrap builds its
rows from pieces in one `build_column` pass.  wrap's greedy line breaking
is sequential along a row: it walks the columns of the rows' char matrix
(the JAX `lax.scan`) with every row in parallel, in plain torch, and the
rows are rebuilt by the charwise engine.
"""

from __future__ import annotations

import torch

from ..column import StringColumn, build_column
from . import charwise, layout
from .find import _pat_array


def repeat(col: StringColumn, reps: int) -> StringColumn:
    """Each row `reps` times over (at least once)."""
    reps = max(int(reps), 1)
    lens = col.lengths()
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k % bcast(lens).clamp(min=1))

    return build_column(lens * reps, col.validity, produce)


def _pad_impl(col: StringColumn, width: int, fillchar, side: str) -> StringColumn:
    fill = _pat_array(fillchar if fillchar else " ", col.device)
    fb = fill.shape[0]
    nch = layout.char_counts(col)
    lens = col.lengths()
    pad = (int(width) - nch).clamp(min=0)
    lpad = {"l": torch.zeros_like(pad), "r": pad, "c": pad // 2}[side]
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        lp = bcast(lpad) * fb
        end = lp + bcast(lens)
        src = layout.gather_bytes(col.data, bcast(starts) + (k - lp).clamp(min=0))
        # the right fill restarts its char at the body's end (the JAX
        # package indexes it by k, which splits a multi-byte fill char
        # whenever lp + the body's bytes is not a multiple of fb)
        fk = torch.where(k < lp, k, k - end) % fb
        return torch.where((k >= lp) & (k < end), src, fill[fk.to(torch.int64)])

    return build_column(lens + pad * fb, col.validity, produce)


def ljust(col, width, fillchar=None):
    return _pad_impl(col, width, fillchar, "l")


def rjust(col, width, fillchar=None):
    return _pad_impl(col, width, fillchar, "r")


def center(col, width, fillchar=None):
    """Fill on both sides, the left side taking the smaller half."""
    return _pad_impl(col, width, fillchar, "c")


def pad(col, width, side="left", fillchar=None):
    if side == "right":
        return ljust(col, width, fillchar)
    if side == "both":
        return center(col, width, fillchar)
    return rjust(col, width, fillchar)


def zfill(col: StringColumn, width: int) -> StringColumn:
    """Left-pad with '0' to `width` chars, after a leading '+' or '-'
    (pad.cu zfill:290)."""
    lens = col.lengths()
    pad_n = (int(width) - layout.char_counts(col)).clamp(min=0)
    starts = col.offsets[:-1]
    first = layout.gather_bytes(col.data, starts)
    has_sign = ((first == ord("+")) | (first == ord("-"))) & (lens > 0)

    def produce(rows, k, valid, bcast):
        sign = bcast(has_sign) == 1
        p = bcast(pad_n)
        st = bcast(starts)
        in_sign = sign & (k == 0)
        in_zero = ~in_sign & (k < sign.to(torch.int32) + p)
        src = layout.gather_bytes(col.data, st + (k - p).clamp(min=0))
        zero = torch.full_like(src, ord("0"))
        return torch.where(in_sign, layout.gather_bytes(col.data, st), torch.where(in_zero, zero, src))

    return build_column(lens + pad_n, col.validity, produce)


def wrap(col: StringColumn, width: int) -> StringColumn:
    """Greedy line wrap (pad.cu wrap:361): every char <= ' ' becomes ' ',
    and once a line reaches `width` chars its last space becomes '\\n'.
    The char count does not change."""
    if col.size == 0:
        return col
    w = layout.max_row_bytes(col)
    mat, nch = layout.char_matrix(col, w)
    n, dev = col.size, col.device
    j = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    in_row = j < nch[:, None]
    is_ws = in_row & (mat <= ord(" "))
    spos = torch.zeros(n, dtype=torch.int32, device=dev)
    last_space = torch.full((n,), -1, dtype=torch.int32, device=dev)
    marks = torch.full((n, w + 1), False, dtype=torch.bool, device=dev)
    width = int(width)
    for pos in range(w):
        last_space = torch.where(is_ws[:, pos], pos, last_space)
        brk = ((pos - spos) >= width) & (last_space >= 0) & in_row[:, pos]
        marks.scatter_(1, torch.where(brk, last_space, w)[:, None].to(torch.int64), True)
        spos = torch.where(brk, last_space, spos)
        last_space = torch.where(brk, -1, last_space)
    out = torch.where(is_ws, ord(" "), mat)
    out = torch.where(marks[:, :w], ord("\n"), out).flatten()

    def cp_fn(rows, oc, valid, *, cidx, bcast):
        return out[(rows.to(torch.int64) * w + oc.clamp(0, w - 1))]

    return charwise.build_charwise(col, nch, cp_fn)
