"""Joining a column's rows, and rows built from pieces.

Port of `join` / `_join_body` from `custrings_tpu/ops/combine.py`
(combine.cu join:291); `cat` is not ported yet (ROADMAP queue 1, item 4).
Every row built from pieces (the join here, and nvtext's n-grams,
normalized spaces and replaced tokens) is one pass: the pieces' bytes are
written back to back by one materialization over the output
(`substr._span_column`), and each output row is a run of pieces.
"""

from __future__ import annotations

import torch

from ..column import StringColumn
from .find import _pat_array
from .substr import _span_column


def concat_pieces(src: torch.Tensor, pstart, psize, row_pieces, validity) -> StringColumn:
    """A column whose row r is the concatenation of the pieces
    row_pieces[r] .. row_pieces[r+1]-1, piece p being
    src[pstart[p] : pstart[p] + psize[p]] (one size sync)."""
    pieces = _span_column(src, pstart, psize, torch.ones_like(psize, dtype=torch.bool))
    return StringColumn(pieces.data, pieces.offsets[row_pieces.to(torch.int64)], validity)


def join(col: StringColumn, sep: str = "", na_rep: str | None = None) -> StringColumn:
    """The whole column as one row: the rows joined by `sep`, null rows
    skipped, or written as `na_rep` when it is given."""
    n, cap, dev = col.size, col.capacity, col.device
    sep_b, nar_b = _pat_array(sep, dev), _pat_array(na_rep or "", dev)
    have_nar = na_rep is not None
    body = torch.where(col.validity, col.lengths(), nar_b.shape[0] if have_nar else 0)
    counted = col.validity | have_nar
    idx = torch.arange(n, device=dev)
    # a separator after every counted row but the last one
    last = torch.where(counted, idx, -1).max() if n else -1
    dsz = torch.where(counted & (idx != last), sep_b.shape[0], 0)
    src = torch.cat([col.data, sep_b, nar_b])
    bstart = torch.where(col.validity, col.offsets[:-1], cap + sep_b.shape[0])
    pstart = torch.stack([bstart, torch.full_like(bstart, cap)], 1).flatten()
    psize = torch.stack([body, dsz.to(body.dtype)], 1).flatten()
    rows = torch.tensor([0, 2 * n], device=dev)
    return concat_pieces(src, pstart, psize, rows, torch.ones(1, dtype=torch.bool, device=dev))
