"""Joining a column's rows, rows built from pieces, and `cat`.

Port of `custrings_tpu/ops/combine.py`: `cat` (combine.cu cat:31) and
`join` (join:291).  A row of `cat` is null where either side is null and
no `na_rep` is given (combine.cu:66-69).
Every row built from pieces (the join here, and nvtext's n-grams,
normalized spaces and replaced tokens) is one pass: the pieces' bytes are
written back to back by one materialization over the output
(`substr._span_column`), and each output row is a run of pieces.
"""

from __future__ import annotations

import torch

from ..column import StringColumn, build_column
from . import layout
from .find import _pat_array
from .modify import _piece_byte
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


def cat(col: StringColumn, others: StringColumn, sep: str | None = None,
        na_rep: str | None = None) -> StringColumn:
    """Row i: col[i], sep, others[i]; a null side is `na_rep` when it is
    given, else the row is null.  The output offsets are one prefix sum
    of the rows' sizes (K3)."""
    if others.size != col.size:
        raise ValueError("nvstrings.cat sizes do not match")
    sep_b, nar_b = _pat_array(sep or "", col.device), _pat_array(na_rep or "", col.device)
    sep_n, nar_n, have_nar = sep_b.shape[0], nar_b.shape[0], na_rep is not None
    lval, rval = col.validity, others.validity
    out_null = (~lval | ~rval) & (not have_nar)
    lsz = torch.where(lval, col.lengths(), nar_n if have_nar else 0)
    rsz = torch.where(rval, others.lengths(), nar_n if have_nar else 0)
    sizes = torch.where(out_null, 0, lsz + sep_n + rsz)
    lstart, rstart = col.offsets[:-1], others.offsets[:-1]

    def produce(rows, k, valid, bcast):
        ls = bcast(lsz)
        kl, kr = k.clamp(min=0), (k - ls - sep_n).clamp(min=0)
        left = torch.where(bcast(lval) == 1, layout.gather_bytes(col.data, bcast(lstart) + kl),
                           _piece_byte(nar_b, kl))
        right = torch.where(bcast(rval) == 1, layout.gather_bytes(others.data, bcast(rstart) + kr),
                            _piece_byte(nar_b, kr))
        return torch.where(k < ls, left, torch.where(k < ls + sep_n, _piece_byte(sep_b, k - ls), right))

    return build_column(sizes, ~out_null, produce)
