"""Levenshtein edit distance and the Porter stemmer measure.

Port of `custrings_tpu/text/distance.py` (edit_distance.cu, stemmer.cu).
The distance is a Wagner-Fischer DP with every row at once: one step per
target char over [rows, width + 1] planes, in which the dependence of
each cell on its left neighbour is a running minimum along the row
(`torch.cummin`).  The rows' codepoints come from the char matrix
(`layout.char_matrix`, on K1); its padding past each row's chars never
reaches the cells the result is read from.
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0
from ..ops import layout, segments
from ..ops.split import _row_first_chars


def _char_matrix(col: StringColumn):
    """(int32[rows, width] codepoints, int32[rows] char counts) at the
    column's longest row."""
    return layout.char_matrix(col, max(layout.max_row_bytes(col), 1))


def _dp_step(prev, sub_cost, first, k):
    """The DP row after one more target char: cur[0] = first, cur[k] =
    min(prev[k] + 1, cur[k-1] + 1, prev[k-1] + sub_cost[k-1]), the cur[k-1]
    term being a running min of seed[p] + (k - p)."""
    seed = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + sub_cost)
    seed = torch.cat([torch.full_like(prev[:, :1], first), seed], dim=1)
    return torch.cummin(seed - k, dim=1).values + k


def _ed_scalar_mat(mat, nch, validity, tgt: list[int]) -> torch.Tensor:
    """Distances of the rows of a char matrix to the target codepoints."""
    n, w = mat.shape
    k = torch.arange(w + 1, dtype=torch.int32, device=mat.device)[None, :]
    cur = k.expand(n, w + 1)
    for ti, tc in enumerate(tgt):
        cur = _dp_step(cur, (mat != tc).to(torch.int32), ti + 1, k)
    d = torch.gather(cur, 1, nch.clamp(max=w).to(torch.int64)[:, None])[:, 0]
    return torch.where(validity, d, 0)


def edit_distance_scalar(col: StringColumn, target: str) -> torch.Tensor:
    """int32[rows]: the Levenshtein distance of each row to `target`
    (edit_distance.cu:119), 0 for null rows.  The DP runs per length class
    (`layout.length_buckets`), so one long row does not widen every row's
    planes."""
    tgt = [ord(c) for c in target]
    bks = layout.length_buckets(col)
    if bks is None:
        mat, nch = _char_matrix(col)
        return _ed_scalar_mat(mat, nch, col.validity, tgt)
    out = torch.zeros(col.size + 1, dtype=torch.int32, device=col.device)
    for bk in bks:
        mat, nch = layout.char_matrix_rows(col, bk)
        out[bk.idx_s] = _ed_scalar_mat(mat, nch, bk.vmask, tgt)
    return out[: col.size]


def edit_distance_pairwise(col: StringColumn, other: StringColumn) -> torch.Tensor:
    """int32[rows]: the distance between row i of each column
    (edit_distance.cu:172), 0 where either is null."""
    a, alen = _char_matrix(col)
    b, blen = _char_matrix(other)
    n, w1 = a.shape
    k = torch.arange(w1 + 1, dtype=torch.int32, device=a.device)[None, :]
    cur = k.expand(n, w1 + 1)
    for ti in range(b.shape[1]):
        nxt = _dp_step(cur, (a != b[:, ti : ti + 1]).to(torch.int32), ti + 1, k)
        cur = torch.where((ti < blen)[:, None], nxt, cur)  # rows past their target stay
    d = torch.gather(cur, 1, alen.to(torch.int64)[:, None])[:, 0]
    return torch.where(col.validity & other.validity, d, 0)


def porter_stemmer_measure(col: StringColumn, vowels: str = "aeiou", y_char: str = "y") -> torch.Tensor:
    """int32[rows]: the number of vowel-consonant sequences in each row
    (stemmer.cu:29-104).  A char is a vowel if it is in `vowels`; `y_char`
    is a consonant at a row's start and after a vowel, a vowel after a
    consonant; any other char is a consonant.  0 for null rows."""
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    c = torch.arange(cps.shape[0], dtype=torch.int32, device=col.device)
    row_first = _row_first_chars(cm, cps.shape[0])
    plain_vowel = torch.zeros_like(cps, dtype=torch.bool)
    for v in set(vowels):
        plain_vowel |= cps == ord(v)
    # a run of y after a determined char (a vowel, any other char, or a
    # row's first) alternates: its i-th y is a consonant iff the
    # determined char is a consonant XOR i is odd
    determined = plain_vowel | (cps != ord(y_char)) | row_first
    det = segments.cummax(torch.where(determined, c, -1))
    det_cons = ~plain_vowel
    odd = (c - det) % 2 == 1
    cons = torch.where(determined, det_cons, det_cons[det.clamp(min=0).to(torch.int64)] ^ odd)
    cvalid = c < cm.cs0[-1]
    vowel = ~cons & cvalid
    prev_vowel = torch.cat([vowel.new_zeros(1), vowel[:-1]]) & ~row_first
    vc = cons & cvalid & prev_vowel
    counts = segments.per_row_of_prefix(cumsum0(vc), cm.char_offsets)
    return torch.where(col.validity, counts, 0).to(torch.int32)
