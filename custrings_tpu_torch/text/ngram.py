"""N-grams over the rows of a column.

Port of `custrings_tpu/text/ngram.py` (ngram.cu create_ngrams:32): the
rows are the tokens; null and empty rows are removed first; output row i
joins rows [i, i+n) with the separator, and with at most n tokens the
result is their full join (ngram.cu:52-54).
"""

from __future__ import annotations

import torch

from ..column import StringColumn
from ..ops import array, combine
from ..ops.find import _pat_array


def create_ngrams(col: StringColumn, n: int = 2, separator: str = "_") -> StringColumn:
    n = max(int(n), 1)
    toks = array.gather_mask(col, col.validity & (col.lengths() > 0))
    count = toks.size
    if count <= n:
        return combine.join(toks, separator)
    if n == 1:
        return toks
    dev, cap = toks.device, toks.capacity
    sep = _pat_array(separator, dev)
    out_n = count - n + 1
    # row i's pieces: token i, the separator, token i+1, ..., token i+n-1
    tok = (torch.arange(out_n, device=dev)[:, None] + torch.arange(n, device=dev)[None, :])
    tstart, tsize = toks.offsets[:-1][tok], toks.lengths()[tok]
    pstart = torch.stack([tstart, torch.full_like(tstart, cap)], 2).flatten(1)[:, :-1]
    psize = torch.stack([tsize, torch.full_like(tsize, sep.shape[0])], 2).flatten(1)[:, :-1]
    rows = torch.arange(out_n + 1, device=dev) * (2 * n - 1)
    return combine.concat_pieces(torch.cat([toks.data, sep]), pstart.flatten(), psize.flatten(), rows,
                                 torch.ones(out_n, dtype=torch.bool, device=dev))
