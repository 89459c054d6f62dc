"""Row gather and the packed-key sort order.

Port of `custrings_tpu/ops/array.py`: `_gather_impl` / `gather`,
`_mask_word_tails`, `_key_words` and `_order_impl`.  Sort keys are
big-endian 32-bit words of each row's bytes: below the layout's
`STREAM_VIEW_MIN` gathered by K1b (`ragged_gather_words`), from it packed
from the streaming padded view, as in the JAX package.  Keys are carried
as int64 holding the unsigned 32-bit value, so torch's signed sorts give
unsigned order; a sort over k keys is k stable single-key passes, least
significant first (the JAX package's `_LSD_ROWS` branch), at every size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import StringColumn, cumsum0, empty_column, materialize_bytes
from ..config import bucket_bytes
from . import layout
from .window import ragged_gather_words

_U32 = 0xFFFFFFFF


def _gather_impl(col: StringColumn, idx: torch.Tensor, capacity: int) -> StringColumn:
    """Rows col[idx] into a buffer of `capacity` bytes."""
    idx = idx.to(torch.int64)
    starts = col.offsets[:-1][idx]
    sizes = col.lengths()[idx]
    validity = col.validity[idx]
    out_offsets = cumsum0(sizes)
    cap_in = col.capacity

    def produce(rows, k, valid, bcast):
        src = (bcast(starts) + k).clamp(0, cap_in - 1).to(torch.int64)
        return col.data[src]

    data = materialize_bytes(out_offsets, capacity, produce)
    return StringColumn(data, out_offsets, validity)


def gather(col: StringColumn, indexes) -> StringColumn:
    """New column of rows col[indexes[i]]; negative indexes wrap."""
    idx = torch.as_tensor(np.asarray(indexes), dtype=torch.int64).to(col.device)
    if idx.shape[0] == 0 or col.size == 0:
        return empty_column(int(idx.shape[0]), col.device, all_null=col.size == 0)
    idx = torch.where(idx < 0, idx + col.size, idx)
    if bool(((idx < 0) | (idx >= col.size)).any()):
        raise IndexError(f"gather: index out of range for column of {col.size} rows")
    total = int(col.lengths()[idx].sum())
    return _gather_impl(col, idx, bucket_bytes(total))


def _mask_word_tails(be: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Zero the bytes of big-endian words past each row's length (words
    are int32 holding uint32 bits; word k covers bytes [4k, 4k+4))."""
    k4 = torch.arange(be.shape[1], dtype=torch.int32, device=be.device)[None, :] * 4
    valid = (lens.to(torch.int32)[:, None] - k4).clamp(0, 4)
    # keep the leading `valid` bytes: ~0 << 8*(4-valid), as int32 bits
    shift = (4 - valid) * 8
    mask = torch.where(
        valid >= 4,
        torch.full_like(valid, -1),
        torch.where(valid == 0, torch.zeros_like(valid), (-1 << shift.clamp(max=24))),
    )
    return be & mask


def _pack_words(view: torch.Tensor) -> torch.Tensor:
    """int32[rows, width/4] big-endian words of a uint8[rows, width] view:
    each group of four bytes reversed and read as one little-endian
    int32, which is the big-endian word's bit pattern."""
    n, w = view.shape
    return view.view(n, w // 4, 4).flip(-1).contiguous().view(torch.int32).view(n, w // 4)


def _key_words(col: StringColumn, width: int) -> torch.Tensor:
    """int32[rows, width/4] big-endian words of each row's first `width`
    bytes (uint32 bits; width a multiple of 4), zero past the row's
    length: from the streaming padded view at the layout's stream sizes,
    by K1b otherwise."""
    if layout._use_stream_view(col, width):
        be = _pack_words(layout.padded_view(col, width))
    else:
        be = ragged_gather_words(col.data, col.offsets[:-1], width)
    return _mask_word_tails(be, col.lengths())


def u32_key(x: torch.Tensor) -> torch.Tensor:
    """int64 holding the unsigned value of 32-bit words."""
    return x.to(torch.int64) & _U32


def lsd_order(keys) -> torch.Tensor:
    """Stable lexicographic order of rows under `keys` (most significant
    first): one stable single-key sort per key, least significant first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for key in reversed(keys):
        idx = torch.sort(key[perm], stable=True).indices
        perm = perm[idx]
    return perm


def _order_impl(col: StringColumn, width: int):
    """Row indices int64[rows] in ascending name order with nulls first:
    the JAX `_order_impl` for its one caller here (SORT_NAME, ascending,
    null first).  Keys: validity, the key words, then the byte length."""
    words = _key_words(col, width)
    keys = [col.validity.to(torch.int64)]
    keys += [u32_key(words[:, i]) for i in range(words.shape[1])]
    keys.append(col.lengths().to(torch.int64))
    return lsd_order(keys)
