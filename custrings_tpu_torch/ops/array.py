"""Row gather, append, scatter and the packed-key sort order.

Port of `custrings_tpu/ops/array.py`: `_gather_impl` / `gather`,
`gather_mask`, `append`, `scatter`, `scalar_scatter`, `remove_strings`,
`_mask_word_tails`, `_key_words`, `order` / `_order_impl` and `sort`.  Sort keys are
big-endian 32-bit words of each row's bytes, gathered by K1b
(`ragged_gather_words`) at every size, or packed from the streaming
padded view where the layout's `STREAM_VIEW_MIN` routes to it (the JAX
package's TPU route).  Keys are carried
as int64 holding the unsigned 32-bit value, so torch's signed sorts give
unsigned order; a sort over k keys is k stable single-key passes, least
significant first (the JAX package's `_LSD_ROWS` branch), at every size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import StringColumn, empty_column
from ..config import bucket_bytes
from . import layout
from .substr import _span_column
from .window import ragged_gather_words

_U32 = 0xFFFFFFFF
SORT_LENGTH = 1
SORT_NAME = 2


def _gather_impl(col: StringColumn, idx: torch.Tensor, capacity: int) -> StringColumn:
    """Rows col[idx] into a buffer of `capacity` bytes."""
    idx = idx.to(torch.int64)
    return _span_column(col.data, col.offsets[:-1][idx], col.lengths()[idx], col.validity[idx], capacity)


def gather(col: StringColumn, indexes) -> StringColumn:
    """New column of rows col[indexes[i]] (a tensor or anything numpy
    takes); negative indexes wrap."""
    if isinstance(indexes, torch.Tensor):
        idx = indexes.to(col.device, torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(indexes), dtype=torch.int64).to(col.device)
    if idx.shape[0] == 0 or col.size == 0:
        return empty_column(int(idx.shape[0]), col.device, all_null=col.size == 0)
    idx = torch.where(idx < 0, idx + col.size, idx)
    if bool(((idx < 0) | (idx >= col.size)).any()):
        raise IndexError(f"gather: index out of range for column of {col.size} rows")
    total = int(col.lengths()[idx].sum())
    return _gather_impl(col, idx, bucket_bytes(total))


def gather_mask(col: StringColumn, mask: torch.Tensor) -> StringColumn:
    """The rows where mask is True, in order (array.cu gather:117)."""
    return gather(col, torch.nonzero(mask).flatten())


def append(cols) -> StringColumn:
    """The columns' rows one after another (NVStrings.cu:113-135)."""
    dev = cols[0].device
    datas, offs, vals, shift = [], [], [], 0
    for c in cols:
        nb = c.nbytes()
        datas.append(c.data[:nb])
        offs.append(c.offsets[:-1] + shift)
        vals.append(c.validity)
        shift += nb
    datas.append(torch.zeros(bucket_bytes(shift) - shift, dtype=torch.uint8, device=dev))
    offs.append(torch.tensor([shift], dtype=torch.int32, device=dev))
    return StringColumn(torch.cat(datas), torch.cat(offs).to(torch.int32), torch.cat(vals))


def _index_tensor(indexes, device) -> torch.Tensor:
    if isinstance(indexes, torch.Tensor):
        return indexes.to(device, torch.int64)
    return torch.as_tensor(np.asarray(indexes, dtype=np.int64)).to(device)


def scatter(col: StringColumn, strs: StringColumn, indexes) -> StringColumn:
    """Rows at `indexes` (negative ones wrap) replaced by the rows of
    `strs`, in order (array.cu scatter:149)."""
    idx = _index_tensor(indexes, col.device)
    idx = torch.where(idx < 0, idx + col.size, idx)
    take = torch.arange(col.size, dtype=torch.int64, device=col.device)
    take[idx] = col.size + torch.arange(strs.size, dtype=torch.int64, device=col.device)
    return gather(append([col, strs]), take)


def scalar_scatter(col: StringColumn, one: StringColumn, indexes) -> StringColumn:
    """Rows at `indexes` replaced by the one row of `one` (array.cu
    scatter:186)."""
    take = torch.arange(col.size, dtype=torch.int64, device=col.device)
    take[_index_tensor(indexes, col.device)] = col.size
    return gather(append([col, one]), take)


def remove_strings(col: StringColumn, indexes) -> StringColumn:
    """The column without the rows at `indexes` (array.cu
    remove_strings:244); the kept ids are found on the host."""
    idx = np.asarray(indexes.cpu() if isinstance(indexes, torch.Tensor) else indexes, dtype=np.int64)
    idx = np.where(idx < 0, idx + col.size, idx)
    return gather(col, np.setdiff1d(np.arange(col.size), idx))


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
    length: by K1b, or from the streaming padded view where the layout
    routes to it."""
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


def _order_impl(col: StringColumn, width: int, stype: int = SORT_NAME, asc: bool = True,
                nullfirst: bool = True) -> torch.Tensor:
    """Row indices int64[rows] in sorted order.  Keys, most significant
    first: the null group (first or last by `nullfirst`, in either
    direction); with SORT_LENGTH the byte length; with SORT_NAME the key
    words of the first `width` bytes, then the byte length (embedded NULs
    compare as padding in the words).  Descending flips every key but the
    null group's; ties keep row order."""
    valid = col.validity.to(torch.int64)
    keys = [valid if nullfirst else 1 - valid]
    lens = col.lengths().to(torch.int64)
    lk = lens if asc else _U32 - lens
    if stype & SORT_LENGTH:
        keys.append(lk)
    if stype & SORT_NAME:
        words = _key_words(col, width)
        keys += [u32_key(words[:, i] if asc else ~words[:, i]) for i in range(words.shape[1])]
        keys.append(lk)
    return lsd_order(keys)


def order(col: StringColumn, stype: int = SORT_NAME, asc: bool = True,
          nullfirst: bool = True) -> torch.Tensor:
    """Sorted row indices (array.cu order:330): stype 1 = byte length, 2 =
    name, 3 = length then name."""
    if col.size == 0:
        return torch.zeros(0, dtype=torch.int64, device=col.device)
    width = -(-layout.max_row_bytes(col) // 4) * 4
    return _order_impl(col, width, int(stype), bool(asc), bool(nullfirst))


def sort(col: StringColumn, stype: int = SORT_NAME, asc: bool = True,
         nullfirst: bool = True) -> StringColumn:
    return gather(col, order(col, stype, asc, nullfirst))
