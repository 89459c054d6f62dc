"""K6: MurmurHash3_32 (seed 31) of every row.

Port of `custrings_tpu/ops/pallas_hash.py` (`hash_mm3_pallas` with the TPU
kernel `hash_rows_pallas` / `_hash_kernel`) and of its plain form
`custrings_tpu/ops/convert.py:hash_mm3` (reference semantics:
custring.inl:164-231).  The CUDA kernel is `csrc/hash.cu`: one thread per
row, staging its row through shared memory 128 bytes at a time with
16-byte loads, and writing the int64 result itself, so a call is one
launch.  The plain version below is `hash_mm3`'s:
little-endian 32-bit blocks over the zero-padded view, the tail combine,
then the fmix; it is what a column on the CPU takes.

Values are uint32, returned as int64 in [0, 2^32).  The plain version
keeps every intermediate below 2^49 in int64 (the 32-bit products are
split in 16-bit halves), so no step relies on integer overflow.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..column import StringColumn
from . import layout

MASK = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, C1), 15), C2)


def _hash_plain(col: StringColumn) -> torch.Tensor:
    """`convert.hash_mm3`: int64[rows] over the padded view."""
    w = layout.max_row_bytes(col)
    w4 = -(-w // 4) * 4
    view = layout.padded_view(col, w4).to(torch.int64)
    lens = col.lengths().to(torch.int64)
    blocks = view[:, 0::4] | (view[:, 1::4] << 8) | (view[:, 2::4] << 16) | (view[:, 3::4] << 24)
    nblocks = lens // 4
    h1 = torch.full((col.size,), 31, dtype=torch.int64, device=col.device)
    for i in range(w4 // 4):
        h = _rotl(h1 ^ _mix_k1(blocks[:, i]), 13)
        h = (h * 5 + 0xE6546B64) & MASK
        h1 = torch.where(i < nblocks, h, h1)
    tail_start = nblocks * 4
    rem = lens & 3

    def tb(i):
        idx = (tail_start + i).clamp(0, w4 - 1)
        return torch.gather(view, 1, idx[:, None])[:, 0]

    k1 = torch.zeros_like(h1)
    k1 = torch.where(rem >= 3, k1 ^ (tb(2) << 16), k1)
    k1 = torch.where(rem >= 2, k1 ^ (tb(1) << 8), k1)
    k1 = torch.where(rem >= 1, k1 ^ tb(0), k1)
    h1 = torch.where(rem > 0, h1 ^ _mix_k1(k1), h1)
    h1 = h1 ^ lens
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _hash_launch(col: StringColumn) -> torch.Tensor:
    n = col.size
    offsets = col.offsets.to(torch.int32).contiguous()
    for t in (col.data, offsets):
        kernels.require_cuda(t, "hash")
    out = torch.empty(n, dtype=torch.int64, device=col.device)
    with kernels.launched("hash"):
        err = kernels.lib().cs_hash(
            col.data.data_ptr(), col.data.shape[0], offsets.data_ptr(), n, out.data_ptr(),
            kernels.stream_ptr(col.data),
        )
        kernels.check(err, "hash")
    return out


def hash_mm3(col: StringColumn) -> torch.Tensor:
    """int64[rows]: MurmurHash3_32 with seed 31 of each row's bytes (null
    rows hash their bytes too; the facade masks them)."""
    if col.size == 0:
        return torch.zeros(0, dtype=torch.int64, device=col.device)
    if not col.data.is_cuda:
        return _hash_plain(col)
    return _hash_launch(col)
