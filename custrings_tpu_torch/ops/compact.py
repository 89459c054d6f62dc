"""K7: stable byte compaction by a keep mask, `compact_bytes`.

Port of `custrings_tpu/ops/pallas_compact.py:compact_bytes` (TPU kernel
`_compact_p` / `_compact_kernel`).  The CUDA kernel is `csrc/compact.cu`:
one pass over 8,192-byte input tiles that counts the kept bytes, takes
each tile's output offset by decoupled look-back and writes its run of
kept bytes, while the blocks after the last tile zero the output's tail;
so the prefix count is never written out, and a call is one launch plus
the fill of its scratch status words.  It takes every `out_cap`, so the
TPU's window-overflow test and its scatter fallback have no counterpart.
The plain version is a masked select into a zero buffer; a CPU tensor
takes it.

`urlencode.url_decode` writes its output with it (in the JAX package
nothing calls it).
"""

from __future__ import annotations

import torch

from .. import kernels


def _compact_plain(data: torch.Tensor, keep: torch.Tensor, out_cap: int) -> torch.Tensor:
    kept = torch.masked_select(data, keep)[:out_cap]
    out = torch.zeros(out_cap, dtype=torch.uint8, device=data.device)
    out[: kept.shape[0]] = kept
    return out


def _compact_launch(data: torch.Tensor, keep8: torch.Tensor, out_cap: int) -> torch.Tensor:
    out = torch.empty(out_cap, dtype=torch.uint8, device=data.device)
    if out_cap == 0:
        return out
    for t in (data, keep8):
        kernels.require_cuda(t, "compact_bytes")
    lib = kernels.lib()
    # the tile counter and status words start at 0 on every call
    scratch = torch.zeros(lib.cs_compact_bytes_scratch_words(data.shape[0]), dtype=torch.int64,
                          device=data.device)
    with kernels.launched("compact_bytes"):
        err = lib.cs_compact_bytes(
            data.data_ptr(), keep8.data_ptr(), data.shape[0], out_cap, out.data_ptr(),
            scratch.data_ptr(), kernels.stream_ptr(data),
        )
        kernels.check(err, "compact_bytes")
    return out


def compact_bytes(data: torch.Tensor, keep: torch.Tensor, out_cap: int) -> torch.Tensor:
    """uint8[out_cap]: the bytes of `data` where `keep`, stably compacted,
    then zeros (kept bytes past out_cap drop out)."""
    cap = data.shape[0]
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"compact_bytes: expected a uint8 buffer, got {data.dtype}{tuple(data.shape)}")
    if keep.shape != (cap,) or keep.dtype not in (torch.bool, torch.uint8) or keep.device != data.device:
        raise ValueError(f"compact_bytes: expected a bool[{cap}] mask beside the data")
    out_cap = int(out_cap)
    keep8 = keep.contiguous().view(torch.uint8)
    if not data.is_cuda:
        return _compact_plain(data, keep8.bool(), out_cap)
    return _compact_launch(data.contiguous(), keep8, out_cap)
