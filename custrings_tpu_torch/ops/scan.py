"""K3: inclusive int32 prefix sum and prefix max over 1-D tensors.

Port of `custrings_tpu/ops/pallas_scan.py` (`cumsum_i32`, `cummax_i32`;
TPU kernel `_scan_pallas` with `_cumsum_kernel` / `_cummax_kernel`).  The
CUDA kernel is `csrc/scan.cu`, a three-phase scan (block scans, a scan of
the block totals, a carry pass).

A CPU tensor takes the plain PyTorch version; a CUDA tensor always
launches the kernel, at every size (the JAX package's PSCAN_MIN routing
existed for XLA's log-pass lowering on the TPU and is not ported).
"""

from __future__ import annotations

import torch

from .. import kernels

_DTYPE_CODE = {torch.uint8: 0, torch.bool: 0, torch.int8: 1, torch.int32: 2}


def _cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def _cummax_plain(x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cummax(x.to(torch.int32), 0).values


def _launch(x: torch.Tensor, op: int, counter: str) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError(f"scan: expected a 1-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        x = x.to(torch.int32)  # other integer types: widen/narrow as the TPU does
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    x = x.contiguous()
    kernels.require_cuda(x, "scan")
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    lib = kernels.lib()
    scratch = torch.empty(
        max(lib.cs_scan_scratch_elems(n), 1), dtype=torch.int32, device=x.device
    )
    err = lib.cs_scan(
        x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), n, op,
        scratch.data_ptr(), kernels.stream_ptr(x),
    )
    kernels.check(err, "scan")
    kernels.LAUNCHES[counter] += 1
    return out


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a uint8/int8/int32/bool tensor,
    wrapping modulo 2^32 like the TPU's int32 arithmetic."""
    if not x.is_cuda:
        return _cumsum_plain(x)
    return _launch(x, 0, "scan_sum")


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix max (identity INT32_MIN)."""
    if not x.is_cuda:
        return _cummax_plain(x)
    return _launch(x, 1, "scan_max")
