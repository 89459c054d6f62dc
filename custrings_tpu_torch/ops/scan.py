"""K3: int32 prefix sum and prefix max over 1-D tensors.

Port of `custrings_tpu/ops/pallas_scan.py` (`cumsum_i32`, `cummax_i32`;
TPU kernel `_scan_pallas` with `_cumsum_kernel` / `_cummax_kernel`).  The
CUDA kernel is `csrc/scan.cu`, a single-pass scan with decoupled look-back:
one launch per call, each element read once and its result written once.
Besides the inclusive scans it writes two forms straight into the tensor
it returns: the exclusive scan with the total appended (`cumsum0_i32`,
`cummax0_i32`: int32[n+1] with out[0] = 0) and `cumsum_row_ids`, whose
"- 1" and clamp ride on the kernel's store.

A CPU tensor takes the plain PyTorch version; a CUDA tensor always
launches the kernel, at every size (the JAX package's PSCAN_MIN routing
existed for XLA's log-pass lowering on the TPU and is not ported).
"""

from __future__ import annotations

import torch

from .. import kernels

_DTYPE_CODE = {torch.uint8: 0, torch.bool: 0, torch.int8: 1, torch.int32: 2}
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def _cummax_plain(x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cummax(x.to(torch.int32), 0).values


def _shifted(y: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(y.shape[0] + 1, dtype=torch.int32, device=y.device)
    out[1:] = y
    return out


def _cumsum0_plain(x: torch.Tensor) -> torch.Tensor:
    return _shifted(_cumsum_plain(x))


def _cummax0_plain(x: torch.Tensor) -> torch.Tensor:
    return _shifted(_cummax_plain(x))


def _row_ids_plain(marks: torch.Tensor, nrows: int) -> torch.Tensor:
    return (_cumsum_plain(marks) - 1).clamp(0, max(nrows - 1, 0))


def _launch(x: torch.Tensor, op: int, counter: str, shift: int = 0,
            add: int = 0, lo: int = _I32_MIN, hi: int = _I32_MAX) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError(f"scan: expected a 1-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        x = x.to(torch.int32)  # other integer types: widen/narrow as the TPU does
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    x = x.contiguous()
    kernels.require_cuda(x, "scan")
    n = x.shape[0]
    if n == 0:
        return torch.zeros(shift, dtype=torch.int32, device=x.device)
    lib = kernels.lib()
    out = torch.empty(n + shift, dtype=torch.int32, device=x.device)
    # the tile counter and status words start at 0 on every call
    scratch = torch.zeros(lib.cs_scan_scratch_words(n), dtype=torch.int64, device=x.device)
    with kernels.launched(counter):
        err = lib.cs_scan(
            x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), n, op, shift, add, lo, hi,
            scratch.data_ptr(), kernels.stream_ptr(x),
        )
        kernels.check(err, "scan")
    if counter == "scan_sum":
        kernels.SCAN_SUM_SIZES["capacity" if n >= 1 << 24 else "rows"] += 1
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


def cumsum0_i32(x: torch.Tensor) -> torch.Tensor:
    """int32[n+1]: 0, then the inclusive prefix sum (the exclusive scan
    with the total appended), in one launch and no copy."""
    if not x.is_cuda:
        return _cumsum0_plain(x)
    return _launch(x, 0, "scan_sum", shift=1)


def cummax0_i32(x: torch.Tensor) -> torch.Tensor:
    """int32[n+1]: 0, then the inclusive prefix max."""
    if not x.is_cuda:
        return _cummax0_plain(x)
    return _launch(x, 1, "scan_max", shift=1)


def cumsum_row_ids(marks: torch.Tensor, nrows: int) -> torch.Tensor:
    """clamp(cumsum(marks) - 1, 0, max(nrows - 1, 0)): the row of each
    position from the row-start marks, in one launch."""
    if not marks.is_cuda:
        return _row_ids_plain(marks, nrows)
    return _launch(marks, 0, "scan_sum", add=-1, lo=0, hi=max(nrows - 1, 0))
