"""K4c / K4e: stable stream compaction and monotone stream expansion.

Port of `custrings_tpu/ops/pallas_route.py` (`compact_stream` with the TPU
kernel `_compact_p` / `_compact_kernel_factory`, `expand_stream` with
`_expand_p` / `_expand_kernel_factory`).  The CUDA kernels are
`csrc/route.cu`: one scatter per element, since Hopper stores to any
address in one instruction and the TPU's in-register routing network and
VMEM ring buffer exist only because the TPU has no fast scatter.

    compact_stream(keep, arrays)           kept elements stably to the
                                           front, zeros after
    expand_stream(live, dist, arrays, m)   live element j to j + dist[j]
                                           in an output of m slots

Planes may be uint8/bool, int32 or int64.  A CPU tensor takes the plain
version below; a CUDA tensor always launches the kernel, at every size
(the JAX package's ROUTE_MIN routing is not ported).  The TPU tile and
DMA-alignment parameters (`tile`, `align`) are TPU workarounds and are
not ported either.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..column import cumsum0

_ELEM_BYTES = {torch.uint8: 1, torch.bool: 1, torch.int32: 4, torch.int64: 8}


def _flag(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A bool/uint8 mask of n elements as contiguous uint8."""
    if x.dim() != 1 or x.shape[0] != n or x.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: expected a bool[{n}] mask, got {x.dtype}{tuple(x.shape)}")
    return x.contiguous().view(torch.uint8)


def _plane(a: torch.Tensor, n: int, device, what: str) -> torch.Tensor:
    if a.dim() != 1 or a.shape[0] != n or a.dtype not in _ELEM_BYTES:
        raise ValueError(f"{what}: expected a 1-D uint8/bool/int32/int64 plane of {n}")
    if a.device != device:
        raise ValueError(f"{what}: planes lie on different devices")
    return a.contiguous()


def _compact_plain(keep, k0, a):
    n = keep.shape[0]
    dest = torch.where(keep, k0[:n], n).to(torch.int64)
    buf = torch.zeros(n + 1, dtype=a.dtype, device=a.device)
    buf[dest] = torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))
    return buf[:n]


def _compact_launch(keep, k0, a):
    n = keep.shape[0]
    out = torch.empty_like(a)
    if n == 0:
        return out
    for t in (keep, k0, a):
        kernels.require_cuda(t, "compact_stream")
    err = kernels.lib().cs_compact(
        keep.data_ptr(), k0.data_ptr(), a.data_ptr(), n, _ELEM_BYTES[a.dtype],
        out.data_ptr(), kernels.stream_ptr(a),
    )
    kernels.check(err, "compact_stream")
    kernels.LAUNCHES["route_compact"] += 1
    return out


def compact_stream(keep: torch.Tensor, arrays, k0: torch.Tensor | None = None):
    """Stably move kept elements to the front of each array.

    keep: bool[N]; arrays: 1-D planes of length N.  Returns (compacted
    list, k0) with k0 = int32[N+1] the exclusive prefix count of keep
    (K3); positions >= k0[-1] of each output are zero."""
    n = keep.shape[0]
    keep8 = _flag(keep, n, "compact_stream")
    if k0 is None:
        k0 = cumsum0(keep8)
    k0 = k0.to(torch.int32).contiguous()
    planes = [_plane(a, n, keep.device, "compact_stream") for a in arrays]
    if not keep.is_cuda:
        return [_compact_plain(keep8.bool(), k0, a) for a in planes], k0
    return [_compact_launch(keep8, k0, a) for a in planes], k0


def _expand_plain(live, dist, a, out_cap, with_placed):
    t = torch.arange(live.shape[0], dtype=torch.int64, device=a.device) + dist.to(torch.int64)
    ok = live & (t >= 0) & (t < out_cap)
    tgt = t[ok]
    out = torch.zeros(out_cap, dtype=a.dtype, device=a.device)
    out[tgt] = a[ok]
    placed = None
    if with_placed:
        placed = torch.zeros(out_cap, dtype=torch.bool, device=a.device)
        placed[tgt] = True
    return out, placed


def _expand_launch(live, dist, a, out_cap, with_placed):
    n = live.shape[0]
    out = torch.zeros(out_cap, dtype=a.dtype, device=a.device)
    placed = torch.zeros(out_cap, dtype=torch.bool, device=a.device) if with_placed else None
    if n == 0 or out_cap == 0:
        return out, placed
    for t in (live, dist, a):
        kernels.require_cuda(t, "expand_stream")
    err = kernels.lib().cs_expand(
        live.data_ptr(), dist.data_ptr(), a.data_ptr(), n, out_cap, _ELEM_BYTES[a.dtype],
        out.data_ptr(), placed.data_ptr() if with_placed else None, kernels.stream_ptr(a),
    )
    kernels.check(err, "expand_stream")
    kernels.LAUNCHES["route_expand"] += 1
    return out, placed


def expand_stream(live: torch.Tensor, dist: torch.Tensor, arrays, out_cap: int | None = None):
    """Monotone expansion: live element j moves right to j + dist[j].

    live: bool[N]; dist: int32[N], >= 0 and nondecreasing over live lanes
    (so no two live elements share a target); arrays: 1-D planes of
    length N.  Elements whose target is >= out_cap (default N) drop out.
    Returns (moved planes of out_cap, placed bool[out_cap])."""
    n = live.shape[0]
    m = n if out_cap is None else int(out_cap)
    live8 = _flag(live, n, "expand_stream")
    if dist.dim() != 1 or dist.shape[0] != n:
        raise ValueError(f"expand_stream: dist must be 1-D of length {n}")
    dist = dist.to(torch.int32).contiguous()
    planes = [_plane(a, n, live.device, "expand_stream") for a in arrays]
    if not planes:
        raise ValueError("expand_stream: no planes to move")
    if not live.is_cuda:
        fn, live_m = _expand_plain, live8.bool()
    else:
        fn, live_m = _expand_launch, live8
    outs = [fn(live_m, dist, a, m, i == 0) for i, a in enumerate(planes)]
    return [o for o, _ in outs], outs[0][1]
