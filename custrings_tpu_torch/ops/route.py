"""K4c / K4e: stable stream compaction and monotone stream expansion.

Port of `custrings_tpu/ops/pallas_route.py` (`compact_stream` with the TPU
kernel `_compact_p` / `_compact_kernel_factory`, `expand_stream` with
`_expand_p` / `_expand_kernel_factory`).  The CUDA kernels are
`csrc/route.cu`.  The compaction is one pass over input tiles: each tile
counts its kept elements, takes its output offset by decoupled look-back
(or from the caller's k0 at the tile start), writes its part of k0 when
the caller wants it, and writes the runs of every plane from shared
memory with 16-byte stores, while the blocks after the last tile zero
the tails; so a call is one launch plus one memset of its status words
(none when k0 is given), and K3 never runs inside it.  The expansion is
output-driven (a pre-pass finds each input tile's first live target,
then each block assembles one output chunk of every plane in shared
memory and writes it once), so its outputs are allocated without a fill
(only the pre-pass's one-word ticket is zeroed) and every plane of a call
moves in one launch.

    compact_stream(keep, arrays, k0, want_k0)
                                           kept elements stably to the
                                           front, zeros after
    expand_stream(live, dist, arrays, m)   live element j to j + dist[j]
                                           in an output of m slots
    cover_spans(bb, ee, ok, cap)           the byte mask of disjoint spans,
                                           which a compaction then moves
    stream_expand_spans(stream, ...)       a compacted byte stream moved
                                           into per-span output slots

Planes may be uint8/bool, int32 or int64, at most 8 a call.  A CPU tensor
takes the plain version below; a CUDA tensor always launches the kernel,
at every size (the JAX package's ROUTE_MIN routing is not ported).  The
TPU tile and DMA-alignment parameters (`tile`, `align`) are TPU
workarounds and are not ported either, nor is `scatter_sorted`, the TPU's
stand-in for a scatter: `cover_spans` and `stream_expand_spans` place
their span bounds and deltas with an indexed add.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .scan import cumsum_i32

_ELEM_BYTES = {torch.uint8: 1, torch.bool: 1, torch.int32: 4, torch.int64: 8}
MAX_PLANES = 8
# the C entry points' argument array types, by plane count
_PTRS = [ctypes.c_void_p * k for k in range(MAX_PLANES + 1)]
_INTS = [ctypes.c_int * k for k in range(MAX_PLANES + 1)]


def _flag(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A bool/uint8 mask of n elements, contiguous (the kernels read
    either as bytes, nonzero set)."""
    if x.dim() != 1 or x.shape[0] != n or x.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: expected a bool[{n}] mask, got {x.dtype}{tuple(x.shape)}")
    return x.contiguous()


def _plane(a: torch.Tensor, n: int, device: int, what: str) -> torch.Tensor:
    """A contiguous 1-D plane of n elements on `device` (get_device())."""
    if a.dim() != 1 or a.shape[0] != n or a.dtype not in _ELEM_BYTES:
        raise ValueError(f"{what}: expected a 1-D uint8/bool/int32/int64 plane of {n}")
    if a.get_device() != device:
        raise ValueError(f"{what}: planes lie on different devices")
    return a.contiguous()


def _compact_plain(keep, planes, k0=None, want_k0=True):
    """compact_stream in plain torch: the CPU path, and the oracle the
    kernel is held to on the card.  keep: bool[n]; k0: int32[n + 1] or
    None (then the prefix count is a torch.cumsum)."""
    n = keep.shape[0]
    if k0 is None:
        k0 = torch.zeros(n + 1, dtype=torch.int32, device=keep.device)
        torch.cumsum(keep, 0, dtype=torch.int32, out=k0[1:])
    dest = torch.where(keep, k0[:n], n).to(torch.int64)
    outs = []
    for a in planes:
        buf = torch.zeros(n + 1, dtype=a.dtype, device=a.device)
        buf[dest] = torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))
        outs.append(buf[:n])
    return outs, (k0 if want_k0 else None)


def _compact_launch(keep, planes, k0, want_k0):
    n = keep.shape[0]
    outs = [torch.empty_like(a) for a in planes]
    if n == 0:
        k0 = torch.zeros(1, dtype=torch.int32, device=keep.device) if k0 is None else k0
        return outs, k0 if want_k0 else None
    kernels.require_cuda(keep, "compact_stream")
    lib = kernels.lib()
    k0_out = scratch = None
    if k0 is None:
        # one allocation: k0 (when wanted) rounded up to 16 bytes, then the
        # look-back's tile counter and status words, which the C entry
        # zeroes on the stream
        head = -(-(n + 1) // 4) * 4 if want_k0 else 0
        buf = torch.empty(head + 2 * lib.cs_compact_scratch_words(n), dtype=torch.int32, device=keep.device)
        k0_out = buf[: n + 1] if want_k0 else None
        scratch = buf.data_ptr() + 4 * head
    k = len(planes)
    with kernels.launched("route_compact"):
        err = lib.cs_compact(
            keep.data_ptr(), None if k0 is None else k0.data_ptr(), n, k,
            _PTRS[k](*[a.data_ptr() for a in planes]), _PTRS[k](*[o.data_ptr() for o in outs]),
            _INTS[k](*[_ELEM_BYTES[a.dtype] for a in planes]),
            None if k0_out is None else k0_out.data_ptr(), scratch, kernels.stream_ptr(keep),
        )
        kernels.check(err, "compact_stream")
    if not want_k0:
        return outs, None
    return outs, k0 if k0 is not None else k0_out


def compact_stream(keep: torch.Tensor, arrays, k0: torch.Tensor | None = None, want_k0: bool = True):
    """Stably move kept elements to the front of each array.

    keep: bool[N] (or uint8, nonzero kept); arrays: 1-D planes of length
    N, of 1, 4 or 8 bytes an element (mixed), at most 8; k0: the
    exclusive prefix count of keep, int32[N+1] with the total at k0[N],
    when the caller has it.  Returns (compacted list, k0), k0 computed
    here when not given, or None in its place when want_k0 is False;
    positions >= k0[-1] of each output are zero."""
    n = keep.shape[0]
    keep = _flag(keep, n, "compact_stream")
    dev = keep.get_device()
    planes = [_plane(a, n, dev, "compact_stream") for a in arrays]
    if len(planes) > MAX_PLANES:
        raise ValueError(f"compact_stream: at most {MAX_PLANES} planes a call")
    if k0 is not None:
        if k0.dim() != 1 or k0.shape[0] != n + 1 or k0.get_device() != dev:
            raise ValueError(f"compact_stream: k0 must be 1-D of length {n + 1}, beside keep")
        k0 = k0.to(torch.int32).contiguous()
    if not keep.is_cuda:
        return _compact_plain(keep.bool(), planes, k0, want_k0)
    return _compact_launch(keep, planes, k0, want_k0)


def _expand_plain(live, dist, planes, out_cap, want_placed):
    t = torch.arange(live.shape[0], dtype=torch.int64, device=live.device) + dist.to(torch.int64)
    ok = live & (t >= 0) & (t < out_cap)
    tgt = t[ok]
    outs = []
    for a in planes:
        out = torch.zeros(out_cap, dtype=a.dtype, device=a.device)
        out[tgt] = a[ok]
        outs.append(out)
    placed = None
    if want_placed:
        placed = torch.zeros(out_cap, dtype=torch.bool, device=live.device)
        placed[tgt] = True
    return outs, placed


def _expand_launch(live, dist, planes, out_cap, want_placed):
    n = live.shape[0]
    dev = live.device
    outs = [torch.empty(out_cap, dtype=a.dtype, device=dev) for a in planes]
    placed = torch.empty(out_cap, dtype=torch.bool, device=dev) if want_placed else None
    if out_cap == 0:
        return outs, placed
    for t in (live, dist, *planes):
        kernels.require_cuda(t, "expand_stream")
    lib = kernels.lib()
    scratch = torch.empty(lib.cs_expand_scratch_words(n), dtype=torch.int64, device=dev)
    scratch[-1:].fill_(0)  # the pre-pass's ticket: one word, not the outputs
    k = len(planes)
    with kernels.launched("route_expand"):
        err = lib.cs_expand(
            live.data_ptr(), dist.data_ptr(), n, out_cap, k,
            _PTRS[k](*[a.data_ptr() for a in planes]),
            _PTRS[k](*[o.data_ptr() for o in outs]),
            _INTS[k](*[_ELEM_BYTES[a.dtype] for a in planes]),
            placed.data_ptr() if want_placed else None, scratch.data_ptr(),
            kernels.stream_ptr(live),
        )
        kernels.check(err, "expand_stream")
    return outs, placed


def expand_stream(live: torch.Tensor, dist: torch.Tensor, arrays, out_cap: int | None = None,
                  want_placed: bool = True):
    """Monotone expansion: live element j moves right to j + dist[j].

    live: bool[N]; dist: int32[N], >= 0 and nondecreasing over live lanes
    (so no two live elements share a target; dead lanes' dist is never
    read); arrays: 1-D planes of length N, of 1, 4 or 8 bytes an element
    (mixed), at most 8.  Elements whose target is >= out_cap (default N)
    drop out; every other slot is 0.  Returns (moved planes of out_cap,
    placed bool[out_cap], or None when want_placed is False)."""
    n = live.shape[0]
    m = n if out_cap is None else int(out_cap)
    live = _flag(live, n, "expand_stream")
    if dist.dim() != 1 or dist.shape[0] != n:
        raise ValueError(f"expand_stream: dist must be 1-D of length {n}")
    dist = dist.to(torch.int32).contiguous()
    planes = [_plane(a, n, live.get_device(), "expand_stream") for a in arrays]
    if not planes or len(planes) > MAX_PLANES:
        raise ValueError(f"expand_stream: expected 1 to {MAX_PLANES} planes to move")
    if not live.is_cuda:
        return _expand_plain(live.bool(), dist, planes, m, want_placed)
    return _expand_launch(live, dist, planes, m, want_placed)


def cover_spans(bb: torch.Tensor, ee: torch.Tensor, ok: torch.Tensor, cap: int) -> torch.Tensor:
    """bool[cap]: the bytes inside the spans [bb, ee) where ok (spans
    disjoint; any shape), from +1/-1 marks at the span bounds and one
    prefix sum (K3)."""
    bb, ee = bb.reshape(-1), ee.reshape(-1)
    live = ok.reshape(-1) & (ee > bb)
    marks = torch.zeros(cap + 1, dtype=torch.int32, device=bb.device)
    marks.index_add_(0, torch.where(live, bb, cap).to(torch.int64), live.to(torch.int32))
    marks.index_add_(0, torch.where(live, ee, cap).to(torch.int64), -live.to(torch.int32))
    return cumsum_i32(marks[:cap]) > 0


def stream_expand_spans(stream, total_live, starts, sizes, okf, out_cap: int) -> torch.Tensor:
    """uint8[out_cap]: a compacted byte stream moved into per-span output
    slots, zeros elsewhere.

    stream: uint8[dom], the live spans' bytes back to back in the flat
    order of okf; total_live: how many of them there are (an int32
    scalar tensor); starts / sizes / okf: each span's output start, byte
    size and liveness.  Every byte of span k moves by the same c_k =
    starts_k - rank_k (rank_k: the stream position of its first byte),
    nondecreasing because the output starts strictly increase.  The
    live spans' (c, rank) are compacted (K4c), the telescoping deltas of
    c placed at the ranks with an indexed add and prefix-summed (K3) into
    the stream's distances, and the stream expanded once (K4e)."""
    dom = stream.shape[0]
    nS = okf.shape[0]
    dev = stream.device
    # a zero-size span owns no stream byte
    okf = okf & (sizes > 0)
    sz = torch.where(okf, sizes, 0).to(torch.int32)
    rank0 = cumsum_i32(sz) - sz
    c = (starts - rank0).to(torch.int32)
    (cc, rr), k0 = compact_stream(okf, [c, rank0])
    iv = torch.arange(nS, dtype=torch.int32, device=dev)
    okd = iv < k0[-1]
    dlt = torch.where(okd, cc - torch.where(iv > 0, torch.roll(cc, 1), 0), 0)
    dplane = torch.zeros(dom + 1, dtype=torch.int32, device=dev)
    dplane.index_add_(0, torch.where(okd, rr.clamp(max=dom), dom).to(torch.int64), dlt)
    dist = cumsum_i32(dplane[:dom])
    live = torch.arange(dom, dtype=torch.int32, device=dev) < total_live
    (plane,), _ = expand_stream(live, dist, [stream], out_cap, False)
    return plane
