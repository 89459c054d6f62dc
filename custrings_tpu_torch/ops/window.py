"""K1 / K1b: ragged row-window gather, as bytes or big-endian words.

Port of `custrings_tpu/ops/pallas_window.py` (`ragged_gather_i32`,
`ragged_gather`, `ragged_gather_words`; TPU kernel `_ragged_window_p`
with `_window_kernel_factory`).  The CUDA kernels are `csrc/window.cu`.

    bytes: out[r, k] = data[starts[r] + k] for k < width, 0 past the buffer
    words: out[r, q] = big-endian word of bytes [4q, 4q+4) of that window

The bytes form takes optional row lengths and then stores 0 past each
row's length (the padded views and the char matrix pass them, so they
need no masking pass of their own); without them it does not mask, nor
does the words form, whose callers mask, as the JAX callers do.  A CPU
tensor takes the plain index gather; a CUDA tensor always
launches the kernel.  The TPU's 512-lane width rounding, 4 KB DMA
alignment and SMEM row chunking are TPU workarounds and are not ported:
the requested width is the width computed.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..column import i32_bits


def _window_index(data, starts, width):
    k = torch.arange(width, dtype=torch.int64, device=data.device)
    g = starts.to(torch.int64)[:, None] + k[None, :]
    cap = data.shape[0]
    inside = (g >= 0) & (g < cap)
    return g.clamp(0, max(cap - 1, 0)), inside


def _gather_plain(data, starts, width, lengths=None):
    """uint8[rows, width]: the window, zeros outside the buffer and, with
    `lengths`, past each row's length."""
    if data.shape[0] == 0:
        return torch.zeros((starts.shape[0], width), dtype=torch.uint8, device=data.device)
    g, inside = _window_index(data, starts, width)
    if lengths is not None:
        k = torch.arange(width, dtype=torch.int64, device=data.device)
        inside &= k[None, :] < lengths.to(torch.int64)[:, None]
    return torch.where(inside, data[g], torch.zeros((), dtype=torch.uint8, device=data.device))


def _words_plain(data, starts, width):
    """int32[rows, ceil(width/4)] big-endian words of the window."""
    wq = -(-width // 4)
    b = _gather_plain(data, starts, wq * 4).to(torch.int64).view(-1, wq, 4)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return i32_bits(w).to(torch.int32)


def _check(data, starts, what, lengths=None):
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"{what}: data must be a 1-D uint8 tensor")
    if starts.dim() != 1:
        raise ValueError(f"{what}: starts must be 1-D")
    if starts.device != data.device:
        raise ValueError(f"{what}: data and starts lie on different devices")
    if lengths is not None and (lengths.shape != starts.shape or lengths.device != data.device):
        raise ValueError(f"{what}: lengths must match starts in shape and device")


def _launch_bytes(data, starts, width, out_dtype, lengths):
    starts = starts.to(torch.int32).contiguous()
    kernels.require_cuda(data, "ragged_gather")
    kernels.require_cuda(starts, "ragged_gather")
    lens_ptr = None
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
        kernels.require_cuda(lengths, "ragged_gather")
        lens_ptr = lengths.data_ptr()
    rows = starts.shape[0]
    out = torch.empty((rows, width), dtype=out_dtype, device=data.device)
    if rows == 0 or width == 0:
        return out
    with kernels.launched("window_bytes"):
        err = kernels.lib().cs_window_bytes(
            data.data_ptr(), data.shape[0], starts.data_ptr(), lens_ptr, rows, width,
            1 if out_dtype == torch.int32 else 0, out.data_ptr(),
            kernels.stream_ptr(data),
        )
        kernels.check(err, "ragged_gather")
    return out


def ragged_gather_i32(data: torch.Tensor, starts: torch.Tensor, width: int,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """int32[rows, width], one byte per element (feeds the char matrix);
    0 past each row's length when `lengths` is given."""
    _check(data, starts, "ragged_gather_i32", lengths)
    if not data.is_cuda:
        return _gather_plain(data, starts, width, lengths).to(torch.int32)
    return _launch_bytes(data, starts, width, torch.int32, lengths)


def ragged_gather(data: torch.Tensor, starts: torch.Tensor, width: int,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """uint8[rows, width]: data[starts[r] : starts[r] + width] per row;
    0 past each row's length when `lengths` is given."""
    _check(data, starts, "ragged_gather", lengths)
    if not data.is_cuda:
        return _gather_plain(data, starts, width, lengths)
    return _launch_bytes(data, starts, width, torch.uint8, lengths)


def ragged_gather_words(data: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """int32[rows, ceil(width/4)] big-endian words (read as uint32)."""
    _check(data, starts, "ragged_gather_words")
    if not data.is_cuda:
        return _words_plain(data, starts, width)
    starts = starts.to(torch.int32).contiguous()
    kernels.require_cuda(data, "ragged_gather_words")
    kernels.require_cuda(starts, "ragged_gather_words")
    rows, wq = starts.shape[0], -(-width // 4)
    out = torch.empty((rows, wq), dtype=torch.int32, device=data.device)
    if rows == 0 or wq == 0:
        return out
    with kernels.launched("window_words"):
        err = kernels.lib().cs_window_words(
            data.data_ptr(), data.shape[0], starts.data_ptr(), rows, wq,
            out.data_ptr(), kernels.stream_ptr(data),
        )
        kernels.check(err, "ragged_gather_words")
    return out
