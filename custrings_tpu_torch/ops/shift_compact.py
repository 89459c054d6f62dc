"""Stable stream compaction of parallel arrays by a keep mask.

Port of `compact_arrays` from `custrings_tpu/ops/shift_compact.py`.  The
JAX package moves arrays below `pallas_route.ROUTE_MIN` elements with a
log2(N)-round roll+select network in XLA and above it with the stream
compaction kernel K4c; the network is a TPU workaround for a missing fast
scatter, so here every size goes to K4c (`ops/route.py`) on a CUDA tensor
and to its plain masked select on a CPU tensor.
"""

from __future__ import annotations

import torch

from .route import compact_stream


def compact_arrays(keep: torch.Tensor, arrays):
    """Stably move kept elements to the front of each array.

    keep: bool[N]; arrays: 1-D tensors of length N.  Returns (compacted
    list, k0) with k0 = int32[N+1] the exclusive prefix count of keep;
    positions >= k0[-1] of each output are zero."""
    return compact_stream(keep, arrays)
