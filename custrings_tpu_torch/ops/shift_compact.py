"""Stable stream compaction and monotone expansion of parallel arrays.

Port of `compact_arrays`, `expand_to` and `expand_arrays` from
`custrings_tpu/ops/shift_compact.py`.  The JAX package moves arrays below
`pallas_route.ROUTE_MIN` elements with a log2(N)-round roll+select
network in XLA and above it with the stream kernels K4c / K4e; the
network is a TPU workaround for a missing fast scatter, so here every size
goes to K4c / K4e (`ops/route.py`) on a CUDA tensor and to their plain
versions on a CPU tensor.  K4e is a scatter, so it needs the distances
nondecreasing over the live lanes only (the JAX kernel route forward-fills
the dead lanes with a running max first).
"""

from __future__ import annotations

import torch

from .route import compact_stream, expand_stream


def compact_arrays(keep: torch.Tensor, arrays, want_k0: bool = True):
    """Stably move kept elements to the front of each array.

    keep: bool[N]; arrays: 1-D tensors of length N.  Returns (compacted
    list, k0) with k0 = int32[N+1] the exclusive prefix count of keep, or
    None in its place when want_k0 is False (the kernel then writes no
    prefix plane); positions >= k0[-1] of each output are zero."""
    return compact_stream(keep, arrays, want_k0=want_k0)


def expand_to(live: torch.Tensor, dist: torch.Tensor, arrays, out_cap: int,
              want_placed: bool = True):
    """Move live element j right to j + dist[j] in outputs of out_cap
    slots (dist >= 0, nondecreasing over live lanes).  Returns (moved
    list, placed bool[out_cap], or None when want_placed is False);
    unplaced slots are zero."""
    return expand_stream(live, dist, arrays, out_cap=out_cap, want_placed=want_placed)


def expand_arrays(live: torch.Tensor, dist: torch.Tensor, arrays, want_placed: bool = True):
    """expand_to with the output the size of the input."""
    return expand_to(live, dist, arrays, live.shape[0], want_placed)
