"""Literal pattern helpers shared by the literal ops.

Port of `_pat_array` and `_match_mask` from `custrings_tpu/ops/find.py`.
The find/contains/startswith family itself is not ported yet (ROADMAP
queue 1, item 9).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=4096)
def _pat_array_cached(b: bytes, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy()).to(device)


def _pat_array(pat: str | bytes, device) -> torch.Tensor:
    """uint8[m] tensor of the pattern's UTF-8 bytes on `device` (cached)."""
    b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    return _pat_array_cached(b, str(device))


def _match_mask(data: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """bool[capacity]: the pattern matches starting at byte j, ignoring
    rows.  Shifts wrap around the buffer end like jnp.roll; callers fence
    each match inside its row."""
    acc = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    for t in range(pat.shape[0]):
        acc &= torch.roll(data, -t) == pat[t]
    return acc
