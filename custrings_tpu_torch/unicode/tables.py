"""Unicode classification and case tables.

Port of `custrings_tpu/unicode/tables.py`: the same 65,536-entry flag and
opposite-case tables, generated from Python's `unicodedata`.  The `.npz`
cache lives under `build/custrings_tpu_torch/`, outside both packages.

Flag bits: 1 = decimal, 2 = numeric, 4 = digit, 8 = alpha, 16 = space,
32 = upper, 64 = lower.  isalnum == (flags & 15) != 0.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

TABLE_SIZE = 65536

FLAG_DECIMAL = 1
FLAG_NUMERIC = 2
FLAG_DIGIT = 4
FLAG_ALPHA = 8
FLAG_SPACE = 16
FLAG_UPPER = 32
FLAG_LOWER = 64
FLAG_ALPHANUM = 15

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE = os.path.join(_ROOT, "build", "custrings_tpu_torch", "_tables.npz")


def _generate() -> tuple[np.ndarray, np.ndarray]:
    flags = np.zeros(TABLE_SIZE, dtype=np.uint8)
    cases = np.arange(TABLE_SIZE, dtype=np.uint16)
    for cp in range(TABLE_SIZE):
        ch = chr(cp)
        f = 0
        if ch.isdecimal():
            f |= FLAG_DECIMAL
        if ch.isnumeric():
            f |= FLAG_NUMERIC
        if ch.isdigit():
            f |= FLAG_DIGIT
        if ch.isalpha():
            f |= FLAG_ALPHA
        if ch.isspace():
            f |= FLAG_SPACE
        if ch.isupper():
            f |= FLAG_UPPER
        if ch.islower():
            f |= FLAG_LOWER
        flags[cp] = f
        # 16-bit 1:1 opposite case; multi-codepoint casings take the first
        # codepoint of the full casing (ß -> 'S'), as the reference table does
        if f & FLAG_UPPER:
            low = ch.lower()
            if low != ch and ord(low[0]) < TABLE_SIZE:
                cases[cp] = ord(low[0])
        elif f & FLAG_LOWER:
            up = ch.upper()
            if up != ch and ord(up[0]) < TABLE_SIZE:
                cases[cp] = ord(up[0])
    return flags, cases


@lru_cache(maxsize=1)
def host_tables() -> tuple[np.ndarray, np.ndarray]:
    if os.path.exists(_CACHE):
        with np.load(_CACHE) as z:
            if int(z["cases"][0xDF]) == ord("S"):  # cache-format check
                return z["flags"], z["cases"]
    flags, cases = _generate()
    try:
        os.makedirs(os.path.dirname(_CACHE), exist_ok=True)
        tmp = f"{_CACHE}.{os.getpid()}.tmp.npz"
        np.savez(tmp, flags=flags, cases=cases)
        os.replace(tmp, _CACHE)
    except OSError:
        pass
    return flags, cases


@lru_cache(maxsize=8)
def device_tables(device):
    """(flags uint8[65536], cases int32[65536]) as tensors on `device`."""
    import torch

    flags, cases = host_tables()
    return (
        torch.from_numpy(flags.copy()).to(device),
        torch.from_numpy(cases.astype(np.int32)).to(device),
    )
