"""Seeded generators of the benchmark's string columns.

A generator module exposes `generate(config, rows, seed, shard)` and
returns `HostColumn`: host arrays that both the program (after ingest)
and the reference read.  Configurations name their generator by module
name under `strbench/gen/`.
"""

from __future__ import annotations

import dataclasses

from concurrent.futures import ThreadPoolExecutor

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

#: pieces a block and threads of gather_pieces
_BLOCK = 1 << 16
_THREADS = 8


@dataclasses.dataclass
class HostColumn:
    data: np.ndarray  # uint8[nbytes]
    offsets: np.ndarray  # int32[rows + 1]
    validity: np.ndarray  # bool[rows]

    @property
    def rows(self) -> int:
        return int(self.validity.shape[0])

    def to_list(self) -> list:
        """The rows as Python bytes, None for a null row."""
        buf = self.data.tobytes()
        off = self.offsets.tolist()
        return [buf[off[i]:off[i + 1]] if v else None
                for i, v in enumerate(self.validity.tolist())]


def seed_words(seed: int, *more: int) -> list[int]:
    """A SeedSequence entropy list for any whole-number seed (negative or
    past 64 bits included)."""
    return [int(seed) % (1 << 64), *more]


def gather_pieces(src: np.ndarray, starts: np.ndarray, lens: np.ndarray, max_len: int):
    """Concatenate src[starts[k] : starts[k] + lens[k]] for every k, each
    piece at most max_len bytes.

    Returns (bytes uint8[sum(lens)], piece offsets int64[k + 1]).  Pieces
    are copied as rows of a sliding window over src, a block of them a
    thread."""
    lens = lens.astype(np.int64)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if offs[-1] == 0:
        return np.zeros(0, np.uint8), offs
    win = sliding_window_view(np.concatenate([src, np.zeros(max_len, np.uint8)]), max_len)
    keep = np.arange(max_len)

    def block(lo):
        hi = min(lo + _BLOCK, len(lens))
        return win[starts[lo:hi]][keep < lens[lo:hi, None]]

    with ThreadPoolExecutor(_THREADS) as ex:
        parts = list(ex.map(block, range(0, len(lens), _BLOCK)))
    return np.concatenate(parts), offs


def joined_table(strings) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bytes, starts int64, lengths int64) of strings stored back to back."""
    enc = [s.encode("utf-8") for s in strings]
    lens = np.array([len(e) for e in enc], np.int64)
    starts = np.zeros(len(enc), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.frombuffer(b"".join(enc), np.uint8), starts, lens
