"""Column-level boolean regex ops: contains_re and match_re.

Port of the boolean part of `custrings_tpu/regex/ops.py` (`get_program`,
`_matches`, `contains_re`, `match_re`).  Patterns compile on the host once
per process; each length class of the column runs the bit matcher (K2) at
its own width, and ASCII-dominant columns run the packed-bit predicates
on every row and re-run only their non-ASCII rows with the 64K tables.

Not ported yet (ROADMAP queue 2): programs over 32 instructions (K2b,
the dense matcher `_matches_f32`) and rows of 2048 chars or more
(`DeviceProgram.nfa_matches_chunked`); both raise NotImplementedError.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..column import StringColumn
from ..ops import layout
from .compiler import compile_pattern
from .device import DeviceProgram
from .nfa_bits import MAX_BITS_INSTS, NFABits, pallas_supported

#: rows of at least this many chars take the chunked matcher in the JAX
#: package (`_chunk_threshold`), which is not ported yet
CHUNK_THRESHOLD = 2048


@lru_cache(maxsize=256)
def get_program(pattern: str) -> DeviceProgram:
    return DeviceProgram(compile_pattern(pattern))


@lru_cache(maxsize=256)
def _get_nfa(pattern: str) -> NFABits:
    dp = get_program(pattern)
    if not pallas_supported(dp):
        raise NotImplementedError(
            f"pattern {pattern!r} compiles to {dp.I} instructions; the bit "
            f"matcher (K2) takes at most {MAX_BITS_INSTS}, and the dense "
            "matcher K2b (pallas_nfa._matches_f32) is not ported yet "
            "(ROADMAP queue 2)"
        )
    return NFABits(dp)


def _matches(col: StringColumn, pattern: str, anchored: bool) -> torch.Tensor:
    """bool[rows]; null rows are False."""
    nfa = _get_nfa(pattern)

    def engine(chars, nch, ascii=False):
        if chars.shape[1] >= CHUNK_THRESHOLD:
            raise NotImplementedError(
                f"rows of {chars.shape[1]} chars need the chunked matcher "
                "(DeviceProgram.nfa_matches_chunked), not ported yet; "
                "K2b and the chunked route are ROADMAP queue 2"
            )
        return nfa.matches(chars, nch, anchored, ascii)

    if col.size == 0:
        return torch.zeros(0, dtype=torch.bool, device=col.device)
    bks = layout.length_buckets(col)
    if bks is None:
        chars, nch = layout.char_matrix(col)
        na = layout.row_nonascii_ids(col)
        if len(na) * 8 <= max(col.size, 1):
            m = engine(chars, nch, ascii=True)
            if len(na):
                nad = torch.from_numpy(na).to(col.device)
                m[nad] = engine(chars[nad], nch[nad])
            return m & col.validity
        return engine(chars, nch) & col.validity
    out = torch.zeros(col.size + 1, dtype=torch.bool, device=col.device)
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        out[bk.idx_s] = engine(chars, nch) & bk.vmask
    return out[: col.size]


def contains_re(col: StringColumn, pattern: str) -> torch.Tensor:
    """bool[rows]: the pattern matches somewhere in the row."""
    return _matches(col, pattern, False)


def match_re(col: StringColumn, pattern: str) -> torch.Tensor:
    """bool[rows]: the pattern matches at position 0."""
    return _matches(col, pattern, True)
