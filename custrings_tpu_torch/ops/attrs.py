"""Row attributes: lengths and character-class predicates.

Port of `custrings_tpu/ops/attrs.py`.  Every char of the column is
classified at once through the flag table (`unicode/tables.py`), and a
row's verdict is its count of matching (or offending) chars, taken from
one prefix count over the char domain (K3).  Codepoints past the 16-bit
table clip to U+FFFF, whose flags are 0, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0
from ..unicode.tables import (
    FLAG_ALPHA,
    FLAG_ALPHANUM,
    FLAG_DECIMAL,
    FLAG_DIGIT,
    FLAG_LOWER,
    FLAG_NUMERIC,
    FLAG_SPACE,
    FLAG_UPPER,
    device_tables,
)
from . import layout


def len_chars(col: StringColumn) -> torch.Tensor:
    """Characters per row; -1 for nulls."""
    return torch.where(col.validity, layout.char_counts(col), -1)


def byte_count(col: StringColumn) -> torch.Tensor:
    """Bytes per row; -1 for nulls."""
    return torch.where(col.validity, col.lengths(), -1)


def _char_flags(col: StringColumn) -> torch.Tensor:
    """int32[capacity]: the table flags of the column's c-th char (garbage
    past its last char)."""
    flags, _ = device_tables(col.device)
    cp = layout.codepoints(col)
    return flags[cp.clamp(0, flags.shape[0] - 1).to(torch.int64)].to(torch.int32)


def _per_row(col: StringColumn, hits: torch.Tensor) -> torch.Tensor:
    """int32[rows]: the hits among each row's chars (one K3 count)."""
    cnt0 = cumsum0(hits)
    co = layout.char_map(col).char_offsets.to(torch.int64)
    return cnt0[co[1:]] - cnt0[co[:-1]]


def _all_chars_match(col: StringColumn, flag_mask: int) -> torch.Tensor:
    """bool[rows]: valid, non-empty, and every char has a flag of
    flag_mask."""
    nch = layout.char_counts(col)
    ok = (_char_flags(col) & flag_mask) > 0
    return (nch > 0) & (_per_row(col, ok) == nch) & col.validity


def isalnum(col):
    return _all_chars_match(col, FLAG_ALPHANUM)


def isalpha(col):
    return _all_chars_match(col, FLAG_ALPHA)


def isdigit(col):
    return _all_chars_match(col, FLAG_DIGIT)


def isspace(col):
    return _all_chars_match(col, FLAG_SPACE)


def isdecimal(col):
    return _all_chars_match(col, FLAG_DECIMAL)


def isnumeric(col):
    return _all_chars_match(col, FLAG_NUMERIC)


def _case_predicate(col: StringColumn, want_upper: bool) -> torch.Tensor:
    """Valid, non-empty, and no alpha char of the other case: a row with
    no alpha char at all passes ("123" is both lower and upper)."""
    fl = _char_flags(col)
    good = FLAG_UPPER if want_upper else FLAG_LOWER
    bad = ((fl & FLAG_ALPHA) > 0) & ((fl & good) == 0)
    return (layout.char_counts(col) > 0) & (_per_row(col, bad) == 0) & col.validity


def islower(col: StringColumn) -> torch.Tensor:
    return _case_predicate(col, want_upper=False)


def isupper(col: StringColumn) -> torch.Tensor:
    return _case_predicate(col, want_upper=True)


def is_empty(col: StringColumn) -> torch.Tensor:
    """True for null or zero-length rows."""
    return (~col.validity) | (col.lengths() == 0)
