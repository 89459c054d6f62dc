"""Case mapping: lower / upper / swapcase / capitalize / title.

Port of `custrings_tpu/ops/case.py` (case.cu lower:31, upper:100,
swapcase:169, capitalize:238, title:314).  Every char of the column maps
through the 16-bit opposite-case table at once (`unicode/tables.py`: BMP
only, 1:1, a multi-char casing taking its first codepoint, so "ß" upper
is "S"); the position rules (a row's first char, a word start: the
previous char is not alpha) come from shifted masks.  Widths may change,
so the rows are built by the charwise engine; an ASCII column stays
ASCII and takes its shortcut.
"""

from __future__ import annotations

import torch

from ..column import StringColumn
from ..unicode.tables import FLAG_ALPHA, FLAG_LOWER, FLAG_UPPER, device_tables
from . import charwise, layout


def _case_body(col: StringColumn, kind: str):
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    flags, cases = device_tables(col.device)
    bmp = cps < flags.shape[0]
    safe = cps.clamp(0, flags.shape[0] - 1).to(torch.int64)
    fl = torch.where(bmp, flags[safe].to(torch.int32), 0)
    is_up, is_lo, is_al = (fl & FLAG_UPPER) > 0, (fl & FLAG_LOWER) > 0, (fl & FLAG_ALPHA) > 0
    swapped = torch.where((is_up | is_lo) & bmp, cases[safe], cps)
    ncap = cps.shape[0]
    first = torch.zeros(ncap + 1, dtype=torch.bool, device=col.device)
    first[cm.char_offsets[:-1].clamp(max=ncap).to(torch.int64)] = True
    first = first[:ncap]
    if kind == "lower":
        out = torch.where(is_up, swapped, cps)
    elif kind == "upper":
        out = torch.where(is_lo, swapped, cps)
    elif kind == "swapcase":
        out = swapped
    elif kind == "capitalize":
        out = torch.where((first & is_lo) | (~first & is_up), swapped, cps)
    elif kind == "title":
        prev_alpha = torch.cat([torch.zeros(1, dtype=torch.bool, device=col.device), is_al[:-1]])
        word_start = first | ~prev_alpha
        out = torch.where(is_al & ((word_start & is_lo) | (~word_start & is_up)), swapped, cps)
    else:
        raise ValueError(f"unknown case op {kind!r}")

    def cp_fn(rows, oc, valid, *, cidx, bcast):
        # output char c is input char c: a cut or a zero pad, no gather
        cc = cidx.shape[0]
        return out[:cc] if cc <= ncap else torch.nn.functional.pad(out, (0, cc - ncap))

    return cm.nchars(), col.validity, cp_fn


def _case_op(col: StringColumn, kind: str) -> StringColumn:
    # no case mapping of an ASCII codepoint leaves ASCII
    return charwise.run_charwise(_case_body, col, kind, ascii_out=layout.is_ascii(col))


def lower(col):
    return _case_op(col, "lower")


def upper(col):
    return _case_op(col, "upper")


def swapcase(col):
    return _case_op(col, "swapcase")


def capitalize(col):
    return _case_op(col, "capitalize")


def title(col):
    return _case_op(col, "title")
