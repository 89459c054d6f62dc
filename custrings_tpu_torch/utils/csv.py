"""CSV column ingest: `read_column`, behind `nvstrings.from_csv`.

Port of `custrings_tpu/utils/csv.py` (the reference's host-side
createFromCSV, cpp/src/util.cu): one column of a CSV file into a column
on a device.  The reference's dialect: quotes only shield commas, the
OUTER quote pair of a field is stripped and doubled quotes inside it are
kept verbatim; the first line is a header; a blank field is null, or
empty with CSV_NULL_IS_EMPTY.  Flags as in cpp/src/util.h:27-29; a sort
flag sorts the column by length, name or both (`ops.array.sort`, on
K1b's key words).
"""

from __future__ import annotations

from ..column import StringColumn, from_host_strings

CSV_SORT_LENGTH = 1
CSV_SORT_NAME = 2
CSV_NULL_IS_EMPTY = 8


def _split_line(line: str) -> list[str]:
    """The fields of one line, split at the commas outside quotes.

    The JAX package walks the line a character at a time, toggling its
    quote state at each '"'; here the text between the i-th and the next
    quote is outside quotes for even i, so only those stretches are split
    at their commas (the same fields, without a Python step a byte)."""
    if '"' not in line:
        return line.split(",")
    fields, cur = [], []
    for i, seg in enumerate(line.split('"')):
        if i:
            cur.append('"')
        if i % 2:
            cur.append(seg)
            continue
        first, *rest = seg.split(",")
        cur.append(first)
        for part in rest:
            fields.append("".join(cur))
            cur = [part]
    fields.append("".join(cur))
    return [f[1:-1] if len(f) >= 2 and f[0] == '"' and f[-1] == '"' else f for f in fields]


def read_column(path: str, column: int, lines: int = 0, flags: int = 0, device="cuda") -> StringColumn:
    """Field `column` of each line after the header (at most `lines` of
    them when nonzero) as a column on `device`; a line without that field
    gives a null row."""
    out = []
    empty = "" if flags & CSV_NULL_IS_EMPTY else None
    with open(path, newline="", encoding="utf-8") as f:
        for i, raw in enumerate(f):
            if i == 0:
                # util.cu:68-80 records offsets only AFTER each newline, so
                # the first line (the header) is never part of the result
                continue
            if lines and i > lines:
                break
            row = _split_line(raw.rstrip("\r\n"))
            v = row[column] if column < len(row) else None
            out.append(empty if v == "" else v)
    col = from_host_strings(out, device)
    if flags & (CSV_SORT_LENGTH | CSV_SORT_NAME):
        from ..ops import array

        col = array.sort(col, flags & (CSV_SORT_LENGTH | CSV_SORT_NAME))
    return col
