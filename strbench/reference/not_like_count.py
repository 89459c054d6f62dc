"""not_like_count: SQL's `col NOT LIKE '%a%b%'` over non-null rows and
the count of rows it keeps.  The pattern is literals joined by `.*`
(a `%`): a row matches when the literals occur in order, each after the
end of the one before, within one line (`.` skips no newline).  Found
with `re` over the whole byte buffer, then reduced per row with NumPy.

Control `unordered`: every literal present, in any order, the shortcut
of two substring searches."""

from __future__ import annotations

import re

import numpy as np

from . import values_wrong


def _positions(data: bytes, lit: bytes) -> np.ndarray:
    # the literals have no border, so non-overlapping finds are all finds
    return np.fromiter((m.start() for m in re.finditer(re.escape(lit), data)), np.int64)


def _matches(x, lits, ordered: bool) -> np.ndarray:
    data = x.data.tobytes()
    offs = x.offsets.astype(np.int64)
    n = x.rows
    firsts = []
    # the least end (ordered: of a chain of the literals) reachable in each
    # row, as a byte position; past the row's end means no match
    reach = offs[:-1].copy()
    for lit in lits:
        pos = _positions(data, lit)
        row = np.searchsorted(offs, pos, side="right") - 1
        inside = pos + len(lit) <= offs[row + 1]
        pos, row = pos[inside], row[inside]
        if ordered:
            # first occurrence of lit starting at or after the row's reach
            ok = pos >= reach[row]
            first = np.full(n, np.iinfo(np.int64).max)
            np.minimum.at(first, row[ok], pos[ok])
            reach = np.where(first < np.iinfo(np.int64).max, first + len(lit), offs[1:] + 1)
        else:
            has = np.zeros(n, np.bool_)
            has[row] = True
            firsts.append(has)
    if ordered:
        found = reach <= offs[1:]
        if b"\n" in data:  # `.` does not cross a newline: check those rows by re
            rx = re.compile(b".*".join(re.escape(lit) for lit in lits))
            for i in np.nonzero(found)[0].tolist():
                found[i] = rx.search(data[offs[i]:offs[i + 1]]) is not None
        return found
    return np.logical_and.reduce(firsts)


def expected(x, params, control=None):
    lits = [p.encode() for p in params["pattern"].split(".*")]
    if any(re.escape(lit.decode()) != lit.decode() for lit in lits):
        raise ValueError("not_like_count's reference takes literals joined by .*")
    keep = ~_matches(x, lits, control != "unordered") & x.validity
    return keep, int(keep.sum())


def compare(got, exp):
    return {"rows_wrong": values_wrong(got[0], exp[0]), "count_off": abs(got[1] - exp[1])}


def scalar(exp):
    return exp[1]
