"""The plain references that decide `correct`, one module a step kind.

Each module gives `expected(x, params, control=None)`, the step's output
worked out again from the generator's host arrays with Python and NumPy;
`compare(got, exp)`, the counts of wrong answers by name; and
`scalar(exp)`, the number every pass of the window reports (None where a
step reports none).  `control` names a variant that breaks one guarantee
of the configuration, for the control runs.  Nothing here imports the
port, JAX or the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..gen import HostColumn


def from_rows(rows) -> HostColumn:
    """HostColumn of Python bytes / None rows."""
    lens = np.fromiter((0 if r is None else len(r) for r in rows), np.int64, len(rows))
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.frombuffer(b"".join(r for r in rows if r is not None), np.uint8)
    valid = np.fromiter((r is not None for r in rows), np.bool_, len(rows))
    return HostColumn(data, offs.astype(np.int32), valid)


def rows_wrong(got: HostColumn, exp: HostColumn) -> int:
    """Rows of `got` that differ from `exp` (null, bytes or place), plus
    the difference in row count."""
    same = (got.rows == exp.rows and np.array_equal(got.validity, exp.validity)
            and np.array_equal(got.offsets, exp.offsets)
            and np.array_equal(got.data[: got.offsets[-1]], exp.data[: exp.offsets[-1]]))
    if same:
        return 0
    g, e = got.to_list(), exp.to_list()
    return sum(a != b for a, b in zip(g, e)) + abs(len(g) - len(e))


def values_wrong(got: np.ndarray, exp: np.ndarray) -> int:
    """Positions where two integer arrays differ, plus the difference in
    length."""
    n = min(len(got), len(exp))
    return int(np.count_nonzero(np.asarray(got[:n]) != np.asarray(exp[:n]))) + abs(len(got) - len(exp))


def nulls_empty(col: HostColumn) -> HostColumn:
    """The control's column: every null row an empty valid row."""
    return HostColumn(col.data, col.offsets, np.ones_like(col.validity))
