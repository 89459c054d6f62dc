"""categorize: the sorted unique rows (bytes order, the null key first
where a row is null) and each row's index among them.

Control `first_seen`: keys in order of first appearance, as a hashed
encode would leave them unsorted."""

from __future__ import annotations

import numpy as np

from . import from_rows, rows_wrong, values_wrong


def encode(rows, control=None):
    """(keys as rows, values int32) of a list of bytes / None."""
    if control == "first_seen":
        keys = list(dict.fromkeys(rows))
    else:
        uniq = set(rows)
        keys = ([None] if None in uniq else []) + sorted(uniq - {None})
    index = {k: i for i, k in enumerate(keys)}
    return keys, np.fromiter((index[r] for r in rows), np.int32, len(rows))


def expected(x, params, control=None):
    keys, values = encode(x.to_list(), control)
    return from_rows(keys), values


def compare(got, exp):
    return {"keys_wrong": rows_wrong(got[0], exp[0]), "values_wrong": values_wrong(got[1], exp[1])}


def scalar(exp):
    return exp[0].rows
