"""categorize_sharded: one dictionary over the rows of every shard, as a
single encode of the whole column gives it; each shard's values are its
rows' indexes in it, and every rank reports the job's key count.  Takes
and gives one entry a shard.

Control `nulls_empty`: null rows encoded as empty strings; `first_seen`:
keys in order of first appearance over the job, as a hashed encode would
leave them unsorted."""

from __future__ import annotations

from . import nulls_empty, values_wrong
from .categorize import encode


def expected(xs, params, control=None):
    if control == "nulls_empty":
        xs = [nulls_empty(x) for x in xs]
    rows = [r for x in xs for r in x.to_list()]
    keys, values = encode(rows, control)
    out, lo = [], 0
    for x in xs:
        out.append((values[lo: lo + x.rows], len(keys)))
        lo += x.rows
    return out


def compare(got, exp):
    return {
        "values_wrong": sum(values_wrong(g[0], e[0]) for g, e in zip(got, exp)),
        "keys_off": max(abs(g[1] - e[1]) for g, e in zip(got, exp)),
    }


def scalar(exp):
    return exp[0][1]
