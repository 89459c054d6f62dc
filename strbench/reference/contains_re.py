"""contains_re: does the pattern match somewhere in the row (Python `re`
on the decoded row); a null row is False.

Control `ascii`: the pattern's classes read ASCII only (re.ASCII), the
shortcut a byte-wise fast path would take."""

from __future__ import annotations

import re

import numpy as np

from . import values_wrong


def expected(x, params, control=None):
    flags = re.ASCII if control == "ascii" else 0
    rx = re.compile(params["pattern"], flags)
    return np.fromiter((r is not None and rx.search(r.decode("utf-8", "surrogateescape")) is not None
                        for r in x.to_list()), np.bool_, x.rows)


def compare(got, exp):
    return {"rows_wrong": values_wrong(got, exp)}


def scalar(exp):
    return None
