"""replace: every non-overlapping occurrence of a literal replaced, left
to right (Python's bytes.replace); a null row stays null.

Control `nulls_empty`: null rows come back empty and valid."""

from __future__ import annotations

from . import from_rows, nulls_empty, rows_wrong


def expected(x, params, control=None):
    if control == "nulls_empty":
        x = nulls_empty(x)
    pat, repl = params["pat"].encode(), params["repl"].encode()
    return from_rows([None if r is None else r.replace(pat, repl) for r in x.to_list()])


def compare(got, exp):
    return {"rows_wrong": rows_wrong(got, exp)}


def scalar(exp):
    return None
