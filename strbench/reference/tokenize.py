"""tokenize: the tokens of every valid row in row order, a token a
maximal run of characters none of which is in the delimiter set (one
space here; UTF-8 never uses its byte inside another character)."""

from __future__ import annotations

from . import from_rows, rows_wrong


def expected(x, params, control=None):
    delims = params["delimiter"].encode()
    if len(delims) != 1:
        raise ValueError("tokenize's reference takes one one-byte delimiter")
    return from_rows([t for r in x.to_list() if r is not None for t in r.split(delims) if t])


def compare(got, exp):
    return {"rows_wrong": rows_wrong(got, exp)}


def scalar(exp):
    return None
