"""A literal replace of every occurrence: `ops.modify.replace_literal`."""

from __future__ import annotations

from custrings_tpu_torch.ops import modify

from . import host_column


def run(x, params):
    return modify.replace_literal(x, params["pat"], params["repl"])


def host(out):
    return host_column(out)


def scalar(out):
    return None
