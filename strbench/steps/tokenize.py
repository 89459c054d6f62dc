"""The flattened tokens of a column: `text.token.tokenize`."""

from __future__ import annotations

from custrings_tpu_torch.text import token

from . import host_column


def run(x, params):
    return token.tokenize(x, params["delimiter"])


def host(out):
    return host_column(out)


def scalar(out):
    return None
