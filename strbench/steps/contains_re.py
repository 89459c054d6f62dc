"""A regex filter: the port's `regex.ops.contains_re` mask of a column."""

from __future__ import annotations

from custrings_tpu_torch.regex import ops as rops


def run(x, params):
    return rops.contains_re(x, params["pattern"])


def host(out):
    return out.cpu().numpy()


def scalar(out):
    return None
