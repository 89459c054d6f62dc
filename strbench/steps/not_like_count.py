"""SQL's `col NOT LIKE '%a%b%'` (TPC-H Q13's filter): the negated
`contains_re` mask over non-null rows, and its count read back."""

from __future__ import annotations

from custrings_tpu_torch.regex import ops as rops


def run(x, params):
    keep = ~rops.contains_re(x, params["pattern"]) & x.validity
    return keep, int(keep.sum())


def host(out):
    return out[0].cpu().numpy(), out[1]


def scalar(out):
    return out[1]
