"""The collective dictionary build of a row-sharded column:
`parallel.sharded.ShardedStringColumn.categorize` (the local encode, then
the PSRS key merge over the job's ranks); reports the job's key count."""

from __future__ import annotations


def run(x, params):
    return x.categorize()


def host(out):
    return out[0].cpu().numpy(), out[1]


def scalar(out):
    return out[1]
