"""The port's own spans in the traced passes: the ranges that
`custrings_tpu_torch.utils.tracing` opens, user_annotation events of the
profiler's trace beside the benchmark's `strbench.<span>` ranges.  A
program that opens no such span (an older one) gives the readers nothing
to read, and they return None."""

from __future__ import annotations

from ..trace import gaps, union


def intervals(ctx, names) -> list | None:
    """The merged [start, end] (microseconds) of the traced passes' spans
    named in `names`, or None where there is none."""
    if ctx.trace is None:
        return None
    found = [(e.ts, e.ts + e.dur) for e in ctx.trace.host if e.cat == "user_annotation" and e.name in names]
    return union(found) if found else None


def span_ms(ctx, names) -> float | None:
    """Ms a traced pass in the union of the named spans (host clock), so a
    span nested in another is not counted twice."""
    spans = intervals(ctx, names)
    if spans is None:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / ctx.trace.passes


def idle_ms(ctx, names) -> float | None:
    """Device-idle ms a traced pass inside the named spans: their union
    less the union of the device's kernels, copies and memsets."""
    spans = intervals(ctx, names)
    if spans is None:
        return None
    busy = ctx.trace.busy()
    idle = sum(g1 - g0 for s, e in spans for g0, g1 in gaps(busy, s, e))
    return idle * 1e-3 / ctx.trace.passes
