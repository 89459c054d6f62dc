"""Metric readers, one file a metric named as in BENCHMARK.json.

Each file gives `read(ctx)` (ctx: `strbench.core.Context`), the metric's
value, or None where the run has nothing to read for it; the harness
then leaves the metric out.  A share of a roofline is never made 0 or
capped: the bytes are the least the op needs, the time all the device
time inside its span.
"""

from __future__ import annotations

#: the NVIDIA H100 SXM's device-memory rate (NVIDIA data sheet, 700 W)
PEAK_BYTES_PER_S = 3.35e12


def column_bytes(col) -> int:
    """Bytes of a port StringColumn's rows: its real bytes (not the
    capacity), the int32 offsets and the bool validity."""
    n = col.size
    return int(col.offsets[-1]) + 4 * (n + 1) + n


def span_ms(ctx, span: str) -> float | None:
    """Mean wall ms of a step's span over the traced passes (host clock,
    the span synchronized at its end)."""
    values = (ctx.spans or {}).get(span)
    return 1e3 * sum(values) / len(values) if values else None


def span_device_s(ctx, span: str) -> float:
    """Device seconds a traced pass of the events that start inside the
    step's span."""
    return sum(e.dur for e in ctx.trace.device if e.span == span) * 1e-6 / ctx.trace.passes


def roofline_pct(ctx, span: str, nbytes) -> float | None:
    """The least time of the span's op (`nbytes(step input, step output)`
    at the memory rate) as a share of the device time inside the span."""
    if ctx.trace is None or span not in (ctx.io or {}):
        return None
    dev = span_device_s(ctx, span)
    if dev <= 0:
        return None
    return 100.0 * nbytes(*ctx.io[span]) / PEAK_BYTES_PER_S / dev
