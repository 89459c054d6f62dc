"""Mean wall ms of the replace step over the traced passes (its span,
synchronized at its end)."""

from . import span_ms


def read(ctx):
    return span_ms(ctx, "replace")
