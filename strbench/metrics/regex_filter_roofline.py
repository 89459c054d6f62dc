"""The regex filter's share of its roofline: each row's bytes, offsets and
validity read once and the bool mask (and a count) written once, at the
memory rate, over the device time inside its span."""

from . import column_bytes, roofline_pct


def nbytes(col, out):
    return column_bytes(col) + col.size + (8 if isinstance(out, tuple) else 0)


def read(ctx):
    return roofline_pct(ctx, "regex_filter", nbytes)
