"""The literal replace's share of its roofline: the input's rows read
once, the output's bytes and offsets written once (its validity is the
input's), at the memory rate, over the device time inside its span."""

from . import column_bytes, roofline_pct


def nbytes(col, out):
    return column_bytes(col) + int(out.offsets[-1]) + 4 * (out.size + 1)


def read(ctx):
    return roofline_pct(ctx, "replace", nbytes)
