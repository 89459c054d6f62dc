"""The dictionary encode's share of its roofline: the input's rows read
once, the keys' rows and an int32 value a row written once, at the
memory rate, over the device time inside its span."""

from . import column_bytes, roofline_pct


def nbytes(col, cat):
    return column_bytes(col) + column_bytes(cat.keys) + 4 * col.size


def read(ctx):
    return roofline_pct(ctx, "encode", nbytes)
