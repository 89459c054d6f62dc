"""The tokenizer's share of its roofline: the input's rows read once, the
tokens' bytes, offsets and validity written once, at the memory rate,
over the device time inside its span."""

from . import column_bytes, roofline_pct


def nbytes(col, toks):
    return column_bytes(col) + column_bytes(toks)


def read(ctx):
    return roofline_pct(ctx, "tokenize", nbytes)
