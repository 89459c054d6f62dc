"""Ms a traced pass in the port's per-column row statistics: the union of
its `layout.host_row_stats` (char counts and validity fetched to the
host), `layout.length_buckets` (the host's length classes) and
`layout.row_nonascii_ids` (the non-ASCII row ids) spans, host clock."""

from ._program_spans import span_ms

SPANS = ("layout.host_row_stats", "layout.length_buckets", "layout.row_nonascii_ids")


def read(ctx):
    return span_ms(ctx, SPANS)
