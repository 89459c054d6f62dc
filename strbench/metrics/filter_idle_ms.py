"""Device-idle ms a traced pass inside the port's `regex.contains_re`
spans: the host's work in the regex filter that the card waits for (its
row statistics, routing and read-backs)."""

from ._program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("regex.contains_re",))
