"""Device-idle ms a traced pass inside the port's
`unique.dictionary_encode` spans: the encode's host glue and read-backs
that the card waits for."""

from ._program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("unique.dictionary_encode",))
