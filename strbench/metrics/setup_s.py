"""From the process's start (the launcher's on several cards) to the
first timed pass: imports, kernel load, generation, ingest, warm-up."""


def read(ctx):
    return ctx.setup_s
