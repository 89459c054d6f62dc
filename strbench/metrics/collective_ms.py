"""NCCL kernel time a traced pass on rank 0, ms; nothing to read where no
NCCL kernel ran."""


def read(ctx):
    if ctx.trace is None:
        return None
    us = sum(e.dur for e in ctx.trace.device if "nccl" in e.name.lower())
    return us * 1e-3 / ctx.trace.passes if us > 0 else None
