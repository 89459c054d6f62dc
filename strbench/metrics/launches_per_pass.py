"""Device kernels a traced pass, from the profiler's device events."""


def read(ctx):
    if ctx.trace is None:
        return None
    return sum(e.cat == "kernel" for e in ctx.trace.device) / ctx.trace.passes
