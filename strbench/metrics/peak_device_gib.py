"""torch.cuda.max_memory_allocated over the window, reset at its start;
the fullest card's on several cards.  The resident column counts."""


def read(ctx):
    return ctx.peak_window_bytes / 2**30 if ctx.env.device.type == "cuda" else None
