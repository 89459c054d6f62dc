"""Rows of every pass completed in the window (the job's rows on several
cards) over the whole window, host clock."""


def read(ctx):
    return ctx.rows_per_pass * len(ctx.pass_s) / ctx.window_s
