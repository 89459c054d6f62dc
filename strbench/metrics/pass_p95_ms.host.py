"""The 95th percentile of every pass's time in the window (host clock),
in the cells whose tail is too unsteady to carry a bound: where the card
idles most of the pass and the host's own work sets the tail.  A
per-layer number there, not an end-to-end one."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.pass_s) * 1e3, 95))
