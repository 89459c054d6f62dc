"""The 95th percentile of every pass's time in the window (host clock,
from the pass's start to its synchronized end; rank 0's on several
cards)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.pass_s) * 1e3, 95))
