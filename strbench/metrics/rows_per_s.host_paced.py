"""Rows of every pass completed in the window over the whole window (host
clock), in the cells whose card idles most of each pass while the host
works: the same quantity as `rows_per_s`, under a bound wide enough for
the host's run-to-run spread."""

from .rows_per_s import read  # noqa: F401
