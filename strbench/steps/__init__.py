"""The port's entries that a pass drives, one module a step kind.

Each module gives `run(x, params)`, the step on the device (its result
kept there); `host(out)`, the result as host arrays in the form of the
step's reference (`strbench/reference/<kind>.py`); `scalar(out)`, the
number each pass reports, already on the host (None where none).  A
traffic file names the step kinds of its pass, in order.
"""

from __future__ import annotations

from ..gen import HostColumn


def host_column(col) -> HostColumn:
    """A port StringColumn's rows as host arrays."""
    offsets = col.offsets.cpu().numpy()
    return HostColumn(col.data[: int(offsets[-1])].cpu().numpy(), offsets, col.validity.cpu().numpy())
