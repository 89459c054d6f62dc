"""Read a torch.profiler Chrome trace of a few passes into the events that
the per-layer metrics read.

`read` keeps the device events (kernels, copies, memsets) and the host
events (operators, annotations, runtime and driver calls) that start
inside the traced passes, each with the benchmark step span it starts
in.  Each step span is synchronized at its end, so nothing it launched
runs past it and a device event belongs to the span its start lies in.
The traced window runs from the first pass span's start to the last
one's end on the host clock, to which the profiler aligns the device
clock.  The metric files (`strbench/metrics/`) count, sum and select
from these events; this module keeps only what the harness itself
reports: the busy time and the window (`device`), and the `breakdown`.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

#: the profiler range around each traced pass; a step's is "strbench.<span>"
PASS_SPAN = "strbench.pass"
SPAN_PREFIX = "strbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
#: gaps labelled by the host's activity, the longest first
LABELLED_GAPS = 200
#: characters kept of a device operation's name in the breakdown
NAME_CHARS = 160


@dataclasses.dataclass(slots=True)
class Event:
    name: str
    cat: str
    ts: float  # start, microseconds on the host clock
    dur: float  # microseconds
    span: str | None  # the step span it starts in ("encode"), or None


@dataclasses.dataclass
class Trace:
    passes: int
    lo: float  # the first pass's start, microseconds
    hi: float  # the last pass's end
    device: list  # Event, by start
    host: list  # Event, by start

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which some device event runs (their union)."""
        return sum(e - s for s, e in self.busy()) * 1e-6

    def busy(self):
        return union((e.ts, e.ts + e.dur) for e in self.device)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the innermost host event running in their middle."""
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e.name] += e.dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        starts = [e.ts for e in self.host]
        labelled = defaultdict(float)
        for g in sorted(gaps(self.busy(), self.lo, self.hi), key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
            labelled[_label((g[0] + g[1]) / 2, self.host, starts)] += (g[1] - g[0]) * 1e-6
        idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[short(k), v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def union(intervals):
    """Sorted, merged [start, end] of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy, lo: float, hi: float):
    """(start, end) of the stretches of [lo, hi] outside the busy union."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def _label(t: float, host, starts) -> str:
    """The innermost host event running at time t: the latest to start of
    those that cover it (host sorted by start, starts their starts)."""
    for e in reversed(host[: bisect.bisect_right(starts, t)]):
        if e.ts + e.dur >= t:
            return e.name
    return "(no host event)"


def short(name: str) -> str:
    """A device operation's name without a trailing C++ argument list, at
    most NAME_CHARS long."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                args = name[i:]
                if name[:i].strip() and (args == "()" or any(c in args for c in "*&")):
                    name = name[:i].rstrip()
                break
    return name[:NAME_CHARS]


def read(chrome: dict) -> Trace:
    evs = [e for e in chrome["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    passes = [e for e in evs if e.get("cat") == "user_annotation" and e["name"] == PASS_SPAN]
    if not passes:
        raise ValueError("the trace holds no pass span")
    lo = min(e["ts"] for e in passes)
    hi = max(e["ts"] + e["dur"] for e in passes)
    inside = sorted((e for e in evs if lo <= e["ts"] <= hi), key=lambda e: e["ts"])
    steps = [e for e in inside if e.get("cat") == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX) and e["name"] != PASS_SPAN]
    starts = [s["ts"] for s in steps]

    def span(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= steps[i]["ts"] + steps[i]["dur"]:
            return steps[i]["name"][len(SPAN_PREFIX):]
        return None

    def event(e):
        return Event(e["name"], e["cat"], float(e["ts"]), float(e["dur"]), span(e["ts"]))

    return Trace(
        passes=len(passes), lo=float(lo), hi=float(hi),
        device=[event(e) for e in inside if e.get("cat") in DEVICE_CATS],
        host=[event(e) for e in inside if e.get("cat") in HOST_CATS],
    )
