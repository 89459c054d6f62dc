"""Spans: the port's one tracing system, on the profiler's clock.

Port of `custrings_tpu/utils/tracing.py`.  A span is a named stretch of
host code: `with tracing.op(name): ...` inside a function body, or a
function wrapped by `traced` (the package wraps the public functions of
its op modules at import, `custrings_tpu_torch._instrument`).  Both open
the same span.

A span is on while `tracing.enabled()` is active or while the torch
profiler runs (`torch.profiler.profile`, `tracing.device_trace`).  Off,
a span site costs two flag reads.  On, a span

  - runs inside `torch.profiler.record_function(name)`, so it is a
    `user_annotation` event of the profiler's Chrome trace, on the clock
    to which the profiler aligns the device's kernels, copies and
    memsets;
  - keeps a thread-local stack of open spans, so each knows its parent;
  - adds to an in-memory record by name: calls, total host seconds and
    self host seconds (total less the time its child spans cover).

No span synchronizes the device: a span's host time is the time the
host spent in it, launches included, not the device work it queued.
Device time per span comes from the device trace: the device events
that start inside the span's interval, and the idle stretches of the
busy union that lie inside it.

Usage:
    from custrings_tpu_torch.utils import tracing
    with tracing.enabled():
        ... run ops ...
    print(tracing.report())   # calls, total and self ms by span (host),
                              # then the registered counters

    with tracing.device_trace("traces/"):   # torch.profiler, CPU + CUDA
        ... run ops ...                       # the spans are in the trace
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

_records: dict = defaultdict(lambda: [0, 0.0, 0.0])  # name -> [calls, total_s, self_s]
#: counters that report() prints after the spans, by name: a module that
#: keeps one registers its {key: int} dict here, and reset() zeroes it
COUNTERS: dict = {}
_active = False
_local = threading.local()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def enabled():
    global _active
    _active, prev = True, _active
    try:
        yield
    finally:
        _active = prev


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "_range", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _stack().append(self)
        self._child = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child += total
        rec = _records[self.name]
        rec[0] += 1
        rec[1] += total
        rec[2] += total - self._child
        self._range.__exit__(*exc)
        return False


def on() -> bool:
    """Whether spans are on: `enabled()` is active or the profiler runs."""
    return _active or _profiler._is_profiler_enabled


def op(name: str):
    """A span over the enclosed code (see the module's docstring); a
    no-op context while tracing is off and no profiler runs."""
    if _active or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def report() -> str:
    """A row a span name: calls, total and self milliseconds, all on the
    host clock (device time per span is read from a device trace); then a
    row a registered counter that has counted anything."""
    lines = ["span                            calls    total_ms     self_ms  (host clock)"]
    for name, (calls, total, own) in sorted(_records.items()):
        lines.append(f"{name:<30} {calls:>6}  {total * 1e3:>10.3f}  {own * 1e3:>10.3f}")
    for name, counts in sorted(COUNTERS.items()):
        if any(counts.values()):
            lines.append(f"{name}: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    return "\n".join(lines)


def reset():
    _records.clear()
    for counts in COUNTERS.values():
        for k in counts:
            counts[k] = 0


def traced(name: str):
    """Wrap an op so each call opens span `name` while spans are on."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_active or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def instrument_module(mod, prefix: str, names=None) -> None:
    """Wrap every public function defined in `mod` itself with traced().

    Names a module imports from another (a kernel wrapper, say) stay
    unwrapped, and underscore names are left alone: the steps inside an
    op open their spans with `op` in their bodies."""
    for n in names if names is not None else dir(mod):
        if n.startswith("_"):
            continue
        fn = getattr(mod, n, None)
        if inspect.isfunction(fn) and fn.__module__ == mod.__name__ and not getattr(fn, "_traced", False):
            wrapped = traced(f"{prefix}.{n}")(fn)
            wrapped._traced = True
            setattr(mod, n, wrapped)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the enclosed code, CPU and (where there is one)
    CUDA activity, written to `logdir` as a Chrome trace; the spans are
    on inside it.  The profiler waits for the device when it stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
