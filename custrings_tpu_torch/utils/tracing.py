"""Per-op tracing: calls, wall time and payload bytes of each public op.

Port of `custrings_tpu/utils/tracing.py`.  While tracing is active, every
op wrapped by `traced` (the package wraps the public functions of its op
modules at import, `custrings_tpu_torch._instrument`) runs inside a
`torch.profiler.record_function` span of its name, and the device is
synchronized before the clock is read, so the time is the op's own and
not its enqueue.  Inactive, a wrapper costs one attribute check.

Usage:
    from custrings_tpu_torch.utils import tracing
    with tracing.enabled():
        ... run ops ...
    print(tracing.report())

    with tracing.device_trace("traces/"):   # torch.profiler, CPU + CUDA
        ... run ops ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os
import time
from collections import defaultdict

import numpy as np
import torch

_records: dict = defaultdict(lambda: [0, 0.0, 0])  # name -> [calls, secs, bytes]
_active = False

# memory bandwidth used for the roofline %, settable by the user: the
# NVIDIA H100 80GB HBM3's 3.35 TB/s (700.00 W power limit), as
# chip_smoke._bound uses it
HBM_BYTES_PER_SEC = 3.35e12


@contextlib.contextmanager
def enabled():
    global _active
    _active, prev = True, _active
    try:
        yield
    finally:
        _active = prev


def _record(name: str, secs: float, nbytes: int) -> None:
    rec = _records[name]
    rec[0] += 1
    rec[1] += secs
    rec[2] += nbytes


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def op(name: str, nbytes: int = 0):
    """Record one invocation of the enclosed code (wall time, the device
    synchronized at its end)."""
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _record(name, time.perf_counter() - t0, nbytes)


def report() -> str:
    lines = ["op                         calls     total_s   GB/s    roofline%"]
    for name, (calls, secs, nbytes) in sorted(_records.items()):
        bw = (nbytes / secs / 1e9) if secs else 0.0
        roof = 100.0 * (nbytes / secs) / HBM_BYTES_PER_SEC if secs else 0.0
        lines.append(f"{name:<26} {calls:>5}  {secs:>10.4f}  {bw:>6.2f}  {roof:>8.2f}")
    return "\n".join(lines)


def reset():
    _records.clear()


def _payload_bytes(obj) -> int:
    """Bytes of the tensors and numpy arrays reachable from obj, through
    StringColumns and other dataclasses, lists, tuples, sets and dicts.

    A proxy for memory traffic: an op reads its inputs and writes its
    outputs at least once, so in + out payload is its floor."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_payload_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                   if f.name != "cache")
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_payload_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_payload_bytes(x) for x in obj.values())
    return 0


def traced(name: str):
    """Wrap an op so each call, while tracing is active, records its wall
    time and payload bytes under `name`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _active:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
                _sync()
            _record(name, time.perf_counter() - t0, _payload_bytes((args, kwargs, out)))
            return out

        return wrapper

    return deco


def instrument_module(mod, prefix: str, names=None) -> None:
    """Wrap every public function defined in `mod` itself with traced().

    Names a module imports from another (a kernel wrapper, say) stay
    unwrapped, and underscore names are left alone, so tracing measures
    whole ops, not their steps."""
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
    CUDA activity, written to `logdir` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
