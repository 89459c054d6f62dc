"""The benchmark's harness: one cell, run on this process's device.

Everything that belongs to one configuration, traffic mix, step kind or
metric lives in a file of its own, found by the name that BENCHMARK.json
or a traffic file gives:

    strbench/configs/<config>.json   sizes, shares, layout, guarantees
    strbench/gen/<generator>.py      the configuration's seeded generator
    strbench/traffic/<traffic>.json  the pass: its steps, in order
    strbench/steps/<op>.py           a step on the port (the timed path)
    strbench/reference/<op>.py       the same step in plain Python/NumPy
    strbench/metrics/<metric>.py     a metric's reader

A run: generate the cell's rows from the seed, ingest them into the
port's column, warm the pass up, run passes back to back for the window,
optionally trace a few more passes, then check the last pass's outputs
and every pass's reported numbers against the reference.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "custrings_tpu")
#: every comparison is exact: the limit of each count of wrong answers
LIMIT = 0
#: passes warmed up before the window
WARMUP_PASSES = 2


def load(kind: str, name: str):
    """The module strbench/<kind>/<name>.py (a name may hold dots)."""
    modname = f"strbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(PKG, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def rows(self) -> int:
        """Rows a card holds."""
        return int(self.config["rows_per_card"])


def cell(workload: str, bench: dict | None = None) -> Cell:
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json")) if bench is None else bench
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def here(m, default=True):
        return workload in m["workloads"] if "workloads" in m else default

    # a per-layer metric without a cell list goes to every cell that
    # reports the end-to-end metric it moves
    end_to_end = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in end_to_end}
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=read_json(os.path.join(ROOT, cfg["file"])),
        traffic=read_json(os.path.join(PKG, "traffic", w["traffic"] + ".json")),
        end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"] if here(m, m["moves"] in reported)],
    )


@dataclasses.dataclass
class Env:
    """The process's place in the job: its device, rank and groups."""
    device: object
    rank: int = 0
    world: int = 1
    mesh: object = None
    ctl: object = None  # a gloo group for the harness's own host messages

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def from_rank0(self, value):
        """Rank 0's value, on every rank."""
        if self.world == 1:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.ctl)
        return box[0]

    def to_rank0(self, value) -> list | None:
        """Every rank's value, in rank order, on rank 0 (None elsewhere)."""
        if self.world == 1:
            return [value]
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(value, out, dst=0, group=self.ctl)
        return out

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.ctl)


def join(rank: int, world: int, port: int, device: str) -> Env:
    """Join a job of `world` processes: NCCL on the card (gloo on the CPU)
    through the port's runtime, and a gloo group for the harness."""
    import torch
    import torch.distributed as dist
    from custrings_tpu_torch.parallel import runtime

    dev = torch.device(device)
    runtime.init_runtime(f"localhost:{port}", world, rank, device=dev)
    mesh = runtime.global_mesh()
    ctl = dist.new_group(backend="gloo")
    return Env(device=dev, rank=rank, world=world, mesh=mesh, ctl=ctl)


def ingest(host, env: Env, job_rows: int):
    """The generator's host arrays as the port's column on the device:
    Arrow-style buffers (bytes, offsets, a validity bitmask) through
    `column.from_offsets_np`; on several cards, this rank's shard of a
    row-sharded column."""
    import torch
    from custrings_tpu_torch import column

    bits = np.packbits(host.validity, bitorder="little")
    col = column.from_offsets_np(host.data, host.offsets, host.rows, bits, device=env.device)
    if env.world == 1:
        return col
    from custrings_tpu_torch.parallel.sharded import ShardedStringColumn

    alive = torch.ones(host.rows, dtype=torch.bool, device=env.device)
    return ShardedStringColumn(col.data, col.offsets, col.validity, alive, env.mesh, nrows=job_rows)


def fresh(x):
    """The same tensors under a new column object, so that no pass finds
    the planes an earlier pass memoized on the column (a new batch)."""
    from custrings_tpu_torch.column import StringColumn

    if isinstance(x, StringColumn):
        return StringColumn(x.data, x.offsets, x.validity)
    return type(x)(x.data, x.offsets, x.validity, x.alive, x.mesh, x.axis, nrows=x.nrows)


class Pass:
    """The traffic's steps over one column, in order."""

    def __init__(self, c: Cell, env: Env):
        self.steps = c.traffic["steps"]
        self.mods = {s["op"]: load("steps", s["op"]) for s in self.steps}
        self.env = env

    def __call__(self, col, spans: dict | None = None):
        """(outputs by name, reported numbers by name).  With `spans`, each
        step runs in a profiler range named strbench.<span>, synchronized
        at its end, and its wall seconds are appended to spans[span]."""
        from torch.profiler import record_function

        vals = {"col": fresh(col)}
        nums = {}
        for s in self.steps:
            mod, x = self.mods[s["op"]], vals[s["in"]]
            if spans is None:
                out = mod.run(x, s)
            else:
                with record_function("strbench." + s["span"]):
                    t = time.perf_counter()
                    out = mod.run(x, s)
                    self.env.sync()
                spans.setdefault(s["span"], []).append(time.perf_counter() - t)
            vals[s["out"]] = out
            num = mod.scalar(out)
            if num is not None:
                nums[s["out"]] = num
        self.env.sync()
        return vals, nums

    @staticmethod
    def rows(col) -> int:
        """The rows a pass takes in: the job's, for a sharded column."""
        return col.nrows if hasattr(col, "nrows") else col.size


def window(run, seconds: float, env: Env):
    """Passes back to back until `seconds` have passed on rank 0's clock.
    Returns (last outputs, pass seconds, reported numbers a pass, window
    seconds)."""
    times, nums = [], []
    start = time.perf_counter()
    while True:
        outs = None  # free the previous pass's outputs first
        t0 = time.perf_counter()
        outs, n = run()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        nums.append(n)
        if env.from_rank0(t1 - start >= seconds):
            return outs, times, nums, t1 - start


def traced(run, passes: int, env: Env):
    """`passes` more passes under torch.profiler, each step's span
    synchronized; returns (last outputs, numbers a pass, spans, the
    trace's events as `trace.Trace`)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if env.device.type == "cuda" else [])
    spans, nums = {}, []
    with profile(activities=acts) as prof:
        for _ in range(passes):
            outs = None
            with record_function(trace.PASS_SPAN):
                outs, n = run(spans)
            nums.append(n)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="strbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.read(read_json(path))
    finally:
        os.remove(path)
    return outs, nums, spans, events


@dataclasses.dataclass
class Context:
    """What a metric's reader may read (rank 0's view of the run)."""
    cell: Cell
    env: Env
    setup_s: float
    ingest_s: float
    pass_s: list
    window_s: float
    rows_per_pass: int
    peak_window_bytes: int
    spans: dict | None = None  # span -> wall seconds a traced pass
    trace: object = None  # trace.Trace of rank 0's traced passes
    io: dict | None = None  # span -> (step input, step output) of the last pass


def rank_run(c: Cell, seed: int, seconds: float, want_trace: bool, env: Env, t_start: float) -> dict | None:
    """One run of the cell on this rank; rank 0 returns the result line's
    object, the other ranks None."""
    import torch

    cuda = env.device.type == "cuda"
    if cuda:  # the CUDA context, before anything is timed as ingest
        torch.empty(1, device=env.device)
        env.sync()
    gen = load("gen", c.config["generator"])
    host = gen.generate(c.config, c.rows, seed, env.rank)
    t_in = time.perf_counter()
    col = ingest(host, env, c.rows * env.world)
    env.sync()
    ingest_s = time.perf_counter() - t_in
    run = Pass(c, env)
    rows_per_pass = run.rows(col)
    for _ in range(WARMUP_PASSES):
        run(col)
    env.barrier()
    setup_s = time.time() - t_start
    peak_setup = torch.cuda.max_memory_allocated(env.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(env.device)
    outs, pass_s, nums, window_s = window(lambda: run(col), seconds, env)
    peak_window = torch.cuda.max_memory_allocated(env.device) if cuda else 0
    spans = events = None
    if want_trace:
        passes = env.from_rank0(min(max(math.ceil(1.0 / float(np.median(pass_s))), 3), 20))
        outs = None
        outs, tnums, spans, events = traced(lambda sp: run(col, sp), passes, env)
        nums += tnums
    peak_run = max(peak_setup, peak_window, torch.cuda.max_memory_allocated(env.device) if cuda else 0)
    io = {s["span"]: (outs[s["in"]], outs[s["out"]]) for s in run.steps}
    ctx = Context(c, env, setup_s, ingest_s, pass_s, window_s, rows_per_pass, peak_window,
                  spans, events, io)
    layer = {m["name"]: load("metrics", m["name"]).read(ctx)
             for m in c.per_layer} if want_trace and env.rank == 0 else {}
    got = {s["out"]: run.mods[s["op"]].host(outs[s["out"]]) for s in run.steps}
    peaks = env.to_rank0((peak_window, peak_run))
    busy = env.to_rank0((events.busy_s, events.window_s) if events else None)
    gots = env.to_rank0(got)
    # the program's state is freed before the reference runs
    del outs, io, col, ctx
    if cuda:
        torch.cuda.empty_cache()
    if env.rank != 0:
        return None
    ctx_peak = max(p[0] for p in peaks)
    checks, wrong_passes = check(c, gen, host, seed, env.world, gots, nums)
    ctx = Context(c, env, setup_s, ingest_s, pass_s, window_s, rows_per_pass, ctx_peak, spans, events)
    metrics = {}
    for m in c.per_layer if want_trace else c.end_to_end:
        v = layer[m["name"]] if want_trace else load("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(env.device) if cuda else "cpu",
        "count": env.world,
        "memory_peak_bytes": max(p[1] for p in peaks),
        "power_limit_w": power_limit_w(env.device) if cuda else None,
    }
    result = {
        "correct": all(v <= LIMIT for v in checks.values()),
        "attempted": len(nums),
        "failed": wrong_passes,
        "metrics": metrics,
        "device": device,
    }
    if want_trace:
        device["busy_s"] = sum(b for b, _ in busy) / len(busy)
        device["window_s"] = sum(w for _, w in busy) / len(busy)
        result["breakdown"] = events.breakdown()
    result["window"] = window_stats(pass_s, window_s, rows_per_pass)
    result["checks"] = {k: {"value": v, "limit": LIMIT} for k, v in checks.items()}
    return result


def power_limit_w(device) -> float | None:
    """The card's power limit as nvidia-smi reads it (a card set below its
    700 W runs slower under load), or None where it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def window_stats(pass_s: list, window_s: float, rows_per_pass: int) -> dict:
    """The window's passes: count, median and spread of their times, and
    the rate of each half of the window (a drift shows there)."""
    ms = np.asarray(pass_s) * 1e3
    half = len(ms) // 2
    rate = [rows_per_pass * len(h) / (h.sum() / 1e3) for h in (ms[:half], ms[half:]) if len(h)]
    return {"passes": len(ms), "window_s": window_s, "median_ms": float(np.median(ms)),
            "min_ms": float(ms.min()), "p95_ms": float(np.percentile(ms, 95)), "max_ms": float(ms.max()),
            "halves_rows_per_s": rate}


def check(c: Cell, gen, host, seed: int, world: int, gots: list | None, nums: list,
          control: bool = False):
    """(wrong answers by name, passes judged wrong).  The reference runs
    the traffic's steps over the generator's rows (every shard's, made
    again from the seed, on several cards); each step's outputs of the
    last pass are compared whole, and the numbers every pass reported
    against the reference's.  With `control`, the traffic's control
    variant replaces its step's reference: the program is not read."""
    cv = c.traffic.get("control", {})
    xs = host if world == 1 else [host] + [gen.generate(c.config, c.rows, seed, r) for r in range(1, world)]
    vals, ctl = {"col": xs}, {"col": xs}  # the reference's outputs, the control's
    checks = {}
    bad = np.zeros(len(nums), np.bool_)
    for s in c.traffic["steps"]:
        ref = load("reference", s["op"])
        exp = vals[s["out"]] = ref.expected(vals[s["in"]], s)
        if control:
            variant = cv.get("variant") if cv.get("out") == s["out"] else None
            got = ctl[s["out"]] = ref.expected(ctl[s["in"]], s, variant)
        else:
            got = gots[0][s["out"]] if world == 1 else [g[s["out"]] for g in gots]
        for name, v in ref.compare(got, exp).items():
            checks[f"{s['out']}.{name}"] = int(v)
        want = ref.scalar(exp)
        if want is not None and not control:
            per = np.array([n.get(s["out"]) != want for n in nums], np.bool_)
            checks[f"{s['out']}.passes_wrong"] = int(per.sum())
            bad |= per
    if any(v > LIMIT for v in checks.values()) and len(bad):
        bad[-1] = True  # the last pass, compared whole, is wrong
    return checks, int(bad.sum())


def control(c: Cell, seed: int) -> dict:
    """The control's readings at the cell's size: the traffic's control
    variant of the reference in the program's place, judged as a run is
    (wrong answers by name)."""
    gen = load("gen", c.config["generator"])
    host = gen.generate(c.config, c.rows, seed, 0)
    return check(c, gen, host, seed, c.chips, None, [], control=True)[0]


def check_lines(result: dict) -> list[str]:
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]
