"""Where a cell's traced passes spend their time, by the port's own spans.

    python3 strbench/span_split.py --workload tpch.q13 --seed 7 --passes 5

Makes the cell's rows from the seed, ingests them, warms the pass up,
then runs --passes passes under torch.profiler as a `--trace 1` run does
and prints one JSON line a span name, the longest first: ms a pass in
the union of its intervals (host clock), device-idle ms a pass inside
them (the union less the device's busy intervals), and its calls and
self host ms a pass from `custrings_tpu_torch.utils.tracing`'s records;
then a line with the pass's window, busy time, spans and step times, and
one with the trace's `breakdown`.  Runs on cuda:0 at the cell's own rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strbench import core  # noqa: E402
from strbench.metrics._program_spans import idle_ms, span_ms  # noqa: E402


def split(ev, records: dict) -> list[dict]:
    """A row a user_annotation name of the traced events `ev` (a
    `trace.Trace`), with the spans' records by name."""
    ctx = types.SimpleNamespace(trace=ev)
    rows = []
    for name in {e.name for e in ev.host if e.cat == "user_annotation"}:
        rec = records.get(name)
        rows.append({"span": name, "ms": span_ms(ctx, (name,)), "idle_ms": idle_ms(ctx, (name,)),
                     "calls": rec[0] / ev.passes if rec else None,
                     "self_ms": rec[2] * 1e3 / ev.passes if rec else None})
    return sorted(rows, key=lambda r: -r["ms"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--passes", type=int, default=5)
    a = p.parse_args(argv)
    import torch

    from custrings_tpu_torch.utils import tracing

    torch.set_num_threads(1)
    c = core.cell(a.workload)
    env = core.Env(device=torch.device("cuda:0"))
    torch.empty(1, device=env.device)
    gen = core.load("gen", c.config["generator"])
    col = core.ingest(gen.generate(c.config, c.rows, a.seed, 0), env, c.rows)
    run = core.Pass(c, env)
    for _ in range(core.WARMUP_PASSES):
        run(col)
    tracing.reset()
    _, _, steps, ev = core.traced(lambda sp: run(col, sp), a.passes, env)
    records = {k: list(v) for k, v in tracing._records.items()}
    for row in split(ev, records):
        print(json.dumps(row))
    print(json.dumps({"workload": a.workload, "seed": a.seed, "passes": a.passes,
                      "device": torch.cuda.get_device_name(env.device),
                      "window_ms": ev.window_s * 1e3 / a.passes, "busy_ms": ev.busy_s * 1e3 / a.passes,
                      "spans_per_pass": sum(r[0] for r in records.values()) / a.passes,
                      "step_ms": {k: 1e3 * sum(v) / len(v) for k, v in steps.items()}}))
    print(json.dumps({"breakdown": ev.breakdown()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
