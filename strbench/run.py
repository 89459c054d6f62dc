"""Run one cell of the benchmark once and print its result line.

    python3 strbench/run.py --workload tpch.q13 --seed 7 --seconds 10 --trace 0

The cell, its configuration, traffic and metrics are found by name from
BENCHMARK.json (see strbench/README.md).  The run makes the cell's rows
from the seed, ingests them into custrings_tpu_torch on the card, warms
the pass up, runs passes back to back for --seconds, and checks the last
pass's outputs and every pass's reported numbers against the plain
reference.  The last line of standard output is one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error.  --trace 1 also profiles a few more passes and reports the
per-layer metrics instead of the end-to-end ones.

A cell on several cards starts one process a card (NCCL over a TCP
rendezvous on a free localhost port) and prints rank 0's line.  Without
CUDA, or with fewer cards than the cell asks for, the run fails and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strbench import core  # noqa: E402

#: seconds a rank process may take before the launcher ends the job
RANK_TIMEOUT_S = 1150


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a job on several cards, as the launcher starts it
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def emit(result: dict) -> int:
    """Print a result, the checks last on standard error; refuse (exit 3,
    no result) where JAX or the JAX package is loaded."""
    bad = core.forbidden_modules()
    if bad:
        print(f"refused: loaded modules {bad}", file=sys.stderr)
        return 3
    print(f"device {json.dumps(result['device'])}", file=sys.stderr)
    print(f"window {json.dumps(result['window'])}", file=sys.stderr)
    print("\n".join(core.check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def rank_main(a, cell) -> int:
    """One rank of a job on several cards: run, and rank 0 writes its
    results to --out."""
    env = core.join(a.rank, cell.chips, a.port, f"cuda:{a.rank}")
    try:
        result = core.rank_run(cell, a.seed, a.seconds, bool(a.trace), env, a.t0)
        if a.rank == 0:
            with open(a.out, "w", encoding="utf-8") as f:
                json.dump({"result": result, "forbidden": core.forbidden_modules()}, f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(a, cell) -> int:
    """Start a process a card, wait for all, print rank 0's result."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="strbench-") as tmp:
        out = os.path.join(tmp, "rank0.json")
        base = [sys.executable, os.path.abspath(__file__), "--workload", a.workload, "--seed", str(a.seed),
                "--seconds", str(a.seconds), "--trace", str(a.trace), "--port", str(port),
                "--t0", repr(T_START), "--out", out]
        procs = [subprocess.Popen(base + ["--rank", str(r)]) for r in range(cell.chips)]
        try:
            deadline = time.time() + RANK_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
                    print("a rank failed or timed out: ending the job", file=sys.stderr)
                    return 1
                time.sleep(0.2)
            if any(p.returncode != 0 for p in procs):
                print(f"rank exit codes {[p.returncode for p in procs]}", file=sys.stderr)
                return 1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        with open(out, encoding="utf-8") as f:
            got = json.load(f)
    if got["forbidden"]:
        print(f"refused: rank 0 loaded {got['forbidden']}", file=sys.stderr)
        return 3
    return emit(got["result"])


def main(argv=None) -> int:
    a = parse(argv)
    cell = core.cell(a.workload)
    import torch

    import custrings_tpu_torch  # noqa: F401  the system under test

    torch.set_num_threads(1)
    if a.rank is not None:
        return rank_main(a, cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell.chips} CUDA card(s); {n} found", file=sys.stderr)
        return 2
    if cell.chips > 1:
        return launch(a, cell)
    env = core.Env(device=torch.device("cuda:0"))
    return emit(core.rank_run(cell, a.seed, a.seconds, bool(a.trace), env, T_START))


if __name__ == "__main__":
    sys.exit(main())
