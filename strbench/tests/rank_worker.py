"""One rank of a small job on the CPU (gloo), for the tests:

    python strbench/tests/rank_worker.py BENCH WORKLOAD RANK WORLD PORT ROWS SEED FAULT OUT

runs the cell WORKLOAD of the benchmark file BENCH at ROWS rows a rank
(and a small text pool) with the named fault planted in the port (or
"none"), and rank 0 writes its result as JSON to OUT."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from strbench import core  # noqa: E402
from strbench.tests import faults  # noqa: E402


def main(argv):
    bench, workload, rank, world, port, rows, seed, fault, out = argv
    torch.set_num_threads(1)
    faults.plant(fault)
    c = core.cell(workload, core.read_json(bench))
    c.config["rows_per_card"] = int(rows)
    c.config["text_pool_bytes"] = min(c.config["text_pool_bytes"], 1 << 16)
    env = core.join(int(rank), int(world), int(port), "cpu")
    try:
        res = core.rank_run(c, int(seed), 0.2, False, env, time.time())
    finally:
        torch.distributed.destroy_process_group()
    if int(rank) == 0:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
