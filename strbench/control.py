"""The control's readings: the traffic's control variant of the reference
(one guarantee of the configuration broken) put in the program's place,
at the cell's own size, judged as a run is judged.

    python3 strbench/control.py --workload tpch.q13 --seeds 1,2,3

Prints one JSON line a seed: {"workload", "seed", "checks", "correct"},
where `correct` has to come out false for every seed.  It reads no
program output, needs no card, and is not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    a = p.parse_args(argv)
    c = core.cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        checks = core.control(c, seed)
        print(json.dumps({"workload": a.workload, "seed": seed, "checks": checks,
                          "correct": all(v <= core.LIMIT for v in checks.values()),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
