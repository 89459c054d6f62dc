"""Each mix's pass against its reference at a tiny size on the CPU, the
controls, and the faults planted underneath the timed path."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from strbench import core
from strbench.tests import faults

ONE_CARD = {"tpch.q13": 4096, "tpch_sf1.vocab": 1024}
#: a mix of the other step kinds, for cells that later changes add: a
#: regex filter, a literal replace and an encode of the result
CHAIN = {
    "steps": [
        {"op": "contains_re", "span": "regex_filter", "in": "col", "out": "mask", "pattern": r"\bfurious\w*"},
        {"op": "replace", "span": "replace", "in": "col", "out": "r", "pat": "the", "repl": "THE"},
        {"op": "categorize", "span": "encode", "in": "r", "out": "cat"},
    ],
    "control": {"out": "cat", "variant": "first_seen"},
}


def _small(c, rows):
    c.config["rows_per_card"] = rows
    c.config["text_pool_bytes"] = min(c.config["text_pool_bytes"], 1 << 16)
    return c


def _cell(workload, rows):
    if workload == "chain":
        base = core.cell("tpch_sf1.vocab")
        return _small(core.Cell("chain", 1, base.config, CHAIN, base.end_to_end, base.per_layer), rows)
    return _small(core.cell(workload), rows)


def _run(workload, seed=2**31 + 17):
    c = _cell(workload, ONE_CARD.get(workload, 2048))
    return core.rank_run(c, seed, 0.05, False, core.Env(device=torch.device("cpu")), time.time())


@pytest.mark.parametrize("workload", [*sorted(ONE_CARD), "chain"])
def test_pass_equals_reference(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in _cell(workload, 1).end_to_end} - {"peak_device_gib"}
    assert list(r)[-1] == "checks"


def test_traced_pass_reports_per_layer_metrics():
    c = _cell("tpch_sf1.vocab", 512)
    r = core.rank_run(c, 5, 0.05, True, core.Env(device=torch.device("cpu")), time.time())
    assert r["correct"]
    assert {"op_ms.tokenize", "op_ms.encode", "ingest_ms", "launches_per_pass", "syncs_per_pass"} <= set(r["metrics"])
    assert "tokenize_roofline" not in r["metrics"]  # no device time to read on the CPU
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _four_card_bench():
    """BENCHMARK.json with a four-card cell of the sharded encode over the
    SF 1 comments, for the gloo job and its control."""
    bench = core.read_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    bench["workloads"].append({"name": "tpch_sf1_4shard.encode", "config": "tpch_sf1_orders",
                               "traffic": "encode", "chips": 4, "why": "test"})
    return bench


@pytest.mark.parametrize("workload", [*sorted(ONE_CARD), "chain"])
def test_control_is_not_correct(workload):
    checks = core.control(_cell(workload, ONE_CARD.get(workload, 1024)), 2**31 + 29)
    assert max(checks.values()) > core.LIMIT, checks


def test_sharded_control_is_not_correct():
    c = _small(core.cell("tpch_sf1_4shard.encode", _four_card_bench()), 256)
    checks = core.control(c, 2**31 + 29)
    assert max(checks.values()) > core.LIMIT, checks


FAULTS = [
    ("chain", "replace_unchanged"), ("chain", "filter_half"), ("chain", "encode_altered"),
    ("tpch.q13", "filter_half"), ("tpch.q13", "filter_altered"),
    ("tpch_sf1.vocab", "tokenize_half"), ("tpch_sf1.vocab", "tokenize_altered"),
    ("tpch_sf1.vocab", "encode_altered"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    from custrings_tpu_torch import category
    from custrings_tpu_torch.ops import modify
    from custrings_tpu_torch.regex import ops as rops
    from custrings_tpu_torch.text import token

    for mod, attr in ((category, "from_strings"), (modify, "replace_literal"), (rops, "contains_re"),
                      (token, "tokenize")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))  # restored after the test
    faults.plant(fault)
    r = _run(workload)
    assert not r["correct"], (fault, r["checks"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault", ["none", "no_exchange", "sharded_half", "sharded_altered"])
def test_four_rank_job_on_gloo(fault, tmp_path):
    port, out, bench = _free_port(), tmp_path / "rank0.json", tmp_path / "bench.json"
    bench.write_text(json.dumps(_four_card_bench()))
    worker = os.path.join(core.PKG, "tests", "rank_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(bench), "tpch_sf1_4shard.encode", str(r), "4",
                               str(port), "384", "1234567891234", fault, str(out)],
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(4)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), errs[0][-2000:]
    r = json.loads(out.read_text())
    assert r["correct"] == (fault == "none"), r["checks"]
    assert r["device"]["count"] == 4


@pytest.mark.cuda
def test_one_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(core.PKG, "run.py"), "--workload", "tpch_sf1.vocab",
                          "--seed", "11", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
