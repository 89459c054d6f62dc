"""BENCHMARK.json against the contract's letter: names, units, lengths,
keys; every name it gives has its file; the references import nothing
of the port or of JAX; a run loads neither JAX nor the JAX package."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from strbench import core

BENCH = core.read_json(os.path.join(core.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        cfg = core.read_json(os.path.join(core.ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        names.append(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    all_names = [m["name"] for m in metrics] + names + [w["name"] for w in BENCH["workloads"]]
    assert len(all_names) == len(set(all_names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_four_card_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_name_has_its_file():
    for w in BENCH["workloads"]:
        c = core.cell(w["name"], BENCH)
        core.load("gen", c.config["generator"])
        for s in c.traffic["steps"]:
            core.load("steps", s["op"])
            core.load("reference", s["op"])
        for m in c.end_to_end + c.per_layer:
            assert callable(core.load("metrics", m["name"]).read)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_per_layer_metrics_move_what_their_cells_report():
    for w in BENCH["workloads"]:
        c = core.cell(w["name"], BENCH)
        reported = {m["name"] for m in c.end_to_end}
        assert {"setup_s"} < reported
        for m in c.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])


def test_every_traffic_file_has_its_steps():
    for name in os.listdir(os.path.join(core.PKG, "traffic")):
        traffic = core.read_json(os.path.join(core.PKG, "traffic", name))
        for s in traffic["steps"]:
            core.load("steps", s["op"])
            core.load("reference", s["op"])


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(core.PKG, "reference"))
                                        if f.endswith(".py")))
def test_reference_imports_nothing_of_the_port(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(core.PKG, "reference", name))}
    assert not tops & {"custrings_tpu_torch", "custrings_tpu", "jax", "jaxlib", "flax", "torch"}


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from strbench import core\n"
        "import strbench.run\n"
        "c = core.cell('tpch_sf1.vocab'); c.config.update(rows_per_card=512, text_pool_bytes=1 << 16)\n"
        "r = core.rank_run(c, 3, 0.1, False, core.Env(device=torch.device('cpu')), time.time())\n"
        "assert r['correct'], r\n"
        "print(core.forbidden_modules())\n" % core.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "custrings_tpu_torchx", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "custrings_tpu_torchx" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in core.forbidden_modules()
