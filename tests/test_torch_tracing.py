"""The port's per-op tracing (`custrings_tpu_torch.utils.tracing`): the
JAX module's public names; `enabled`, `op`, `report` and `reset`; an
instrumented op recording its calls and payload bytes only while tracing
is active, with the same results either way; `device_trace` writing a
torch.profiler trace on the CPU; the package instrumenting the same op
modules as custrings_tpu; and the kernel wrappers that chip_smoke.py
captures by patching module attributes staying unwrapped."""

import json
import os
import sys

import pytest
import torch

import custrings_tpu  # noqa: F401  (instruments the JAX package's op modules)
import custrings_tpu.utils.tracing as jtracing
import custrings_tpu_torch
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch.ops import array, compact, layout, route, segments, shift_compact, unique
from custrings_tpu_torch.utils import tracing
from test_torch_split_ws import CS

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

ROWS = ["b", None, "a", "", "é😀", "b", "x" * 70, "x" * 70 + "y"]


@pytest.fixture(autouse=True)
def clean_records():
    tracing.reset()
    yield
    tracing.reset()


def test_public_names_match_the_jax_module():
    names = {"enabled", "op", "report", "reset", "traced", "instrument_module", "device_trace", "HBM_BYTES_PER_SEC"}
    assert names <= set(dir(jtracing)) and names <= set(dir(tracing))
    assert tracing.HBM_BYTES_PER_SEC == CS.HBM_BYTES_PER_S == 3.35e12


def _column_bytes(col):
    return sum(t.numel() * t.element_size() for t in (col.data, col.offsets, col.validity))


def test_instrumented_op_records_calls_and_payload_bytes():
    col = tcol.from_host_strings(ROWS, "cpu")
    with tracing.enabled():
        keys, values = unique.dictionary_encode(col)
        unique.dictionary_encode(col)
    calls, secs, nbytes = tracing._records["unique.dictionary_encode"]
    assert calls == 2 and secs > 0
    assert nbytes == 2 * (_column_bytes(col) + _column_bytes(keys) + values.numel() * 4)
    row = [line for line in tracing.report().splitlines() if line.startswith("unique.dictionary_encode ")]
    assert len(row) == 1 and row[0].split()[1] == "2"


def test_inactive_tracing_records_nothing_and_results_agree():
    col = tcol.from_host_strings(ROWS, "cpu")
    keys, values = unique.dictionary_encode(col)
    assert not tracing._records
    with tracing.enabled():
        tkeys, tvalues = unique.dictionary_encode(col)
    assert tcol.to_host_strings(tkeys) == tcol.to_host_strings(keys) and torch.equal(tvalues, values)
    assert tracing._records
    unique.dictionary_encode(col)
    assert tracing._records["unique.dictionary_encode"][0] == 1
    assert tracing.report().splitlines()[0].split()[:2] == ["op", "calls"]
    tracing.reset()
    assert tracing.report().splitlines()[1:] == []


def test_op_context_and_payload_walk():
    with tracing.op("outside"):
        pass
    assert "outside" not in tracing._records
    with tracing.enabled():
        with tracing.op("block", nbytes=123):
            pass
        with tracing.op("block", nbytes=7):
            pass
    assert tracing._records["block"][0] == 2 and tracing._records["block"][2] == 130
    col = tcol.from_host_strings(ROWS, "cpu")
    t = torch.zeros(5, dtype=torch.int64)
    assert tracing._payload_bytes(({"a": [t, col]}, (None, 3))) == 40 + _column_bytes(col)


def test_traced_slice_matches_untraced_on_the_cpu():
    rows, same = CS._traced_slice(torch, CS.make_corpus(300, seed=1), device="cpu")
    assert same
    for op in CS.TRACED_OPS:
        assert rows[op][0] >= 1 and rows[op][2] > 0, op


def test_device_trace_writes_a_trace(tmp_path):
    col = tcol.from_host_strings(ROWS, "cpu")
    logdir = tmp_path / "trace"
    with tracing.device_trace(str(logdir)):
        unique.dictionary_encode(col)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        assert json.load(f)["traceEvents"]


def _instrumented(package: str):
    """Modules of `package` (relative names) whose own functions are
    traced (a module importing a traced name from another holds it too)."""
    out = set()
    for name, mod in list(sys.modules.items()):
        if name.startswith(package + ".") and mod is not None:
            if any(getattr(v, "_traced", False) and v.__module__ == name for v in vars(mod).values()):
                out.add(name[len(package) + 1:])
    return out


def test_the_same_modules_are_instrumented_as_in_the_jax_package():
    ported = _instrumented("custrings_tpu_torch")
    assert len(ported) == 18
    assert ported == _instrumented("custrings_tpu")


def test_chip_smoke_capture_names_stay_unwrapped():
    """chip_smoke.py records a kernel's calls by patching the name where
    its caller looks it up; those names are kernel wrappers imported from
    other modules (or modules left uninstrumented), so they stay unwrapped
    and a patch sees every call."""
    sites = [(array, "ragged_gather_words"), (unique, "ragged_gather_words"), (shift_compact, "expand_to"),
             (shift_compact, "compact_arrays"), (layout, "ragged_gather"), (compact, "compact_bytes"),
             (segments, "cumsum"), (route, "expand_stream")]
    for mod, name in sites:
        assert not getattr(getattr(mod, name), "_traced", False), (mod.__name__, name)
    assert unique.dictionary_encode._traced and unique.searchsorted_keys._traced
    col = tcol.from_host_strings(ROWS, "cpu")
    before = array.ragged_gather_words
    with tracing.enabled(), CS._Calls((array, "ragged_gather_words"), (unique, "ragged_gather_words")) as log:
        unique.dictionary_encode(col)
    assert array.ragged_gather_words is before
    assert [site for site, _ in log.calls][:1] == ["array.ragged_gather_words"]
    assert custrings_tpu_torch.__doc__ and "tracing" in custrings_tpu_torch.__doc__
