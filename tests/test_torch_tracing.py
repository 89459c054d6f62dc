"""The port's spans (`custrings_tpu_torch.utils.tracing`): the JAX
module's public names; `enabled`, `op`, `report` and `reset`; an
instrumented op recording its calls and host times only while spans are
on, with the same results either way; spans off entering no profiler
range; spans under torch.profiler on the CPU as the trace's
user_annotation events, nested as the regex filter, the tokenizer and the
encode call each other; self time; no span synchronizing the device;
`kernels.launched`; `device_trace` writing a torch.profiler trace on the
CPU; the package instrumenting the same op modules as custrings_tpu; and
the kernel wrappers that chip_smoke.py captures by patching module
attributes staying unwrapped."""

import json
import os
import random
import sys
import time

import pytest
import torch

import custrings_tpu  # noqa: F401  (instruments the JAX package's op modules)
import custrings_tpu.utils.tracing as jtracing
import custrings_tpu_torch
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import kernels
from custrings_tpu_torch.ops import array, compact, layout, route, segments, shift_compact, unique
from custrings_tpu_torch.regex import ops as rops
from custrings_tpu_torch.text import token
from custrings_tpu_torch.utils import tracing
from test_torch_split_ws import CS

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

ROWS = ["b", None, "a", "", "é😀", "b", "x" * 70, "x" * 70 + "y"]
#: the fewest rows for which the regex filter computes the host row statistics
MIN_ROWS = layout.MIN_ROWS


@pytest.fixture(autouse=True)
def clean_records():
    tracing.reset()
    yield
    tracing.reset()


def test_public_names_match_the_jax_module():
    names = {"enabled", "op", "report", "reset", "traced", "instrument_module", "device_trace"}
    assert names <= set(dir(jtracing)) and names <= set(dir(tracing))
    # the payload-bytes roofline (host time over whole capacities) is gone
    assert not {"HBM_BYTES_PER_SEC", "_payload_bytes", "_sync"} & set(dir(tracing))


def test_instrumented_op_records_calls_and_payload_bytes():
    col = tcol.from_host_strings(ROWS, "cpu")
    with tracing.enabled():
        unique.dictionary_encode(col)
        unique.dictionary_encode(col)
    calls, total, own = tracing._records["unique.dictionary_encode"]
    assert calls == 2 and 0 < own <= total
    row = [line for line in tracing.report().splitlines() if line.startswith("unique.dictionary_encode ")]
    assert len(row) == 1 and row[0].split()[1] == "2"
    assert float(row[0].split()[2]) == pytest.approx(total * 1e3, abs=1e-3)


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
    assert tracing.report().splitlines()[0].split() == ["span", "calls", "total_ms", "self_ms", "(host", "clock)"]
    tracing.reset()
    assert tracing.report().splitlines()[1:] == []


def test_op_context_and_payload_walk():
    with tracing.op("outside"):
        pass
    assert "outside" not in tracing._records
    with tracing.enabled():
        with tracing.op("block"):
            pass
        with tracing.op("block"):
            pass
    assert tracing._records["block"][0] == 2 and tracing._records["block"][1] >= 0


def test_traced_slice_matches_untraced_on_the_cpu():
    rows, same = CS._traced_slice(torch, CS.make_corpus(300, seed=1), device="cpu")
    assert same
    for op in CS.TRACED_OPS:
        assert rows[op][0] >= 1 and rows[op][1] > 0, op


def test_device_trace_writes_a_trace(tmp_path):
    col = tcol.from_host_strings(ROWS, "cpu")
    logdir = tmp_path / "trace"
    with tracing.device_trace(str(logdir)):
        unique.dictionary_encode(col)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "unique.dictionary_encode" for e in events)


def _text_rows(n, seed):
    rng = random.Random(seed)
    words = ["special", "requests", "the", "ab", "é", "x" * 30, ""]
    return [None if rng.random() < 0.05 else " ".join(rng.choice(words) for _ in range(rng.randint(0, 6)))
            for _ in range(n)]


class _Counter:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def test_spans_off_enter_no_profiler_range(monkeypatch):
    """Off (no tracing.enabled(), no profiler), a span site enters no
    record_function; the results equal those with spans on."""
    rf = _Counter(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(unique, "HASHED_MIN", 64)
    col = tcol.from_host_strings(_text_rows(MIN_ROWS, 3), "cpu")

    def run():
        toks = token.tokenize(col, " ")
        keys, values = unique.dictionary_encode(toks)
        return rops.contains_re(col, "special.*requests"), tcol.to_host_strings(keys), values

    off = run()
    assert rf.calls == 0 and not tracing._records
    with tracing.enabled():
        on = run()
    assert rf.calls > 0 and tracing._records
    assert torch.equal(off[0], on[0]) and off[1] == on[1] and torch.equal(off[2], on[2])


def _annotations(prof, tmp_path):
    """(name, start, end) of the profiler's user_annotation events."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _within(spans, inner, outer):
    """Every `inner` span lies inside some `outer` span; there is one."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    ins = [(s, e) for n, s, e in spans if n == inner]
    return bool(ins) and all(any(os_ <= s and e <= oe for os_, oe in outs) for s, e in ins)


def test_profiler_spans_nest_in_the_regex_filter(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    col = tcol.from_host_strings(_text_rows(MIN_ROWS + 44, 4), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = rops.contains_re(col, "special.*requests")
    spans = _annotations(prof, tmp_path)
    for inner, outer in [("layout.host_row_stats", "regex.contains_re"),
                         ("layout.host_row_stats", "layout.length_buckets"),
                         ("layout.length_buckets", "regex.contains_re"),
                         ("layout.row_nonascii_ids", "layout.char_matrix"),
                         ("layout.char_matrix", "regex.contains_re"),
                         ("regex.engine", "regex.contains_re")]:
        assert _within(spans, inner, outer), (inner, outer)
    assert torch.equal(got, rops.contains_re(col, "special.*requests"))
    assert tracing._records["regex.contains_re"][0] == 1  # on while the profiler ran


def test_profiler_spans_nest_in_the_tokenizer_and_the_encode(tmp_path, monkeypatch):
    """A small column takes the hashed encode, as the vocabulary cell's
    10.8M tokens do, when HASHED_MIN is low."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(unique, "HASHED_MIN", 64)
    col = tcol.from_host_strings(_text_rows(300, 5), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        toks = token.tokenize(col, " ")
        unique.dictionary_encode(toks)
    spans = _annotations(prof, tmp_path)
    for inner in ("split.ragged_extents", "split.ragged_write"):
        assert _within(spans, inner, "text.tokenize"), inner
    for inner in ("unique.hash_group", "unique.rep_rank", "unique.ambiguity_check", "unique.gather_keys"):
        assert _within(spans, inner, "unique.dictionary_encode"), inner
    assert not any(n == "unique.sorted_encode" for n, _, _ in spans)
    monkeypatch.setattr(unique, "HASHED_MIN", 1 << 18)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        unique.dictionary_encode(toks)
    assert _within(_annotations(prof, tmp_path), "unique.sorted_encode", "unique.dictionary_encode")


def test_nested_spans_give_the_parent_its_self_time():
    with tracing.enabled():
        with tracing.op("parent"):
            time.sleep(0.002)
            with tracing.op("child"):
                time.sleep(0.004)
            with tracing.op("child"):
                time.sleep(0.001)
    p_calls, p_total, p_self = tracing._records["parent"]
    c_calls, c_total, c_self = tracing._records["child"]
    assert p_calls == 1 and c_calls == 2 and c_self == c_total >= 0.005
    assert p_self == pytest.approx(p_total - c_total, rel=0, abs=1e-9)
    assert p_total >= 0.007 and 0.002 <= p_self < p_total
    assert not tracing._stack()


def test_spans_never_synchronize_the_device(monkeypatch):
    sync = _Counter(lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setitem(kernels.LAUNCHES, "hash", 0)
    traced = tracing.traced("outer")(lambda x: x + 1)
    with tracing.enabled():
        with tracing.op("a"):
            with kernels.launched("hash"):
                assert traced(1) == 2
        tracing.report()
    assert sync.calls == 0
    assert kernels.LAUNCHES["hash"] == 1 and tracing._records["kernel.hash"][0] == 1


def test_launched_counts_only_a_launch_that_returns(monkeypatch):
    monkeypatch.setitem(kernels.LAUNCHES, "scan_sum", 5)
    with kernels.launched("scan_sum"):
        pass
    with pytest.raises(RuntimeError), kernels.launched("scan_sum"):
        raise RuntimeError("launch failed")
    assert kernels.LAUNCHES["scan_sum"] == 6 and not tracing._records
    with tracing.enabled(), kernels.launched("scan_sum"):
        pass
    assert kernels.LAUNCHES["scan_sum"] == 7 and tracing._records["kernel.scan_sum"][0] == 1


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
