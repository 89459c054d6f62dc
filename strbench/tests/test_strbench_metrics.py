"""The metric arithmetic: the tail over all passes, the idle share, counts
and span attribution from a synthetic trace's events, the roofline's
bytes."""

import types

import numpy as np
import pytest
import torch

from strbench import core, trace
from strbench.metrics import PEAK_BYTES_PER_S, column_bytes, span_device_s


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _ctx(**kw):
    base = dict(cell=None, env=types.SimpleNamespace(device=torch.device("cuda")), setup_s=1.0,
                ingest_s=0.002, pass_s=[0.1], window_s=1.0, rows_per_pass=10, peak_window_bytes=2**31)
    base.update(kw)
    return core.Context(**base)


def test_pass_p95_counts_every_pass():
    times = [0.010] * 95 + [0.100] * 5
    got = core.load("metrics", "pass_p95_ms").read(_ctx(pass_s=times))
    assert got == pytest.approx(np.percentile(np.array(times) * 1e3, 95))
    assert 10.0 < got < 100.0


def test_rows_per_s_over_the_whole_window():
    got = core.load("metrics", "rows_per_s").read(_ctx(pass_s=[0.1] * 30, window_s=3.5, rows_per_pass=1000))
    assert got == pytest.approx(30 * 1000 / 3.5)


def _synthetic():
    # two passes of 1000 us; kernels busy 100-400, 300-500 (overlap), 1100-1300
    return {"traceEvents": [
        _ev("user_annotation", trace.PASS_SPAN, 0, 1000),
        _ev("user_annotation", trace.PASS_SPAN, 1000, 1000),
        _ev("user_annotation", "strbench.encode", 50, 600),
        _ev("user_annotation", "strbench.encode", 1050, 600),
        _ev("kernel", "sort_kernel", 100, 300),
        _ev("kernel", "ncclDevKernel_AllGather", 300, 200),
        _ev("gpu_memcpy", "Memcpy DtoH", 1100, 200),
        _ev("cuda_runtime", "cudaStreamSynchronize", 1290, 20),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 1700, 50),
        _ev("cpu_op", "aten::item", 1400, 500),
        {"ph": "M", "name": "process_name"},
    ]}


def test_trace_events_from_synthetic_intervals():
    t = trace.read(_synthetic())
    assert t.passes == 2
    assert t.window_s == pytest.approx(2000e-6)
    assert t.busy_s == pytest.approx(600e-6)  # 100-500 and 1100-1300
    assert [e.span for e in t.device] == ["encode", "encode", "encode"]
    spans = {e.name: e.span for e in t.host}
    assert spans["aten::item"] == "encode" and spans["cudaDeviceSynchronize"] is None  # 1700: after its end
    ctx = _ctx(trace=t)
    assert core.load("metrics", "device_idle_pct").read(ctx) == pytest.approx(70.0)
    assert core.load("metrics", "collective_ms").read(ctx) == pytest.approx(0.1)
    assert core.load("metrics", "launches_per_pass").read(ctx) == pytest.approx(1.0)
    assert core.load("metrics", "syncs_per_pass").read(ctx) == pytest.approx(0.5)
    assert span_device_s(ctx, "encode") == pytest.approx(350e-6)
    assert span_device_s(ctx, "replace") == 0
    b = t.breakdown()
    assert b["idle_gaps"][0][0] == "aten::item"  # the longest stretch: 1300-2000 under aten::item
    assert dict(b["device_ops"])["sort_kernel"] == pytest.approx(300e-6)


def test_no_collective_reads_nothing():
    ev = _synthetic()
    ev["traceEvents"] = [e for e in ev["traceEvents"] if "nccl" not in e["name"]]
    assert core.load("metrics", "collective_ms").read(_ctx(trace=trace.read(ev))) is None
    assert core.load("metrics", "launches_per_pass").read(_ctx()) is None


def test_gaps_and_union():
    busy = trace.union([(5, 7), (1, 3), (2, 4)])
    assert busy == [[1, 4], [5, 7]]
    assert trace.gaps(busy, 0, 10) == [(0, 1), (4, 5), (7, 10)]


def _col(rows):
    from custrings_tpu_torch import column

    return column.from_host_strings(rows, "cpu")


def test_roofline_bytes():
    col = _col(["ab", None, "cde", ""])
    assert column_bytes(col) == 5 + 4 * 5 + 4
    rf = core.load("metrics", "regex_filter_roofline")
    assert rf.nbytes(col, torch.zeros(4, dtype=torch.bool)) == 29 + 4
    assert rf.nbytes(col, (torch.zeros(4, dtype=torch.bool), 3)) == 29 + 4 + 8
    out = _col(["aB", None, "cdE", ""])
    assert core.load("metrics", "replace_roofline").nbytes(col, out) == 29 + 5 + 20
    from custrings_tpu_torch import category

    cat = category.from_strings(col)
    assert core.load("metrics", "encode_roofline").nbytes(col, cat) == 29 + column_bytes(cat.keys) + 16
    toks = _col(["ab", "cde"])
    assert core.load("metrics", "tokenize_roofline").nbytes(col, toks) == 29 + 5 + 12 + 2


def test_roofline_share_from_span_time():
    col = _col(["x" * 1000] * 10)
    ctx = _ctx(trace=trace.read(_synthetic()), io={"encode": (col, None)})
    nbytes = lambda c, o: 10_000_000  # noqa: E731
    from strbench.metrics import roofline_pct

    got = roofline_pct(ctx, "encode", nbytes)
    assert got == pytest.approx(100 * 10_000_000 / PEAK_BYTES_PER_S / 350e-6)
    assert roofline_pct(ctx, "replace", nbytes) is None  # nothing to read: left out
