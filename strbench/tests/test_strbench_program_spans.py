"""The readers of the port's own spans (`filter_idle_ms`, `row_stats_ms`,
`encode_idle_ms`) on synthetic Chrome events: nested program spans, a
device busy stretch across a span's edge, and a trace without them (an
older program), which gives None; and their entries in BENCHMARK.json."""

import types

import pytest
import torch

from strbench import core, trace

NEW = ("filter_idle_ms", "row_stats_ms", "encode_idle_ms")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _ann(name, ts, end):
    return _ev("user_annotation", name, ts, end - ts)


def _ctx(t):
    return core.Context(cell=None, env=types.SimpleNamespace(device=torch.device("cuda")), setup_s=1.0,
                        ingest_s=0.0, pass_s=[0.001], window_s=1.0, rows_per_pass=10, peak_window_bytes=0,
                        trace=t)


def _q13(program_spans=True):
    """Two passes of 1000 us.  Pass 1: the filter's span 20-800 holds the
    length classes 30-400 (the row statistics 40-300 inside) and the
    non-ASCII ids 450-500; the device is busy 250-350 (across the row
    statistics' end) and 600-900 (across the filter's).  Pass 2: the
    filter 1020-1800, the length classes 1030-1100, busy 1100-1200."""
    ev = [
        _ann(trace.PASS_SPAN, 0, 1000), _ann(trace.PASS_SPAN, 1000, 2000),
        _ann("strbench.regex_filter", 10, 900), _ann("strbench.regex_filter", 1010, 1900),
        _ev("kernel", "window_bytes", 250, 100), _ev("gpu_memcpy", "Memcpy DtoH", 600, 300),
        _ev("kernel", "nfa_bits", 1100, 100),
        _ev("cpu_op", "aten::copy_", 600, 300),
    ]
    if program_spans:
        ev += [
            _ann("regex.contains_re", 20, 800), _ann("layout.length_buckets", 30, 400),
            _ann("layout.host_row_stats", 40, 300), _ann("layout.row_nonascii_ids", 450, 500),
            _ann("regex.contains_re", 1020, 1800), _ann("layout.length_buckets", 1030, 1100),
        ]
    return trace.read({"traceEvents": ev})


def _read(name, t):
    return core.load("metrics", name).read(_ctx(t))


def test_filter_idle_is_the_span_less_the_busy_union():
    # pass 1: 20-250 and 350-600 idle (480 us); pass 2: 1020-1100 and 1200-1800 (680 us)
    assert _read("filter_idle_ms", _q13()) == pytest.approx((480 + 680) / 2 * 1e-3)


def test_row_stats_count_nested_spans_once():
    # 30-400 holds 40-300; with 450-500 and 1030-1100: 370 + 50 + 70 us
    assert _read("row_stats_ms", _q13()) == pytest.approx((370 + 50 + 70) / 2 * 1e-3)


def test_idle_gaps_name_the_innermost_program_span():
    labels = dict(_q13().breakdown()["idle_gaps"])
    assert max(labels, key=labels.get) == "regex.contains_re"  # 1200-2000, midpoint in the filter alone
    assert labels["layout.host_row_stats"] == pytest.approx(250e-6)  # 0-250
    assert "strbench.regex_filter" not in labels
    older = dict(_q13(program_spans=False).breakdown()["idle_gaps"])
    assert max(older, key=older.get) == "strbench.regex_filter"


def test_encode_idle_under_nested_spans():
    ev = [
        _ann(trace.PASS_SPAN, 0, 1000),
        _ann("strbench.encode", 50, 950),
        _ann("unique.dictionary_encode", 100, 700),
        _ann("unique.hash_group", 150, 400), _ann("unique.ambiguity_check", 400, 450),
        _ev("kernel", "hash_rows", 200, 100), _ev("kernel", "sort", 650, 200),
    ]
    # 100-200, 300-650 idle: 450 us in one pass
    assert _read("encode_idle_ms", trace.read({"traceEvents": ev})) == pytest.approx(0.45)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    assert _read(name, _q13(program_spans=False)) is None
    assert core.load("metrics", name).read(_ctx(None)) is None


@pytest.mark.parametrize("name", NEW)
def test_entries_keep_the_letter(name):
    bench = core.read_json(core.ROOT + "/BENCHMARK.json")
    m = {x["name"]: x for x in bench["per_layer"]}[name]
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
    assert [x["name"] for x in bench["per_layer"]][-len(NEW):] == list(NEW)  # appended, last
    for w in m["workloads"]:
        c = core.cell(w, bench)
        assert name in {x["name"] for x in c.per_layer}
        assert m["moves"] in {x["name"] for x in c.end_to_end}
    layers = {x["layer"] for x in bench["per_layer"] if x["name"] not in NEW}
    assert m["layer"] in layers


def test_span_split_rows():
    from strbench import span_split

    rows = {r["span"]: r for r in span_split.split(_q13(), {"regex.contains_re": [2, 1.56e-3, 0.4e-3]})}
    f = rows["regex.contains_re"]
    assert f["ms"] == pytest.approx((780 + 780) / 2 * 1e-3)
    assert f["idle_ms"] == pytest.approx(_read("filter_idle_ms", _q13()))
    assert (f["calls"], f["self_ms"]) == (1.0, pytest.approx(0.2))
    assert rows["layout.host_row_stats"]["calls"] is None  # no record: not a program span here
    assert list(rows)[0] == trace.PASS_SPAN  # the longest first
