"""Where the port's slice spends its time at 1M rows, on one CUDA card.

    python3 profile_slice.py         # after chip_smoke.py has passed

For each op of the slice (contains_re(#\\w+), replace_literal("the",
"THE"), dictionary_encode, the growing and shrinking replace_literal
("THEE", "T"), split_record(" ")) and each span op (count_re("the|that"),
findall_record(#\\w+), replace_re((\\w+)@(\\w+))) on a fresh 1M-row
column of chip_smoke.make_corpus(): the wall time without the profiler,
and under torch.profiler the wall time, the summed device time and the
twelve device items that took longest.  Then the parts of contains_re timed
alone with CUDA events: the char matrix (streaming view and K1 window
routes), the per-position tables and the K2 wrapper.  Last, the three
ops in sequence on a fresh column on each padded-view route (the
streaming view the slice takes at 1M rows, and the K1 window view),
alternated stream, window, window, stream.  One JSON line each.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs


def _timed(torch, fn):
    """(fn's result, its wall ms with the device drained on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import layout, modify, split, unique
    from custrings_tpu_torch.regex import ops as rx

    strs = cs.make_corpus(cs.ROWS, seed=0)

    def fresh():
        return column.from_host_strings(strs, "cuda")

    ops = {
        "contains_re": lambda c: rx.contains_re(c, cs.PATTERN),
        "replace_literal": lambda c: modify.replace_literal(c, "the", "THE"),
        "dictionary_encode": lambda c: unique.dictionary_encode(c),
        "replace_grow": lambda c: modify.replace_literal(c, "the", "THEE"),
        "replace_shrink": lambda c: modify.replace_literal(c, "the", "T"),
        "split_record": lambda c: split.split_record(c, " "),
        "count_re": lambda c: rx.count_re(c, cs.SPAN_COUNT),
        "findall_record": lambda c: rx.findall_record(c, cs.SPAN_FIND),
        "replace_re": lambda c: rx.replace_re(c, cs.SPAN_REPLACE, "EMAIL"),
    }
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum()
    for name, fn in ops.items():
        fn(fresh())  # warm-up: regex compile, tables, allocator
        c = fresh()
        _, cold = _timed(torch, lambda: fn(c))
        c = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            fn(c)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        dev_ms = sum(e.self_device_time_total for e in ka if e.device_type == cuda) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:12]
        print(json.dumps({
            "op": name, "wall_ms": cold, "wall_ms_profiled": wall, "device_ms": dev_ms,
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top],
        }), flush=True)

    col = fresh()
    width = layout.max_row_bytes(col)
    na = torch.from_numpy(layout.row_nonascii_ids(col)).cuda()
    chars, nch = layout.char_matrix(col, width)
    nfa = rx._get_nfa(cs.PATTERN)
    membw, uid = nfa._pos_tables(chars, nch, True)
    print(json.dumps({
        "part": "contains_re",
        "char_matrix_stream_ms": cs._time_ms(
            torch, lambda: layout._char_matrix_hybrid(col, None, na, width, True)),
        "char_matrix_window_ms": cs._time_ms(
            torch, lambda: layout._char_matrix_hybrid(col, None, na, width, False)),
        "pos_tables_ms": cs._time_ms(torch, lambda: nfa._pos_tables(chars, nch, True)),
        "nfa_wrapper_ms": cs._time_ms(
            torch, lambda: nfa._matches_bits(chars, nch, membw, uid, False)),
    }), flush=True)
    del col, chars, nch, membw, uid

    # the slice's ops in sequence on each padded-view route (the streaming
    # view, as the slice takes it at 1M rows, and the K1 window view),
    # alternated so drift shows, with the allocator already warm
    default_min = layout.STREAM_VIEW_MIN
    for route in ("stream", "window", "window", "stream"):
        layout.STREAM_VIEW_MIN = default_min if route == "stream" else 1 << 62
        c = fresh()
        ms = {}
        _, ms["contains_re"] = _timed(torch, lambda: ops["contains_re"](c))
        r, ms["replace_literal"] = _timed(torch, lambda: ops["replace_literal"](c))
        _, ms["dictionary_encode"] = _timed(torch, lambda: ops["dictionary_encode"](r))
        print(json.dumps({"route": route, "ms": ms, "sum_ms": sum(ms.values())}), flush=True)
    layout.STREAM_VIEW_MIN = default_min
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
