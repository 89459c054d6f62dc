r"""Run the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line:
  0. device  — the card's name and power limit (nvidia-smi)
  1. build   — nvcc builds custrings_tpu_torch/csrc/*.cu
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the main paths' shapes, compared exactly, with median
               times, the kernel's bound (the larger of its bytes over
               the card's 3.35 TB/s and its ops over 67 T op/s) and,
               where one PyTorch call computes the same function, that
               call's time
     views   — the two padded-view routes at the slice's widths: the
               streaming view (K4c/K4e, the route the slice takes at 1M
               rows) against the K1 window gather, compared exactly, timed
  3. slice   — to_device -> contains(r"#\w+") -> replace("the", "THE")
               -> nvcategory.from_strings -> keys/values, then the growing
               and shrinking replace("the", "THEE" / "T") and
               split_record(" "), -> to_host, on 1M rows of make_corpus(),
               checked against Python oracles
  4. spans   — count("the|that"), findall_record(r"#\w+") and
               replace(r"(\w+)@(\w+)", "EMAIL") on the same rows, checked
               against Python `re`, with the round count of each all_spans
  5. launches — each path's kernel counters (reset just before the path,
               read just after) are above zero for the kernels it runs
Then the kernels JSON line, the nvidia-smi line, and the final
{"ok": true, "device": {...}} line.  Any failure exits nonzero.

make_corpus() builds the tweet-like corpus from a seed with numpy; the
CPU tests import it at a small size.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROWS = 1 << 20
PATTERN = r"#\w+"
SPAN_COUNT = "the|that"
SPAN_FIND = r"#\w+"
SPAN_REPLACE = r"(\w+)@(\w+)"
REPS = 5
#: the H100 SXM's device-memory rate (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
#: the H100 SXM's float32 rate outside the tensor cores (NVIDIA data
#: sheet), taken as the peak of the 32-bit integer ops the kernels do
OPS_PER_S = 67e12

_WORDS = (
    "the the the theme other there then THE a to of and in is it for you on "
    "with at this my be so we just like new love day time now more get out "
    "today great see good check free win lol rt via feel back need know "
    "people world think game best happy night week year"
).split()
_TAGS = ["#data", "#ai", "#news", "#the", "#theme", "#gpu", "#tbt", "#x_1", "#2024"]
_MENTIONS = ["@user", "@them", "@nvidia", "@dev_team", "@a1"]
_URLS = ["http://t.co/abc123", "https://example.com/the/path?q=1", "www.site.org"]
_DIGITS = ["0", "42", "1999", "3.14", "+1", "12:30", "100%"]
_PUNCT = [",", ".", "!", "?", "-", ":", ";", "(", ")", '"', "'", "&", "...", "#", "##"]
_NONASCII = ["café", "über", "naïve", "straße", "日本語", "中文", "テキスト", "🎉", "😀🔥", "#ünï", "#日本"]
_EMAILS = ["ann@example", "bob_1@host", "x@y", "dev.team@gpu", "ünï@cöde"]
_PREFIXES = [  # 64 bytes each: the dictionary encode's first key width
    "breaking: the quarterly report from the northern data centre says"[:64],
    "thread 1/7 about the theme of the conference and the people there"[:64],
]


def _tokens():
    groups = [(_WORDS, 0.70), (_TAGS, 0.07), (_MENTIONS, 0.05), (_URLS, 0.03),
              (_DIGITS, 0.06), (_PUNCT, 0.09)]
    toks, probs = [], []
    for words, p in groups:
        toks += words
        probs += [p / len(words)] * len(words)
    probs = np.asarray(probs)
    return np.asarray(toks, dtype=object), probs / probs.sum()


def _fill(rng, n: int, max_bytes: int, tok, tlen, stream: int):
    """n rows of space-joined tokens, each at most its target byte length
    (uniform in [0, max_bytes])."""
    target = rng.integers(0, max_bytes + 1, n)
    cum = np.concatenate([[0], np.cumsum(tlen + 1)])
    start = rng.integers(0, stream - max_bytes, n)
    end = np.searchsorted(cum, cum[start] + target + 1, side="right") - 1
    return [" ".join(tok[s:e]) for s, e in zip(start.tolist(), end.tolist())]


def _cut(s: str, max_bytes: int) -> str:
    b = s.encode("utf-8")
    return s if len(b) <= max_bytes else b[:max_bytes].decode("utf-8", "ignore")


def make_corpus(n: int, seed: int = 0, max_bytes: int = 280):
    """Tweet-like rows of 0..max_bytes UTF-8 bytes: ~3% non-ASCII, ~1%
    None, ~1% empty, ~30% drawn from a pool of 5,000 repeated strings,
    ~2% longer than 64 bytes that share one of two 64-byte prefixes, and
    ~3% that start with an address-like word@word token."""
    rng = np.random.default_rng(seed)
    tok, probs = _tokens()
    stream = max(4 * max_bytes, 1 << 16)
    ids = rng.choice(len(tok), size=stream, p=probs)
    stream_tok = tok[ids]
    tlen = np.fromiter((len(t.encode()) for t in stream_tok), np.int64, stream)
    rows = _fill(rng, n, max_bytes, stream_tok, tlen, stream)
    pool = _fill(rng, 5000, max_bytes, stream_tok, tlen, stream)
    kind = rng.random(n)
    pick = rng.integers(0, len(pool), n)
    na = rng.integers(0, len(_NONASCII), n)
    pre = rng.integers(0, len(_PREFIXES), n)
    for i in np.nonzero(kind < 0.30)[0].tolist():
        rows[i] = pool[pick[i]]
    for i in np.nonzero((kind >= 0.30) & (kind < 0.33))[0].tolist():
        rows[i] = _cut(_NONASCII[na[i]] + " " + rows[i], max_bytes)
    for i in np.nonzero((kind >= 0.33) & (kind < 0.35))[0].tolist():
        rows[i] = _cut(_PREFIXES[pre[i]] + " " + rows[i], max_bytes)
    for i in np.nonzero((kind >= 0.35) & (kind < 0.36))[0].tolist():
        rows[i] = None
    for i in np.nonzero((kind >= 0.36) & (kind < 0.37))[0].tolist():
        rows[i] = ""
    mail = rng.random(n) < 0.03
    em = rng.integers(0, len(_EMAILS), n)
    for i in np.nonzero(mail)[0].tolist():
        if rows[i] is not None:
            rows[i] = _cut(_EMAILS[em[i]] + " " + rows[i], max_bytes)
    return rows


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = REPS) -> float:
    """Median of `reps` timed calls (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(torch, name, got, want):
    """Exact comparison of a tensor or a tuple of tensors; returns the max
    absolute difference (0)."""
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        return max(_compare(torch, name, g, w) for g, w in zip(got, want, strict=True))
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item() if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return float(err)


def _route_inputs(torch, col, width):
    """The K4c and K4e inputs of the streaming views at the slice's shapes:
    the keep mask and its prefix count of the width-64 truncated view, and
    the live mask and distances of the full-width view."""
    from custrings_tpu_torch.column import cumsum0
    from custrings_tpu_torch.ops import segments

    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    keep = ((j - segments.row_start_positions(col.offsets, cap)) < 64) & (j < col.offsets[-1])
    k0 = cumsum0(keep)
    vr = torch.arange(col.size, dtype=torch.int32, device=col.device) * width - col.offsets[:-1]
    dist = segments.broadcast_rows_to_bytes(vr, col.offsets, cap)
    live = j < col.offsets[-1]
    return keep, k0, live, dist


def _bound(nbytes: float, nops: float):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of nbytes at its memory rate and nops at its op rate."""
    by_bytes = float(nbytes) / HBM_BYTES_PER_S * 1e3
    by_ops = float(nops) / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _span_inputs(torch, chars, nch):
    """Per span pattern: its span passes, K2's planes over the char matrix
    (the 64K tables: right for every row), and the start positions 0 and a
    seeded random one in [0, length]."""
    from custrings_tpu_torch.regex import ops as rx

    g = torch.Generator(device="cpu").manual_seed(1)
    rand = (torch.rand(nch.shape[0], generator=g) * (nch.cpu() + 1).float()).floor().to(torch.int32).cuda()
    zero = torch.zeros_like(nch)
    out = []
    for pat in (SPAN_FIND, SPAN_COUNT, SPAN_REPLACE, r"\bthe\b"):
        sb = rx._span_program(pat)._span_bits()
        membw, uid = sb.tables(chars, nch)
        out.append((pat, sb, membw, uid, [("start 0", zero), ("random start", rand)]))
    return out


def _walk(torch, nfa, per_row: int, first, end):
    """(bytes, ops) of a bit-state walk over positions first..end-1 of each
    row (none where end <= first): chars and membw (and uid with several
    closure variants) read at each position plus per_row bytes a row, and
    per position the two loops over the instructions (~3 ops per
    instruction each) and the char compares of the predicate."""
    npos = (end.to(torch.int64) - first.to(torch.int64)).clamp(min=0).sum().item()
    per_pos = 12 if nfa.U > 1 else 8
    ops = 6 * nfa.I + 2 * len(nfa.char_pairs) + 10
    return npos * per_pos + per_row * first.shape[0], npos * ops


def _kernel_phase(torch, col, width):
    """Each kernel against its plain version at the main paths' shapes; the
    first shape of each is the one its headline time, bound and library
    time are taken at."""
    from custrings_tpu_torch.column import cumsum0
    from custrings_tpu_torch.ops import layout, route, scan, window
    from custrings_tpu_torch.regex import ops as rx

    g = torch.Generator(device="cpu").manual_seed(0)
    lens = col.lengths()
    signed = torch.randint(-(1 << 30), 1 << 30, (col.size,), generator=g, dtype=torch.int32).cuda()
    perm = torch.randperm(col.size, generator=g).cuda()
    first = torch.rand(col.size, generator=g).cuda() < 0.6
    starts = col.offsets[:-1]
    na = torch.from_numpy(layout.row_nonascii_ids(col)).cuda()
    na_starts = starts[na]
    chars, nch = layout.char_matrix(col, width)
    N, L = chars.shape
    nfa = rx._get_nfa(PATTERN)
    membw, uid = nfa._pos_tables(chars, nch, True)  # as the main path builds them
    keep, k0, live, dist = _route_inputs(torch, col, width)
    k0_first = cumsum0(first)
    out_cap = col.size * width
    n, cap = col.size, col.capacity
    spans = _span_inputs(torch, chars, nch)
    # each span pattern's first-match begins and ends from position 0 (the
    # plain passes'), for the forward pass's input and the walks' bounds
    b0s, e0s = {}, {}
    for pat, sb, mw, ud, starts_ in spans:
        for label, sp in starts_:
            b0s[pat, label] = sb._back_plain(chars, nch, sp, mw, ud)
            e0s[pat, label] = sb._fwd_plain(chars, nch, b0s[pat, label], mw, ud)
    # the chars a walk must read: K2 reads each row up to its first match,
    # so at least up to the leftmost match begin, and the whole row where
    # nothing matches; the backward span pass reads [start, length), the
    # forward one [begin, end) of the match
    zero = torch.zeros_like(nch)
    row_end = torch.minimum(nch, torch.full_like(nch, L))
    k2_hits = nfa._matches_plain(chars, nch, membw, uid, False)
    k2_end = torch.where(k2_hits, b0s[PATTERN, "start 0"] + 1, row_end)
    sb0 = spans[0][1]
    back_shapes, fwd_shapes = [], []
    for pat, sb, mw, ud, starts_ in spans:
        for label, sp in starts_:
            b0 = b0s[pat, label]
            tag = f"{pat} {label} [{N},{L}]" + (" U>1" if sb.nfa.U > 1 else "")
            back_shapes.append((tag, lambda sb=sb, sp=sp, mw=mw, ud=ud: sb.back(chars, nch, sp, mw, ud),
                                lambda sb=sb, sp=sp, mw=mw, ud=ud: sb._back_plain(chars, nch, sp, mw, ud)))
            fwd_shapes.append((tag, lambda sb=sb, b0=b0, mw=mw, ud=ud: sb.fwd(chars, nch, b0, mw, ud),
                               lambda sb=sb, b0=b0, mw=mw, ud=ud: sb._fwd_plain(chars, nch, b0, mw, ud)))
    b00, e00 = b0s[SPAN_FIND, "start 0"], e0s[SPAN_FIND, "start 0"]
    cases = [
        ("scan_sum", "csrc/scan.cu", "custrings_tpu/ops/pallas_scan.py:235",
         [(f"u8[{cap}]", lambda: scan.cumsum_i32(col.data), lambda: scan._cumsum_plain(col.data)),
          (f"i32[{n}]", lambda: scan.cumsum_i32(lens), lambda: scan._cumsum_plain(lens))],
         (cap * (1 + 4), cap), lambda: torch.cumsum(col.data, 0, dtype=torch.int32)),
        ("scan_max", "csrc/scan.cu", "custrings_tpu/ops/pallas_scan.py:235",
         [(f"i32[{n}]", lambda: scan.cummax_i32(signed), lambda: scan._cummax_plain(signed)),
          (f"u8[{cap}]", lambda: scan.cummax_i32(col.data), lambda: scan._cummax_plain(col.data))],
         (n * (4 + 4), n), lambda: torch.cummax(signed, 0).values),
        ("window_bytes", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
         [(f"u8[{na.shape[0]},{width}] non-ASCII rows", lambda: window.ragged_gather(col.data, na_starts, width),
           lambda: window._gather_plain(col.data, na_starts, width)),
          (f"i32[{n},{width}] (window route)", lambda: window.ragged_gather_i32(col.data, starts, width),
           lambda: window._gather_plain(col.data, starts, width).to(torch.int32))],
         (na.shape[0] * (width + 4 + width), 0), None),
        ("window_words", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
         [(f"i32[{n},{(width - 64) // 4}] tails past 64", lambda: window.ragged_gather_words(col.data, starts + 64, width - 64),
           lambda: window._words_plain(col.data, starts + 64, width - 64)),
          (f"i32[{n},16] tails past 256", lambda: window.ragged_gather_words(col.data, starts + 256, 64),
           lambda: window._words_plain(col.data, starts + 256, 64))],
         (n * ((width - 64) + 4 + (width - 64)), 0), None),
        ("route_compact", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:290",
         [(f"u8[{cap}] width-64 view", lambda: route.compact_stream(keep, [col.data], k0)[0][0],
           lambda: route._compact_plain(keep, k0, col.data)),
          (f"i64[{n}] group representatives", lambda: route.compact_stream(first, [perm], k0_first)[0][0],
           lambda: route._compact_plain(first, k0_first, perm))],
         (cap * (1 + 4 + 1 + 1), 0), lambda: torch.masked_select(col.data, keep)),
        ("route_expand", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:448",
         [(f"u8[{cap}] -> u8[{out_cap}]", lambda: _expanded(route.expand_stream(live, dist, [col.data], out_cap)),
           lambda: route._expand_plain(live, dist, col.data, out_cap, True))],
         (cap * (1 + 4 + 1) + out_cap * 2, 0), None),
        ("nfa_bits", "csrc/nfa_bits.cu", "custrings_tpu/regex/pallas_nfa.py:418",
         [(f"{PATTERN} unanchored [{n},{width}]",
           lambda: nfa._matches_bits(chars, nch, membw, uid, False),
           lambda: nfa._matches_plain(chars, nch, membw, uid, False)),
          (f"{PATTERN} anchored [{n},{width}]",
           lambda: nfa._matches_bits(chars, nch, membw, uid, True),
           lambda: nfa._matches_plain(chars, nch, membw, uid, True))],
         _walk(torch, nfa, 4 + 1, zero, k2_end), None),
        ("span_back", "csrc/spans.cu", "custrings_tpu/regex/pallas_spans.py:251",
         back_shapes, _walk(torch, sb0.nfa, 12, zero, row_end), None),
        ("span_fwd", "csrc/spans.cu", "custrings_tpu/regex/pallas_spans.py:266",
         fwd_shapes, _walk(torch, sb0.nfa, 12, b00, torch.where(b00 >= 0, e00, -1)), None),
    ]
    out = []
    for name, source, replaces, shapes, (nbytes, nops), library in cases:
        rec = {"name": name, "route": "cuda", "source": f"custrings_tpu_torch/{source}",
               "replaces": replaces, "tolerance": "exact (torch.equal)", "shapes": [],
               "max_abs_err": 0.0}
        slow_plain = name in ("nfa_bits", "span_back", "span_fwd")
        for label, kern, plain in shapes:
            err = _compare(torch, f"{name} {label}", kern(), plain())
            ms = _time_ms(torch, kern)
            plain_ms = _time_ms(torch, plain, reps=3 if slow_plain else REPS)
            rec["shapes"].append({"shape": label, "ms": ms, "plain_ms": plain_ms})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the headline numbers are the first (main-path) shape's
        rec["ms"] = rec["shapes"][0]["ms"]
        rec["plain_ms"] = rec["shapes"][0]["plain_ms"]
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, nops)
        rec["bound_bytes"] = int(nbytes)
        rec["bound_ops"] = int(nops)
        rec["library_ms"] = _time_ms(torch, library) if library is not None else None
        _emit({"phase": "kernel", **rec})
        out.append(rec)
    return out


def _expanded(res):
    (out,), placed = res
    return out, placed


def _view_phase(torch, col, width):
    """The streaming padded view against the K1 window view at the widths
    the slice builds at 1M rows: the full width (char matrix, K4e alone)
    and the encode's 64- and 256-byte key prefixes (K4c then K4e); plus
    the 64-byte key words both ways (packed view against K1b)."""
    from custrings_tpu_torch.ops import array, layout, window

    rows = []
    for w in (width, 64, 256):
        stream = lambda w=w: layout._stream_view_any(col, w)  # noqa: E731
        win = lambda w=w: layout._window_view(col, w)  # noqa: E731
        _compare(torch, f"padded view width {w}", stream(), win())
        rows.append({"view": f"u8[{col.size},{w}]", "stream_ms": _time_ms(torch, stream),
                     "window_ms": _time_ms(torch, win)})
    lens = col.lengths()
    kw_stream = lambda: array._mask_word_tails(array._pack_words(layout._stream_view_any(col, 64)), lens)  # noqa: E731
    kw_win = lambda: array._mask_word_tails(window.ragged_gather_words(col.data, col.offsets[:-1], 64), lens)  # noqa: E731
    _compare(torch, "key words 64", kw_stream(), kw_win())
    rows.append({"view": f"key words i32[{col.size},16]", "stream_ms": _time_ms(torch, kw_stream),
                 "window_ms": _time_ms(torch, kw_win)})
    _emit({"phase": "views", "tolerance": "exact (torch.equal)", "views": rows})


def _category_oracle(strs):
    uniq = sorted({s for s in strs if s is not None}, key=lambda s: s.encode("utf-8"))
    keys = ([None] if any(s is None for s in strs) else []) + uniq
    rank = {k: i for i, k in enumerate(keys)}
    return keys, [rank[s] for s in strs]


def _stepper(torch, times):
    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    return step


def _records_to_host(recs):
    return [None if r is None else r.to_host() for r in recs]


def _run_slice(torch, strs):
    """The facade chain; returns (contains/replace/encode results, the
    size-changing rewrites' results, per-op seconds)."""
    from custrings_tpu_torch import nvcategory, nvstrings

    times = {}
    step = _stepper(torch, times)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    hits = step("contains", lambda: s.contains(PATTERN))
    r = step("replace", lambda: s.replace("the", "THE", regex=False))
    cat = step("dictionary_encode", lambda: nvcategory.from_strings(r))
    grown = step("replace_grow", lambda: s.replace("the", "THEE", regex=False))
    shrunk = step("replace_shrink", lambda: s.replace("the", "T", regex=False))
    tokens = step("split_record", lambda: s.split_record(" "))
    keys = step("keys_to_host", lambda: cat.keys().to_host())
    values = step("values_to_host", cat.values)
    replaced = step("replaced_to_host", r.to_host)
    grown_h = step("grown_to_host", grown.to_host)
    shrunk_h = step("shrunk_to_host", shrunk.to_host)
    tokens_h = step("tokens_to_host", lambda: _records_to_host(tokens))
    return (hits, replaced, keys, values, cat.keys_size()), (grown_h, shrunk_h, tokens_h), times


def _check_slice(strs, results):
    hits, replaced, keys, values, keys_size = results
    rx = re.compile(PATTERN)
    want_hits = [None if s is None else rx.search(s) is not None for s in strs]
    want_rep = [None if s is None else s.replace("the", "THE") for s in strs]
    want_keys, want_values = _category_oracle(want_rep)
    bad = {
        "contains": _mismatches(hits, want_hits),
        "replace": _mismatches(replaced, want_rep),
        "keys": int(keys != want_keys) + int(keys_size != len(want_keys)),
        "values": _mismatches(values, want_values),
    }
    return bad, len(want_keys)


def _mismatches(got, want) -> int:
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def _check_rewrites(strs, results):
    grown, shrunk, tokens = results
    return {
        "replace_grow": _mismatches(grown, [None if s is None else s.replace("the", "THEE") for s in strs]),
        "replace_shrink": _mismatches(shrunk, [None if s is None else s.replace("the", "T") for s in strs]),
        "split_record": _mismatches(tokens, [None if s is None else s.split(" ") for s in strs]),
    }


class _RoundLog:
    """Counts the rounds of each DeviceProgram.all_spans call (one span
    pass pair per round) while active, by wrapping the two methods."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from custrings_tpu_torch.regex import device, span_bits

        self._saved = (device.DeviceProgram.all_spans, span_bits.SpanBits.spans)
        all_spans, spans = self._saved
        passes = [0]

        def counted_spans(sb, *a, **k):
            passes[0] += 1
            return spans(sb, *a, **k)

        def logged_all_spans(dp, chars, *a, **k):
            p0 = passes[0]
            out = all_spans(dp, chars, *a, **k)
            self.calls.append({"rows": int(chars.shape[0]), "width": int(chars.shape[1]),
                               "counts_only": bool(k.get("counts_only", False)),
                               "rounds": passes[0] - p0})
            return out

        device.DeviceProgram.all_spans = logged_all_spans
        span_bits.SpanBits.spans = counted_spans
        return self

    def __exit__(self, *exc):
        from custrings_tpu_torch.regex import device, span_bits

        device.DeviceProgram.all_spans, span_bits.SpanBits.spans = self._saved


def _run_spans(torch, strs):
    """The span ops through the facade; returns (results, per-op seconds,
    {op: [all_spans calls]})."""
    from custrings_tpu_torch import nvstrings

    times, rounds = {}, {}
    step = _stepper(torch, times)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    ops = [("count", lambda: s.count(SPAN_COUNT)),
           ("findall_record", lambda: s.findall_record(SPAN_FIND)),
           ("replace_re", lambda: s.replace(SPAN_REPLACE, "EMAIL", regex=True))]
    out = {}
    for name, fn in ops:
        with _RoundLog() as log:
            out[name] = step(name, fn)
        rounds[name] = log.calls
    found = step("findall_to_host", lambda: _records_to_host(out["findall_record"]))
    replaced = step("replace_re_to_host", out["replace_re"].to_host)
    return (out["count"], found, replaced), times, rounds


def _check_spans(strs, results):
    counts, found, replaced = results
    rc, rf, rr = re.compile(SPAN_COUNT), re.compile(SPAN_FIND), re.compile(SPAN_REPLACE)
    return {
        "count": _mismatches(counts, [0 if s is None else sum(1 for _ in rc.finditer(s)) for s in strs]),
        "findall_record": _mismatches(
            found, [None if s is None else [m.group(0) for m in rf.finditer(s)] for s in strs]
        ),
        "replace_re": _mismatches(replaced, [None if s is None else rr.sub("EMAIL", s) for s in strs]),
    }


def _driven(torch, kernels, run, strs):
    """Run one path with every launch counter set to 0 just before it and
    read just after; returns (run's result, the counters)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = run(torch, strs)
    torch.cuda.synchronize()
    return res, dict(kernels.LAUNCHES)


#: the kernels each path must launch at 1M rows
SLICE_KERNELS = ("scan_sum", "scan_max", "window_bytes", "window_words", "nfa_bits",
                 "route_compact", "route_expand")
SPAN_KERNELS = ("span_back", "span_fwd")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from custrings_tpu_torch import column, kernels
    from custrings_tpu_torch.ops import layout

    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    _emit({"phase": "device", "torch_device": kind, "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    path = kernels.build(force=True)
    kernels.lib()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": path})

    t0 = time.perf_counter()
    strs = make_corpus(ROWS, seed=0)
    corpus_s = time.perf_counter() - t0
    nbytes = sum(len(s.encode()) for s in strs if s is not None)
    col = column.from_host_strings(strs, "cuda")
    width = layout.max_row_bytes(col)
    _emit({"phase": "corpus", "rows": ROWS, "bytes": nbytes, "capacity": col.capacity,
           "width": width, "seconds": corpus_s})

    recs = _kernel_phase(torch, col, width)
    _view_phase(torch, col, width)
    del col
    torch.cuda.empty_cache()

    # first-use set-up (tables, regex compiles), then each path once
    _run_slice(torch, strs[:4096])
    _run_spans(torch, strs[:4096])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (results, rewrites, times), slice_launches = _driven(torch, kernels, _run_slice, strs)
    peak = torch.cuda.max_memory_allocated()
    bad, nkeys = _check_slice(strs, results)
    bad.update(_check_rewrites(strs, rewrites))
    op_s = sum(v for k, v in times.items() if k in ("contains", "replace", "dictionary_encode"))
    _emit({"phase": "slice", "rows": ROWS, "ms": {k: v * 1e3 for k, v in times.items()},
           "rows_per_s_contains_replace_encode": ROWS / op_s,
           "max_memory_allocated": peak, "keys": nkeys, "mismatches": bad})
    if any(bad.values()):
        raise AssertionError(f"slice output disagrees with the Python oracles: {bad}")

    torch.cuda.reset_peak_memory_stats()
    (sresults, stimes, rounds), span_launches = _driven(torch, kernels, _run_spans, strs)
    speak = torch.cuda.max_memory_allocated()
    sbad = _check_spans(strs, sresults)
    _emit({"phase": "spans", "rows": ROWS, "ms": {k: v * 1e3 for k, v in stimes.items()},
           "all_spans_calls": rounds, "matches": {"count": sum(sresults[0]),
           "findall_record": sum(len(r) for r in sresults[1] if r is not None)},
           "max_memory_allocated": speak, "mismatches": sbad})
    if any(sbad.values()):
        raise AssertionError(f"span ops disagree with Python re: {sbad}")

    _emit({"phase": "launches", "slice": slice_launches, "spans": span_launches})
    missing = [k for k in SLICE_KERNELS if slice_launches[k] <= 0]
    missing += [k for k in SPAN_KERNELS if span_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels their path never launched: {missing}")

    for r in recs:
        r["launches"] = slice_launches[r["name"]] + span_launches[r["name"]]
    _emit({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in recs
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
