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
               call's time; K3 at every form and edge the main path gives
               it (cumsum0, row ids, int8, lengths 1, 4097 and 8193,
               unaligned views, a wrapping sum), each with its own bound;
               K1 (window_bytes) at the char matrix, the padded view, the
               non-ASCII rows' decode, unmasked int32 and uint8 (with one
               index_select out of an unfolded padded buffer as its
               library time) and its edges (window_edge_cases: widths 1,
               15, 16, 17, 31 and 513, unsorted and repeated starts at
               every residue mod 16, data[1:] views, caps of 16k+1..16k+15,
               negative starts, both output types, masked and unmasked);
               every K1 shape and K4c's i64 calls also timed back to back
               (20 calls between one pair of events, with the host's time
               a call to issue them);
               K4c (route_compact) at the width-64 view's u8[capacity]
               and the group representatives' i64[1M] calls, each with k0
               written (as the path makes them), not wanted and given,
               every plane and k0 held to _compact_plain, with
               torch.masked_select's time, and at its edges
               (compact_edge_cases: one sub-tile and one tile - 1, + 0,
               + 1 elements, densities 0, 1e-4, 0.5 and 1, each element
               size and eight mixed planes, unaligned views, n of 0 and
               1, a few calls at the capacity); then the host's time a
               call of the i64 call's wrapper, by part (compact_stream
               host);
               K1b (window_words) at the encode's own calls (each bound
               counting the union of its windows), a 7-word tail, starts
               at every residue mod 16, a data[1:] view and caps of
               4k+1..4k+3; K4e (route_expand) at the grow
               replace's and the split's own calls, the padded grid, a
               mixed u8 + i32 + i64 call, garbage dist on dead lanes,
               targets at out_cap - 1, out_cap and past, an all-dead
               live and out_cap below n
     launch checks — torch.profiler: each expand_stream call runs one
               expand_firsts, one expand_kernel and one fill of one word
               (its ticket) and no other fill; each of the encode's
               ragged_gather_words calls one window_words; each hash_mm3
               call one hash_rows; each compact_bytes call one
               compact_tiles and one fill of its scratch status words,
               no K3 and no fill of an output; each compact_stream call
               (u8 at the capacity without k0, u8 + i32 with k0 written,
               eight planes with k0 given) one compact_stream_tiles, one
               memset of its status words (none with k0 given), no other
               fill and no K3;
               one profiler session,
               redone in a fresh process (`chip_smoke.py --launch-checks`,
               at most twice) when it came back with fewer device
               records than the calls launched
     scan    — 100 back-to-back K3 calls exact against their plain
               versions (no scratch state leaks between calls), and
               torch.profiler showing one scan kernel per cumsum0 call
     views   — the two padded-view routes at the slice's widths: the
               K1 window gather masked at the lengths (the route every
               size takes) against the streaming view (K4c/K4e, the
               JAX package's TPU route), compared exactly, timed; and the
               views' entry points, which must launch no K4c, no K4e and
               no capacity-sized K3
  3. slice   — to_device -> contains(r"#\w+") -> replace("the", "THE")
               -> nvcategory.from_strings -> keys/values, then the growing
               and shrinking replace("the", "THEE" / "T") and
               split_record(" "), -> to_host, on 1M rows of make_corpus(),
               checked against Python oracles
  4. spans   — count("the|that"), findall_record(r"#\w+") and
               replace(r"(\w+)@(\w+)", "EMAIL") on the same rows, checked
               against Python `re`; each all_spans call must launch
               span_all exactly once
     logs    — make_logs(2^20) and make_long_logs(2,048) rows, and the
               Python `re` oracles of the matchers phase
     kernels — K2b (nfa_words) on the log rows for ERR, ISO and MONTH
               (and ERR without its \b, one closure variant, beside it),
               K6 (hash_mm3) over the tweet rows (the headline), the long
               log rows, rows of 0-9 bytes, a 10,003-byte row, a last row
               ending at a cap of 16k+7 and a data view; K7
               (compact_bytes, the whole entry point) over the tweet
               capacity at two masks, out_cap = capacity, below the kept
               count and 0, all and none kept, a uint8 keep, caps of
               4k+1..4k+3, below a tile and below 16, and data[1:] views;
               each against its plain version, exactly; then 100
               back-to-back K7 calls, exact
     compact — compact_bytes(data, data != " ", capacity) once, against
               torch.masked_select
  5. matchers — contains and match through the facade: ERR, ISO, MONTH on
               the 2^20 log rows (K2b), BIG on their first 65,536 (the
               vector engine), ERR, ISO, MONTH on the 2,048 long rows (the
               chunked engine), every row against Python `re`, every
               call held to the engine its set is there to drive, and
               every K2/K2b-routed call (here and the slice's contains)
               held to one engine call that launched its kernel once
  6. hash    — nvstrings.hash on the tweet rows against a numpy
               MurmurHash3_32 (seed 31), itself held to the reference vector
  7. text    — the same rows with a seeded ~10% rewritten with mixed
               whitespace (\t \n \x0b \x1f \x00 runs, leading and trailing,
               \xa0 and \u3000 inside tokens) and ~0.5% whitespace only,
               through the facades: split_record(None), split_record(None,
               2), rsplit_record(None, 2), rsplit_record(" ", 1),
               partition(" "), rpartition("#"), and nvtext's tokenize,
               token_count, unique_tokens, tokens_counts / contains_strings
               / strings_counts against 20 corpus words, normalize_spaces,
               replace_tokens (3 targets), ngrams(2) of the first 2^17
               rows' tokens, edit_distance to "the conference" and
               pairwise against replace("the", "THE"), and the Porter
               measure of the vocabulary; every row against Python
               oracles (whitespace is code points <= 0x20, not
               str.isspace), 4,096 seeded rows (vocabulary words) for the
               distances (a numpy DP) and the Porter measure
     kernel_text — K1, K1b and K4c at the text path's own calls on these
               rows (captured): the edit distances' char matrix windows,
               unique_tokens' encode and the token key words of
               tokens_counts and replace_tokens, the whitespace split's
               compaction (as the path makes it, without k0, and with k0
               given; with torch.masked_select's time); each against its
               plain version, exactly, with its own bound
  8. clean   — make_corpus's rows and 4,096 seeded edge rows (ß, ŉ, ΐ,
               Σ/ς, 4-byte UTF-8, NUL, whitespace runs, signs, İ/ẞ, empty,
               null) through the facade's cleanup chain: strip(), then
               lower/upper/title/capitalize/swapcase of it, translate
               (with a deletion and a widening), slice(2, 40, 3), get(0),
               zfill(12), pad(40, "both", "*"), wrap(40), startswith,
               endswith, find_from with per-row starts, compare("m"),
               match_strings, find_multiple, len, the nine is*, cat with
               itself (sep "|", na_rep "-"), fillna, insert,
               slice_replace, order and sort (stype 1, 2, 3, ascending
               nulls first and descending nulls last), scatter,
               scalar_scatter, remove_strings, add_strings; every row
               against a Python oracle written to the JAX package's
               semantics (its BMP 1:1 case table, islower/isupper true
               without letters, strip's " \n\t", title's word start)
     kernel_clean — K4e, K1b and K1 at the clean path's own calls
               (captured): lower()'s charwise byte expansion, order()'s
               key words, compare()'s view; each against its plain
               version, exactly, with its own bound
  9. convert — a seeded table of 2^20 rows (make_convert_rows: ints,
               floats, hex, IPv4, two timestamp formats, booleans and the
               tweets with 4,096 % edge rows, ~1% null and ~1% empty
               each) written to a CSV file in a temporary directory and
               read back column by column with nvstrings.from_csv (the hex
               column with CSV_SORT_NAME); stoi, stol, htoi, stof, stod,
               ip2int, to_booleans, timestamp2int (two formats and
               units); itos, ltos, ftos, dtos, int2ip, from_booleans and
               int2timestamp of their results; url_encode of the url
               column, url_decode of its output and of the url column;
               get_info of the int column; every row against Python
               (int(), ipaddress, calendar and datetime, urllib.parse.quote,
               the round trip) or oracles written to the JAX package's
               semantics (the hex state machine, stod's formula in numpy,
               within 2 ulp, _float_to_string, the byte-level url decode)
     kernel_convert — K4e, K7 and K1 at the convert path's own calls
               (captured): url_encode's byte expansion, url_decode's
               compaction (with torch.masked_select's time), stod's view;
               each against its plain version, exactly, with its own bound
 10. category — a categorical column of 2^20 Zipf draws over ~50,000
               keys of corpus tokens (make_category_rows: ~5% non-ASCII,
               64 long keys sharing 64- and 256-byte prefixes, ~1% null
               and empty) and a second of 2^18 rows sharing half its keys,
               and 2^20-value columns of int8, int32, int64, float32 and
               float64 (make_numeric_columns: NaN, -NaN, +-0.0, +-inf,
               the extremes, ~1% bitmask nulls), through every method of
               nvcategory and numeric_category (lookups of 100 present
               and absent keys, gathers, row adds and removes, the keyset
               algebra, both merges, lookups on the unsorted keyset of a
               second merge_category); every row against oracles written
               to the JAX package's semantics (_CatOracle, _NumOracle;
               numeric keys bitwise)
     kernel_category — K1b at searchsorted_keys' own key words (as
               remove_strings calls it) and K3 at from_numbers' rank
               scan (captured); each against its plain version, exactly,
               with its own bound
 11. regex   — the tweet rows through the facade's regex methods on the
               span engines with capture groups: extract((\w+)@(\w+)),
               replace_with_backrefs of it with "\2 at \1" and with a \0
               template, replace_multi of URLs, mentions and hashtags,
               count and findall_record of URLs; replace of IPv4
               addresses in the first 2^18 log rows; extract_record of the
               addresses on the first 2^16 rows and an eight-word extract
               (40 instructions, the min-plus engine) on them; the count
               of #\w{1,70}\b (142 instructions, the per-row DFS) on the
               first 4,096; every row against Python re (the reference's
               \b written as a change of IS_ALPHANUM)
     kernel_regex — K4e, K4c and K5 at the regex path's own calls
               (captured): replace_with_backrefs' gap expansion and
               stream_expand_spans' expansion, the gap compaction (k0
               written, as the path makes it, and k0 given), extract's
               first-match call; each against its plain version,
               exactly, with its own bound
     tracing — the slice's three ops with utils.tracing enabled: a
               span record each with calls >= 1 and host seconds > 0,
               results identical to the untraced run
 12. parallel — custrings_tpu_torch.parallel on a world of one over NCCL
               (parallel.runtime.init_runtime with a FileStore in this
               process): shard_global of the 1M tweet rows, then
               replace("the", "THEIR!") (growing) and to_column,
               contains_re(r"#\w+") with its job total, categorize() and
               unique_tokens(); shard_global and categorize() of the 1M
               category rows; every row against str.replace, re, the
               sorted keyset (_category_oracle) and ws_split
               (token_oracle), and the values and token ids against the
               single-device nvcategory.from_strings and encode of
               tokenize on the same card, each op's ms beside the
               single-device op's, the phase's peak memory
     parallel_gloo — a world of two over gloo, both ranks on the card in
               processes of their own (`chip_smoke.py --parallel-rank`),
               each first checking that gloo moves CUDA tensors for
               all_gather, all_to_all_single at uneven splits and
               all_reduce; the same ops on 2^16 rows of each corpus and
               on 2^16 sorted k%06d keys (each rank's keys one owner's
               range), the ranks' results joined and held to the oracles
 13. launches — each path's kernel counters (reset just before the path,
               read just after) are above zero for the kernels it runs
               (the parallel path's: the world of one's);
               K3 sum's launches are also split by input size
Then the kernels JSON line, the nvidia-smi line, and the final
{"ok": true, "device": {...}} line.  Any failure exits nonzero.

make_corpus() builds the tweet-like corpus, make_logs() the log lines,
make_text_rows() the text phase's rows, make_convert_rows() the convert
phase's table and make_category_rows() / make_numeric_columns() the
category phase's columns from a seed with numpy; the CPU tests import
them at a small size.
"""

from __future__ import annotations

import calendar
import collections
import datetime
import inspect
import ipaddress
import json
import math
import os
import re
import statistics
import string
import subprocess
import sys
import tempfile
import time
import urllib.parse

import numpy as np

ROWS = 1 << 20
PATTERN = r"#\w+"
SPAN_COUNT = "the|that"
SPAN_FIND = r"#\w+"
SPAN_REPLACE = r"(\w+)@(\w+)"
#: the log filters of the matchers phase: K2b takes the first three
#: (51 instructions with two closure variants, 45, 92); BIG (291
#: instructions) goes to the vector engine
ERR = r"\b(error|warning|critical|fatal|exception|timeout)\b"
ISO = r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d{1,6})?(Z|[+\-]\d{2}:\d{2})"
MONTH = (r"(january|february|march|april|may|june|july|august|september|october|november"
         r"|december) \d{1,2}")
BIG = (r"\b(january|february|march|april|may|june|july|august|september|october|november"
       r"|december|monday|tuesday|wednesday|thursday|friday|saturday|sunday|connection refused"
       r"|out of memory|permission denied|disk full|segmentation fault|stack overflow"
       r"|null pointer|broken pipe|timed out|access denied)\b")
K2B_PATTERNS = (ERR, ISO, MONTH)
#: ERR without its word boundaries: one closure variant, timed beside ERR
ERR_NB = ERR.replace(r"\b", "")
LOG_ROWS = 1 << 20
BIG_ROWS = 1 << 16
LONG_ROWS = 2048
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


_LEVELS = ["INFO", "DEBUG", "WARN", "ERROR", "FATAL"]
_LEVEL_P = [0.55, 0.2, 0.13, 0.09, 0.03]
_HOSTS = ["web-01", "web-02", "api-7", "db-1.internal", "cache-3", "worker-12",
          "10.0.3.17:8080", "192.168.1.20:443", "172.16.0.5:5432", "edge"]
_LOG_WORDS = (
    "request served user login connect started finished retry queue job id path upstream "
    "payload bytes ms status ok sent received cache hit miss pool worker task scheduled "
    "shutdown config reload GET POST /api/v1/items /health 200 404 503 took latency "
    "handler client server node shard replica commit flush compaction checkpoint"
).split()
#: the alert words and phrases of ERR and BIG, and near misses of them
_ALERTS = ["error", "warning", "critical", "fatal", "exception", "timeout", "Error", "errors",
           "timeouts", "connection refused", "out of memory", "permission denied", "disk full",
           "segmentation fault", "stack overflow", "null pointer", "broken pipe", "timed out",
           "access denied", "error:", "(timeout)"]
_DATES = ["january 5", "march 17", "december 31", "may 1", "october 09", "june", "monday",
          "friday", "sunday", "august 2024", "november 3rd"]
_LOG_NONASCII = ["café", "über", "naïve", "日本語", "🎉", "Straße", "ошибка", "тайм-аут"]


def _stamps(rng, n: int):
    """n ISO-8601 timestamps: 0..6 fraction digits, a zone Z, +02:00 or
    -05:30, or (a quarter of them) none, which leaves them malformed."""
    parts = [rng.integers(lo, hi, n).tolist() for lo, hi in
             ((2000, 2030), (1, 13), (1, 29), (0, 24), (0, 60), (0, 60), (0, 8), (0, 10**6), (0, 4))]
    zones = ("Z", "+02:00", "-05:30", "")
    return [
        f"{y:04d}-{mo:02d}-{d:02d}T{h:02d}:{mi:02d}:{s:02d}"
        + (f".{us:06d}"[: k + 1] if 1 <= k <= 6 else "") + zones[z]
        for y, mo, d, h, mi, s, k, us, z in zip(*parts)
    ]


def make_logs(n: int, seed: int = 0):
    """Log lines of 60..300 UTF-8 bytes: an ISO-8601 timestamp (~85%, some
    without a zone; ~10% syslog-style), a host, a level among
    INFO/DEBUG/WARN/ERROR/FATAL and a message that sometimes holds the
    alert words and phrases of ERR/BIG or a date of MONTH; ~5% are
    continuation lines (the message alone); ~2% non-ASCII, ~1% None, ~1%
    empty.  The messages are slices of one seeded word stream."""
    rng = np.random.default_rng(seed)
    words = [_LOG_WORDS[i] for i in rng.integers(0, len(_LOG_WORDS), 1 << 16).tolist()]
    stream = " ".join(words)
    wstart = np.concatenate([[0], np.cumsum([len(w) + 1 for w in words])]).tolist()
    target = rng.integers(60, 301, n).tolist()
    kind = rng.random(n).tolist()
    level = rng.choice(len(_LEVELS), size=n, p=_LEVEL_P).tolist()
    host = rng.integers(0, len(_HOSTS), n).tolist()
    first = rng.integers(0, (1 << 16) - 80, n).tolist()
    extras = []  # (word stream) insertions: alert words, dates, non-ASCII words
    for table, p in ((_ALERTS, 0.3), (_DATES, 0.1), (_LOG_NONASCII, 0.02)):
        hit = (rng.random(n) < p).tolist()
        pick = rng.integers(0, len(table), n).tolist()
        at = rng.integers(0, 8, n).tolist()
        extras.append([(table[k], a) if h else None for h, k, a in zip(hit, pick, at)])
    stamps = _stamps(rng, n)
    syslog = [f"Mar {d:2d} {h:02d}:{m:02d}:00" for d, h, m in
              zip(rng.integers(1, 29, n).tolist(), rng.integers(0, 24, n).tolist(),
                  rng.integers(0, 60, n).tolist())]
    out = []
    for i in range(n):
        k = kind[i]
        if k < 0.02:
            out.append(None if k < 0.01 else "")
            continue
        w0 = first[i]
        msg = stream[wstart[w0]: wstart[w0 + 60]]
        for ex in extras:
            if ex[i] is not None:
                text, a = ex[i]
                off = wstart[w0 + a] - wstart[w0]
                msg = msg[:off] + text + " " + msg[off:]
        if k < 0.87:
            msg = f"{stamps[i]} {_HOSTS[host[i]]} {_LEVELS[level[i]]} {msg}"
        elif k < 0.97:
            msg = f"{syslog[i]} {_HOSTS[host[i]]} {_LEVELS[level[i]]} {msg}"
        out.append(_cut(msg, target[i]))
    return out


_TRACE = ('Traceback (most recent call last):\n  File "app/handler.py", line 42, in serve\n'
          '    result = upstream.call(payload)\n  File "app/client.py", line 7, in call\n'
          '    raise TimeoutError("upstream timed out")\nTimeoutError: upstream timed out\n')


def make_long_logs(n: int, seed: int = 0):
    """Rows of 2,048..8,192 UTF-8 bytes: log lines of make_logs joined by
    newlines (half of the rows), quiet lines only (no alert word, no ISO
    timestamp; 30%), or a stack trace among quiet lines (20%)."""
    rng = np.random.default_rng(seed)
    pool = [s for s in make_logs(4096, seed + 1) if s]
    quiet = [s[s.index(" ") + 1:] for s in pool
             if not re.search(ERR, s) and not re.search(ISO, s) and " " in s]
    out = []
    for i, (target, k) in enumerate(zip(rng.integers(2048, 8193, n), rng.random(n))):
        src = pool if k < 0.5 else quiet
        lines = [_TRACE] if k >= 0.8 else []
        size = sum(len(s.encode()) + 1 for s in lines)
        while size < target:
            s = src[rng.integers(0, len(src))]
            lines.insert(rng.integers(0, len(lines) + 1), s)
            size += len(s.encode()) + 1
        out.append(_cut("\n".join(lines), int(target)))
    return out


def murmur3_np(strs):
    """MurmurHash3_32 (seed 31) of each str's UTF-8 bytes, numpy over a
    zero-padded [n, w] view (None for None); the oracle of the hash phase."""
    raw = [b"" if s is None else s.encode("utf-8") for s in strs]
    n = len(raw)
    lens = np.fromiter((len(b) for b in raw), np.int64, n)
    w4 = max(-(-int(lens.max(initial=0)) // 4) * 4, 4)
    buf = np.zeros((n, w4), np.uint8)
    flat = np.frombuffer(b"".join(raw), np.uint8)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
    buf[rows, cols] = flat
    blocks = buf.view("<u4").astype(np.uint32)
    u32 = np.uint32

    def rotl(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    def mix(k):
        return rotl(k * u32(0xCC9E2D51), 15) * u32(0x1B873593)

    h = np.full(n, 31, np.uint32)
    nb = lens // 4
    with np.errstate(over="ignore"):
        for i in range(w4 // 4):
            hn = rotl(h ^ mix(blocks[:, i]), 13) * u32(5) + u32(0xE6546B64)
            h = np.where(i < nb, hn, h)
        tail = np.zeros(n, np.uint32)
        rem = lens & 3
        for t in (2, 1, 0):
            byte = buf[np.arange(n), np.minimum(nb * 4 + t, w4 - 1)].astype(np.uint32)
            tail = np.where(rem > t, tail ^ (byte << u32(8 * t)), tail)
        h = np.where(rem > 0, h ^ mix(tail), h)
        h = h ^ lens.astype(np.uint32)
        h ^= h >> u32(16)
        h = h * u32(0x85EBCA6B)
        h ^= h >> u32(13)
        h = h * u32(0xC2B2AE35)
        h ^= h >> u32(16)
    return [None if s is None else int(v) for s, v in zip(strs, h)]


#: the reference's MurmurHash3 vector (python/tests/test_convert.py::test_hash)
HASH_VECTOR = (
    ["1234", "5678", "90", None, "-876", "543.2", "-0.12", ".55", "-.002", "", "de", "abc123",
     "123abc", "456e", "-1.78e+5"],
    [1762063109, 3008518326, 3419725934, None, 1225421472, 2952354928, 2093756495, 1292375090,
     2098378342, 1257683291, 3758453927, 213530502, 2957649541, 4248160425, 2735531987],
)


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


#: calls between one pair of events in a back-to-back time
BACK_TO_BACK_CALLS = 20
#: kernels whose every shape also gets a back-to-back time
BACK_TO_BACK = ("window_bytes",)


def _back_to_back_ms(torch, fn):
    """(ms, host ms) a call of BACK_TO_BACK_CALLS calls issued back to
    back between one pair of CUDA events, after one warm-up: the card runs
    one kernel after another while the host issues the next, so the
    host's time a call (the second number, host clock around the issuing)
    sets the pace only where it exceeds the kernel's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(BACK_TO_BACK_CALLS):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / BACK_TO_BACK_CALLS
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / BACK_TO_BACK_CALLS, host


def _timed(torch, fn):
    """(fn's result, ms) of one call timed with CUDA events: for the plain
    walks that take seconds a call, whose one run is also the comparison's."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


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


#: the span patterns of the span_all kernel case, the headline one first
SPAN_KERNEL_PATTERNS = (SPAN_COUNT, SPAN_FIND, SPAN_REPLACE, r"\bthe\b")


def _span_shapes(torch, chars, nch, valid):
    """span_all's shapes: each pattern of SPAN_KERNEL_PATTERNS over the
    whole char matrix as count_re calls it (counts only, Rcap = L + 2) and
    as the findall and replace ops do (full planes, Rcap = the rows' most
    matches); [(label, sb, Rcap, counts_only)]."""
    from custrings_tpu_torch.regex import ops as rx

    L = chars.shape[1]
    out = []
    for pat in SPAN_KERNEL_PATTERNS:
        sb = rx.get_program(pat)._span_bits()
        counts = sb._all_plain(chars, nch, valid, L + 2, torch.zeros_like(nch), True)[0]
        most = max(int(counts.max()), 1)
        u = " U>1" if sb.nfa.U > 1 else ""
        out.append((f"{pat} counts only [{chars.shape[0]},{L}]{u}", sb, L + 2, True))
        out.append((f"{pat} full planes Rcap {most} [{chars.shape[0]},{L}]{u}", sb, most, False))
    return out


def _span_all_bound(torch, nch, valid, L, W, B, E):
    """(bytes, ops) of all_spans(chars, lengths, validity): the chars of
    [0, min(len, L)) of each valid row read once, lengths and validity
    read, counts and the two [N, W] planes written; per position of the
    backward walk (min(len, L) + 1 a valid row) and of the forward walks
    (b..e of each match in B, E) at least 10 ops: the char's address and
    test, its predicate and closure lookups and their ORs, the begin bit
    (the set-bit walks add ~4 ops per state bit, which the data decides)."""
    n = nch.shape[0]
    row = torch.minimum(nch, torch.full_like(nch, L)).to(torch.int64)
    back = int((row + 1)[valid].sum())
    fwd = int(torch.where(B >= 0, E.to(torch.int64) - B + 1, 0).sum())
    return 4 * int(row[valid].sum()) + n * (4 + 1 + 4) + 8 * n * W, (back + fwd) * 10


def _walk(torch, per_row: int, first, end):
    """(bytes, ops) of K2's walk over positions first..end-1 of each row
    (none where end <= first): the chars (4 bytes a position; the
    predicates and closure variants are computed from them) plus per_row
    bytes a row, and per position at least 10 ops: the char's address and
    test, the injection, the closure and predicate lookups and their ORs,
    the end test (the set-bit walks add ~4 ops per state bit, which the
    data decides)."""
    npos = (end.to(torch.int64) - first.to(torch.int64)).clamp(min=0).sum().item()
    return npos * 4 + per_row * first.shape[0], npos * 10


def _kernel_phase(torch, col, width):
    """Each kernel against its plain version at the main paths' shapes; the
    first shape of each is the one its headline time, bound and library
    time are taken at."""
    from custrings_tpu_torch.column import cumsum0
    from custrings_tpu_torch.ops import layout, window
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
    keep, k0, live, dist = _route_inputs(torch, col, width)
    k0_first = cumsum0(first)
    out_cap = col.size * width
    n, cap = col.size, col.capacity
    zero = torch.zeros_like(nch)
    valid = col.validity
    spans = _span_shapes(torch, chars, nch, valid)
    span_cases = [(label, lambda sb=sb, R=R, co=co: sb.all(chars, nch, valid, R, counts_only=co),
                   lambda sb=sb, R=R, co=co: sb._all_plain(chars, nch, valid, R, zero, co))
                  for label, sb, R, co in spans]
    # the headline shape's bound counts the matches of its full-plane twin
    sb_h, R_h = spans[1][1], spans[1][2]
    _, B_h, E_h = sb_h._all_plain(chars, nch, valid, R_h, zero, False)
    span_bound = _span_all_bound(torch, nch, valid, L, 1, B_h, E_h)
    del B_h, E_h
    # the chars K2 must read: each row up to its first match, so at least
    # up to the leftmost match begin, and the whole row where nothing
    # matches
    row_end = torch.minimum(nch, torch.full_like(nch, L))
    k2_hits = nfa._matches_plain(chars, nch, False)
    first_b = spans[2][1]._all_plain(chars, nch, torch.ones_like(valid), 1, zero, False)[1][:, 0]
    k2_end = torch.where(k2_hits, first_b + 1, row_end)
    sum_shapes, max_shapes = _scan_shapes(torch, col, lens, signed)
    words = _word_shapes(torch, col)
    expansions = _expand_shapes(torch, col, width, live, dist)
    # the bytes K1 must read with the length mask: each row's first
    # min(length, width) bytes, its start and its length
    inside = int(lens.clamp(max=width).sum())
    na_inside = int(lens[na].clamp(max=width).sum())
    # K1's yardstick: one index_select of the unmasked u8 windows out of
    # a padded buffer's unfolded view (made outside the timed call)
    unfolded = torch.nn.functional.pad(col.data, (0, width)).unfold(0, width, 1)
    # K4c: the width-64 view's and the group representatives' calls as
    # the path makes them (k0 written), without k0 and with k0 given,
    # then its edges
    compacts = [*_compact_stream_cases(torch, "width-64 view", keep, [col.data], k0,
                                       ("path", "not wanted", "given")),
                *_compact_stream_cases(torch, "group representatives", first, [perm], k0_first,
                                       ("path", "not wanted", "given"), b2b=True),
                *_compact_edge_shapes(torch, cap)]
    cases = [
        ("scan_sum", "csrc/scan.cu", "custrings_tpu/ops/pallas_scan.py:235", sum_shapes,
         (cap * (1 + 4), cap), lambda: torch.cumsum(col.data, 0, dtype=torch.int32)),
        ("scan_max", "csrc/scan.cu", "custrings_tpu/ops/pallas_scan.py:235", max_shapes,
         (n * (4 + 4), n), lambda: torch.cummax(signed, 0).values),
        ("window_bytes", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
         [(f"i32[{n},{width}] masked at the lengths (char matrix)",
           lambda: window.ragged_gather_i32(col.data, starts, width, lens),
           lambda: window._gather_plain(col.data, starts, width, lens).to(torch.int32)),
          (f"u8[{n},{width}] masked at the lengths (padded view)",
           lambda: window.ragged_gather(col.data, starts, width, lens),
           lambda: window._gather_plain(col.data, starts, width, lens),
           {"bound": (inside + 8 * n + n * width, 0)}),
          (f"u8[{na.shape[0]},{width}] non-ASCII rows masked (decode)",
           lambda: window.ragged_gather(col.data, na_starts, width, lens[na]),
           lambda: window._gather_plain(col.data, na_starts, width, lens[na]),
           {"bound": (na_inside + 8 * na.shape[0] + na.shape[0] * width, 0)}),
          (f"i32[{n},{width}] unmasked", lambda: window.ragged_gather_i32(col.data, starts, width),
           lambda: window._gather_plain(col.data, starts, width).to(torch.int32)),
          (f"u8[{n},{width}] unmasked", lambda: window.ragged_gather(col.data, starts, width),
           lambda: window._gather_plain(col.data, starts, width),
           {"bound": _words_bound(torch, col.data, starts, width),
            "library": lambda: unfolded.index_select(0, starts)}),
          *_window_edge_shapes(torch)],
         (inside + 8 * n + 4 * n * width, 0), None),
        ("window_words", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
         words, words[0][3]["bound"], None),
        ("route_compact", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:290",
         compacts, compacts[0][3]["bound"], compacts[0][3]["library"]),
        ("route_expand", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:448",
         expansions, expansions[0][3]["bound"], None),
        ("nfa_bits", "csrc/nfa_bits.cu", "custrings_tpu/regex/pallas_nfa.py:418",
         [(f"{PATTERN} unanchored [{n},{width}]",
           lambda: nfa._matches_bits(chars, nch, False),
           lambda: nfa._matches_plain(chars, nch, False)),
          (f"{PATTERN} anchored [{n},{width}]",
           lambda: nfa._matches_bits(chars, nch, True),
           lambda: nfa._matches_plain(chars, nch, True))],
         _walk(torch, 4 + 1, zero, k2_end), None),
        ("span_all", "csrc/spans.cu",
         "custrings_tpu/regex/pallas_spans.py:251 and :266 (SpanBits.single, looped by "
         "custrings_tpu/regex/device.py:1171 all_spans)",
         span_cases, span_bound, None),
    ]
    recs = _measure(torch, cases, slow=("nfa_bits",), one_plain=("span_all",))
    _emit({"phase": "compact_stream host", **_compact_host_breakdown(torch, first, perm)})
    return recs


def _words_bound(torch, data, starts, width: int):
    """(bytes, ops) of ragged_gather_words(data, starts, width): the union
    of the windows read once (neighbouring windows overlap where a window
    runs past its row), clipped to the buffer, the output written and a
    start read a row.  With the windows sorted by start (all of one
    width), each adds the bytes from its start to the next one's or to its
    own end, whichever comes first."""
    rows, wb = starts.shape[0], 4 * -(-width // 4)
    if rows == 0:
        return 0, 0
    cap = data.shape[0]
    st = torch.sort(starts.to(torch.int64)).values
    lo, hi = st.clamp(0, cap), (st + wb).clamp(0, cap)
    upto = torch.minimum(hi, torch.cat([lo[1:], hi[-1:]]))
    read = int((upto - lo).clamp(min=0).sum())
    return read + rows * (wb + 4), 0


class _Calls:
    """Records the arguments of each call of the given (module, name)
    functions while active, by wrapping each name where its callers look
    it up: `calls` holds (module.name, args) in call order, keyword
    arguments bound into their positions."""

    def __init__(self, *sites):
        self.sites = sites

    def __enter__(self):
        self.calls, self._saved = [], [getattr(m, a) for m, a in self.sites]
        for (m, a), fn in zip(self.sites, self._saved):
            def recorded(*args, _fn=fn, _site=f"{m.__name__.rsplit('.', 1)[-1]}.{a}", **kw):
                self.calls.append((_site, inspect.signature(_fn).bind(*args, **kw).args if kw else args))
                return _fn(*args, **kw)

            setattr(m, a, recorded)
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self.sites, self._saved):
            setattr(m, a, fn)


def _captured_word_gathers(col):
    """K1b's inputs as the main path passes them: the ragged_gather_words
    calls of unique.dictionary_encode(col), recorded where ops/array.py
    (the key words, from the row starts) and ops/unique.py (the tails past
    the key prefix, from the sorted rows' starts and from the group
    representatives') look the name up; [(label, data, starts, width)]
    in call order."""
    from custrings_tpu_torch.ops import array, unique

    with _Calls((array, "ragged_gather_words"), (unique, "ragged_gather_words")) as log:
        unique.dictionary_encode(col)
    seen, prefix, tails = [], 0, 0
    for site, (data, starts, width) in log.calls:
        if site == "array.ragged_gather_words":
            prefix, tails = width, 0
            seen.append((f"key words {width} (row starts)", data, starts, width))
        else:
            who = ("sorted rows", "group representatives")[min(tails, 1)]
            tails += 1
            seen.append((f"tails past {prefix} ({who})", data, starts, width))
    return seen


def _word_shapes(torch, col):
    """K1b's shapes, each with its own bound: the encode's own calls
    (captured: the 64- and 256-byte key words from the row starts, the
    tails past 64 and past 256 from the sorted rows' and the group
    representatives' starts), a 7-word tail (a partial last 16-byte
    store), starts at every residue mod 16, a data[1:] view, and buffers
    whose cap is 4k+1..4k+3 with windows running past it."""
    from custrings_tpu_torch.ops import window

    n, cap = col.size, col.capacity
    starts = col.offsets[:-1]
    g = torch.Generator(device="cpu").manual_seed(11)
    res = ((torch.randint(0, (cap - 400) // 16, (n,), generator=g) * 16
            + torch.arange(n) % 16).to(torch.int32).cuda())
    edge = torch.arange(4096, dtype=torch.int32) % 130
    encode = _captured_word_gathers(col)
    if len(encode) < 3 or not encode[0][0].startswith("key words 64"):
        raise AssertionError(f"expected the encode's key words 64 and its tails: {[c[0] for c in encode]}")

    def case(label, data, st, w):
        rows, wq = st.shape[0], -(-w // 4)
        return (f"i32[{rows},{wq}] {label}", lambda: window.ragged_gather_words(data, st, w),
                lambda: window._words_plain(data, st, w), {"bound": _words_bound(torch, data, st, w)})

    out = [case(label, data, st, w) for label, data, st, w in encode]
    out.append(case("28-byte tails", col.data, starts + 256, 28))
    out.append(case("starts at every residue mod 16", col.data, res, 64))
    out.append(case("data[1:] view", col.data[1:], starts, 64))
    for r in (1, 2, 3):
        m = cap // 4 * 4 - 4 + r
        out.append(case(f"cap {m} (4k+{r}), windows past it", col.data[:m],
                        (m - 100 + edge).cuda(), 64))
    return out


def window_edge_cases(torch, device="cuda", rows: int = 1 << 16, nbytes: int = 1 << 22):
    """K1's edge cases on a seeded buffer of `nbytes` random bytes:
    [(label, data, starts, width, lengths or None, int32 output)].
    Widths 1, 15, 16, 17, 31 and 513 with unsorted starts at every residue
    mod 16 (every fifth row repeating another row's start), each as uint8
    and int32, masked and unmasked; data[1:] views; caps of
    16k+1..16k+15 with windows running past them; negative starts and
    starts past the end.  Lengths are 0 every seventh row and up to
    1.5 W + 2 elsewhere, so rows of length 0 and lengths above W occur.
    The CPU tests run it with device="cpu", where each wrapper is its
    plain version."""
    rng = np.random.default_rng(12)
    base = torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8)).to(device)
    i = np.arange(rows)

    def tensor(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32)).to(device)

    def lengths(w):
        ln = rng.integers(0, w + w // 2 + 3, rows)
        ln[::7] = 0
        return tensor(ln)

    out = []
    for w in (1, 15, 16, 17, 31, 513):
        st = rng.integers(0, (nbytes - w) // 16, rows) * 16 + i % 16
        st[5::5] = st[rng.integers(0, rows, st[5::5].shape[0])]
        st, ln = tensor(st), lengths(w)
        for i32 in (False, True):
            label = f"width {w}, unsorted and repeated starts at every residue mod 16"
            out.append((f"{label}, masked", base, st, w, ln, i32))
            out.append((f"{label}, unmasked", base, st, w, None, i32))
    for w, i32, masked in ((17, False, True), (320, True, False)):
        st = tensor(rng.integers(0, nbytes - 1 - w, rows))
        out.append((f"width {w}, data[1:] view, {'masked' if masked else 'unmasked'}", base[1:], st, w,
                    lengths(w) if masked else None, i32))
    for r in range(1, 16):
        m, w = (nbytes // 16 - 4) * 16 + r, (17, 31, 64)[r % 3]
        masked = r % 4 >= 2
        out.append((f"width {w}, cap {m} (16k+{r}), windows past it, {'masked' if masked else 'unmasked'}",
                    base[:m], tensor(m - w - 8 + i % (w + 24)), w, lengths(w) if masked else None, r % 2 == 1))
    st = tensor(np.where(i % 2 == 0, rng.integers(-60, 40, rows), rng.integers(nbytes - 30, nbytes + 100, rows)))
    out.append(("width 40, negative starts and starts past the end, masked", base, st, 40, lengths(40), False))
    out.append(("width 40, negative starts and starts past the end, unmasked", base, st, 40, None, True))
    return out


def _window_edge_shapes(torch):
    """window_edge_cases on the card as K1 shapes, each held exactly to
    _gather_plain."""
    from custrings_tpu_torch.ops import window

    def case(label, data, st, w, ln, i32):
        kern = window.ragged_gather_i32 if i32 else window.ragged_gather

        def plain():
            out = window._gather_plain(data, st, w, ln)
            return out.to(torch.int32) if i32 else out

        return (f"{'i32' if i32 else 'u8'}[{st.shape[0]},{w}] {label}", lambda: kern(data, st, w, ln), plain)

    return [case(*c) for c in window_edge_cases(torch)]


#: K4c's tile (csrc/route.cu CSUPER), one look-back step and one read of
#: a given k0, and its sub-tile (CTILE), the unit it stages and writes
COMPACT_TILE = 32768
COMPACT_SUBTILE = 8192


def _compacted(res):
    """compact_stream's (planes, k0 or None) as one flat tuple."""
    outs, k0 = res
    return (*outs, k0) if k0 is not None else tuple(outs)


def _compact_stream_bound(keep, planes, k0_given: bool, want_k0: bool):
    """(bytes, ops) of compact_stream(keep, planes, k0, want_k0): keep read
    (1 B an element), every plane's kept elements read and all its output
    elements written; k0 read at each tile's start and at n when given
    (4 B a COMPACT_TILE elements), or written whole (4 B an element and
    the total) when wanted."""
    n = keep.shape[0]
    esum = sum(a.element_size() for a in planes)
    kept = int(keep.count_nonzero())
    k0_bytes = 4 * (-(-n // COMPACT_TILE) + 1) if k0_given else 4 * (n + 1) * int(want_k0)
    return n + kept * esum + n * esum + k0_bytes, 0


def compact_edge_cases(torch, device="cuda", rows: int = 1 << 16, cap: int = 167_772_160):
    """K4c's edge cases on seeded data: [(label, keep, planes, k0 or None,
    want_k0)].  Lengths of one sub-tile and one tile - 1, + 0 and + 1;
    densities 0, 1e-4, 0.5 and 1; each element size (uint8, bool, int32,
    int64) alone and eight mixed planes; unaligned views of the planes and
    of keep; k0 given, not given and not wanted; n of 0 and 1; a uint8
    keep with values above 1; and a few calls over `cap` elements.  The
    CPU tests run it with device="cpu" and a small cap, where
    compact_stream is its plain version."""
    rng = np.random.default_rng(14)
    b8 = torch.from_numpy(rng.integers(0, 256, max(rows, cap) + 256, dtype=np.uint8)).to(device)
    n32 = rows + 16
    b32 = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n32, dtype=np.int64).astype(np.int32)).to(device)
    b64 = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n32, dtype=np.int64)).to(device)
    bb = torch.from_numpy(rng.random(n32) < 0.5).to(device)

    def keep_of(n, density, off=0):
        x = torch.from_numpy(rng.random(n + off) < density).to(device)
        return x[off:]

    def k0_of(keep):
        k0 = torch.zeros(keep.shape[0] + 1, dtype=torch.int32, device=device)
        k0[1:] = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
        return k0

    def planes(kinds, n, off=0):
        pick = {"u8": b8, "bool": bb, "i32": b32, "i64": b64}
        return [pick[k][off: off + n] for k in kinds]

    t = COMPACT_SUBTILE
    out = []
    for unit, size in (("sub-tile", t), ("tile", COMPACT_TILE)):
        for n in (size - 1, size, size + 1):
            out.append((f"u8[{n}] ({unit}{' - 1' if n < size else ' + 1' if n > size else ''}), density 0.5",
                        keep_of(n, 0.5), planes(["u8"], n), None, True))
    for d in (0.0, 1e-4, 0.5, 1.0):
        out.append((f"u8+i32[{rows}] density {d}", keep_of(rows, d), planes(["u8", "i32"], rows), None, True))
    odd = rows + 123
    for kind in ("u8", "bool", "i32", "i64"):
        n = odd if kind == "u8" else rows
        out.append((f"{kind}[{n}] alone, density 0.5", keep_of(n, 0.5), planes([kind], n), None, True))
    eight = ["u8", "bool", "i32", "i64", "u8", "i32", "i64", "bool"]
    n = rows - 5
    k8 = keep_of(n, 0.3)
    for k0, want, how in ((None, True, "k0 written"), (k0_of(k8), True, "k0 given"), (None, False, "k0 not wanted")):
        out.append((f"eight mixed planes [{n}], {how}", k8, planes(eight, n), k0, want))
    n = rows - 1
    out.append((f"u8[{n}] data[1:] and keep[1:]", keep_of(n, 0.5, 1), planes(["u8"], n, 1), None, True))
    out.append((f"i32[{n}] data[1:] (4 bytes past 16) and keep[1:]", keep_of(n, 0.5, 1), planes(["i32"], n, 1),
                None, True))
    out.append((f"i64[{n}] data[1:], keep aligned", keep_of(n, 0.5), planes(["i64"], n, 1), None, True))
    out.append((f"u8+i32[{rows - 3}] keep[3:], planes aligned", keep_of(rows - 3, 0.5, 3),
                planes(["u8", "i32"], rows - 3), None, False))
    n = 3 * t + 17
    kk = keep_of(n, 0.5)
    for k0, want, how in ((None, True, "k0 written"), (k0_of(kk), True, "k0 given"), (None, False, "k0 not wanted")):
        out.append((f"u8+i64[{n}], {how}", kk, planes(["u8", "i64"], n), k0, want))
    out.append(("u8[0]", keep_of(0, 0.5), planes(["u8"], 0), None, True))
    for d in (0.0, 1.0):
        out.append((f"u8+i64[1] density {d}", keep_of(1, d), planes(["u8", "i64"], 1), None, True))
    one = torch.zeros(rows, dtype=torch.bool, device=device)
    one[-1] = True
    out.append((f"i32[{rows}] only the last kept", one, planes(["i32"], rows), None, True))
    first = one.roll(1)
    out.append((f"i64[{rows}] only the first kept, k0 given", first, planes(["i64"], rows), k0_of(first), True))
    u8keep = torch.from_numpy(rng.integers(0, 3, rows).astype(np.uint8)).to(device)
    out.append((f"u8[{rows}] uint8 keep with values 0..2", u8keep, planes(["u8"], rows), None, True))
    full = (b8[:cap] & 1) == 0
    out.append((f"u8[{cap}] density 1e-4, k0 not wanted", keep_of(cap, 1e-4), [b8[:cap]], None, False))
    out.append((f"u8[{cap}] all kept, k0 given", torch.ones(cap, dtype=torch.bool, device=device), [b8[:cap]],
                k0_of(torch.ones(cap, dtype=torch.bool, device=device)), True))
    out.append((f"u8[{cap - 1}] data[1:] and keep[1:], density 0.5", full[1:], [b8[1: cap]], None, True))
    return out


def _compact_edge_shapes(torch, cap: int):
    """compact_edge_cases on the card as K4c shapes, each held exactly to
    _compact_plain (every plane and k0) with its own bound."""
    from custrings_tpu_torch.ops import route

    def case(label, keep, planes, k0, want):
        return (f"{label}", lambda: _compacted(route.compact_stream(keep, planes, k0, want)),
                lambda: _compacted(route._compact_plain(keep.bool(), planes, k0, want)),
                {"bound": _compact_stream_bound(keep, planes, k0 is not None, want)})

    return [case(*c) for c in compact_edge_cases(torch, cap=cap)]


def _compact_stream_cases(torch, label, keep, planes, k0, forms, b2b=False):
    """K4c shapes of one call, compact_stream(keep, planes, ...) in each
    form of `forms` ("path": k0 not given but wanted, as most of the main
    path's calls; "not wanted": want_k0=False; "given": the given k0),
    each held to _compact_plain with its bound and the library call's
    time (torch.masked_select of each plane)."""
    from custrings_tpu_torch.ops import route

    args = {"path": (None, True), "not wanted": (None, False), "given": (k0, True)}
    names = "+".join(str(a.dtype).split(".")[-1] for a in planes)
    out = []
    for form in forms:
        k, want = args[form]
        extra = {"bound": _compact_stream_bound(keep, planes, k is not None, want),
                 "library": lambda: tuple(torch.masked_select(a, keep) for a in planes)}
        if b2b:
            extra["back_to_back"] = True
        how = {"path": "k0 written", "not wanted": "k0 not wanted", "given": "k0 given"}[form]
        out.append((f"{names}[{keep.shape[0]}] {label}, {how}",
                    lambda k=k, want=want: _compacted(route.compact_stream(keep, planes, k, want)),
                    lambda k=k, want=want: _compacted(route._compact_plain(keep.bool(), planes, k, want)),
                    extra))
    return out


def _compact_host_breakdown(torch, keep, plane, reps: int = 400):
    """The host's time (us a call, mean of `reps` after a warm-up) of
    compact_stream(keep, [plane]) at the group representatives' i64 call,
    whole (k0 written, not wanted, given) and by part: the checks and
    casts, the allocations (the output, and k0 with the status words in
    one buffer), the argument arrays, the stream lookup, and the ctypes
    call itself with k0 written (its memset of the status words and the
    launch) and with k0 given (the launch alone)."""
    from custrings_tpu_torch import kernels
    from custrings_tpu_torch.ops import route

    n = keep.shape[0]
    lib = kernels.lib()
    k0 = route._compact_plain(keep, [], None, True)[1]
    out = torch.empty_like(plane)
    words = lib.cs_compact_scratch_words(n)
    head = -(-(n + 1) // 4) * 4
    buf = torch.empty(head + 2 * words, dtype=torch.int32, device=keep.device)
    stream = kernels.stream_ptr(keep)
    ins, outs, esz = route._PTRS[1](plane.data_ptr()), route._PTRS[1](out.data_ptr()), route._INTS[1](8)
    dev = keep.get_device()

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
        return res

    def checks():
        k = route._flag(keep, n, "compact_stream")
        route._plane(plane, n, dev, "compact_stream")
        kernels.require_cuda(k, "compact_stream")
        k0.to(torch.int32).contiguous()

    def allocations():
        torch.empty_like(plane)
        torch.empty(head + 2 * words, dtype=torch.int32, device=keep.device)[: n + 1]

    parts = {
        "whole call, k0 written": us(lambda: route.compact_stream(keep, [plane])),
        "whole call, k0 not wanted": us(lambda: route.compact_stream(keep, [plane], want_k0=False)),
        "whole call, k0 given": us(lambda: route.compact_stream(keep, [plane], k0)),
        "checks and casts": us(checks),
        "allocations (output; k0 and status words)": us(allocations),
        "argument arrays": us(lambda: (route._PTRS[1](plane.data_ptr()), route._PTRS[1](out.data_ptr()),
                                       route._INTS[1](8))),
        "stream lookup": us(lambda: kernels.stream_ptr(keep)),
        "ctypes call, k0 written (status memset and launch)": us(lambda: lib.cs_compact(
            keep.data_ptr(), None, n, 1, ins, outs, esz, buf.data_ptr(), buf.data_ptr() + 4 * head, stream)),
        "ctypes call, k0 given (launch)": us(lambda: lib.cs_compact(
            keep.data_ptr(), k0.data_ptr(), n, 1, ins, outs, esz, None, None, stream)),
    }
    return {"call": f"i64[{n}] group representatives", "reps": reps, "us_per_call": parts}


def _captured_expansions(torch, col):
    """K4e's inputs as the main path passes them: the calls of
    shift_compact.expand_to made by modify.replace_literal(col, "the",
    "THEE") (the grow replace) and split.split_record(col, " ");
    ([grow calls], [split calls]), each call (live, dist, planes,
    out_cap, want_placed)."""
    from custrings_tpu_torch.ops import modify, shift_compact, split

    def calls(run):
        with _Calls((shift_compact, "expand_to")) as log:
            run()
        return [(live, dist, list(arrays), out_cap, rest[0] if rest else True)
                for _, (live, dist, arrays, out_cap, *rest) in log.calls]

    return (calls(lambda: modify.replace_literal(col, "the", "THEE")),
            calls(lambda: split.split_record(col, " ")))


def _chunked(torch, fn, rows: int, row_bytes: int):
    """fn(i, j) over row chunks [i, j) of about 2^27 window bytes,
    concatenated: a plain gather's int64 index plane over all of a
    29M-token call would not fit on the card."""
    step = max(1, (1 << 27) // max(row_bytes, 1))
    return torch.cat([fn(i, i + step) for i in range(0, max(rows, 1), step)])


def _window_bound(lens, width: int, out_bytes: int):
    """(bytes, ops) of a K1 window masked at the lengths: each row's first
    min(length, width) bytes, its start and its length read, the output
    written."""
    rows = lens.shape[0]
    return int(lens.clamp(0, width).sum()) + 8 * rows + out_bytes * rows * width, 0


def _text_kernel_shapes(torch, strs, device="cuda"):
    """K1, K1b and K4c at the text path's own calls on the text rows,
    captured by wrapping the names their callers look up, each with its
    own bound: the char matrix windows of the edit distance to
    DISTANCE_TARGET and of the pairwise distance's other column (K1); the
    key words and tails of unique_tokens' encode and the token key words
    of tokens_counts and replace_tokens (K1b); the whitespace split's
    compaction without k0 (as the split writer asks for it) and with k0
    given, with torch.masked_select's time (K4c).  Returns
    [(name, source, replaces, shapes)].  The CPU tests run it with
    device="cpu", where each wrapper is its plain version."""
    from custrings_tpu_torch import nvstrings, nvtext
    from custrings_tpu_torch.ops import array, layout, route, shift_compact, split, unique, window
    from custrings_tpu_torch.text import distance, token

    s = nvstrings.to_device(strs, device=device)

    def captured(sites, ops):
        """[(op call k: module.name, *args)] of each op's calls."""
        out = []
        for op, run in ops:
            with _Calls(*sites) as log:
                run()
            out += [(f"{op} call {k}: {site}", *args) for k, (site, args) in enumerate(log.calls)]
        return out

    k1 = captured(((layout, "ragged_gather_i32"), (layout, "ragged_gather")), (
        ("edit_distance to the target", lambda: nvtext.edit_distance(s, DISTANCE_TARGET)),
        ("pairwise edit_distance's other column",
         lambda: distance._char_matrix(s.replace("the", "THE", regex=False)._col))))
    tg = nvstrings.to_device(list(TEXT_TARGETS), device=device)
    rt = nvstrings.to_device([a for a, _ in TEXT_REPLACE], device=device)
    rr = nvstrings.to_device([b for _, b in TEXT_REPLACE], device=device)
    k1b = captured(((array, "ragged_gather_words"), (unique, "ragged_gather_words"),
                    (token, "ragged_gather_words")), (
        ("unique_tokens", lambda: nvtext.unique_tokens(s)),
        ("tokens_counts", lambda: nvtext.tokens_counts(s, tg)),
        ("replace_tokens", lambda: nvtext.replace_tokens(s, rt, rr))))
    with _Calls((shift_compact, "compact_arrays")) as k4c:
        split.split_record(s._col, None)
    if not k1 or not k1b or len(k4c.calls) != 1:
        raise AssertionError(f"text path calls not captured: K1 {len(k1)}, K1b {len(k1b)}, "
                             f"K4c {len(k4c.calls)} (want one)")

    def chars(label, data, st, w, lens):
        i32 = label.endswith("_i32")
        kern = window.ragged_gather_i32 if i32 else window.ragged_gather
        rows = st.shape[0]

        def plain():
            out = _chunked(torch, lambda i, j: window._gather_plain(data, st[i:j], w, lens[i:j]), rows, w)
            return out.to(torch.int32) if i32 else out

        return (f"{'i32' if i32 else 'u8'}[{rows},{w}] {label}, masked at the lengths",
                lambda: kern(data, st, w, lens), plain, {"bound": _window_bound(lens, w, 4 if i32 else 1)})

    def words(label, data, st, w):
        rows, wq = st.shape[0], -(-w // 4)
        return (f"i32[{rows},{wq}] {label}, width {w}", lambda: window.ragged_gather_words(data, st, w),
                lambda: _chunked(torch, lambda i, j: window._words_plain(data, st[i:j], w), rows, 4 * wq),
                {"bound": _words_bound(torch, data, st, w)})

    keep, planes, *want = k4c.calls[0][1]
    if want != [False]:
        raise AssertionError(f"the whitespace split writer asked for k0: {want}")
    k0 = route._compact_plain(keep.bool(), [], None, True)[1]
    label = f"whitespace split writer ({int(k0[-1])} bytes kept)"
    compacts = _compact_stream_cases(torch, label, keep, planes, k0, ("not wanted", "given"))
    return [("window_bytes", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
             [chars(*c) for c in k1]),
            ("window_words", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
             [words(*c) for c in k1b]),
            ("route_compact", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:290", compacts)]


def _expand_bound(live, planes, out_cap: int, want_placed: bool):
    """(bytes, ops) of expand_stream: live (1) read per input lane, dist
    (4) and every plane's element per live lane (a dead lane's need not
    be read); every plane's element and, when asked, placed (1) written
    per output slot."""
    esum = sum(a.element_size() for a in planes)
    nlive = int(live.sum())
    return live.shape[0] + nlive * (4 + esum) + out_cap * (esum + int(want_placed)), 0


def _expand_shapes(torch, col, width, live_grid, dist_grid):
    """K4e's shapes, each with its own bound: the grow replace's real
    inputs (with placed) first, the split's (int32 on the token domain,
    without placed), the padded grid, a mixed u8 + i32 + i64 call, dead
    lanes carrying garbage dist, targets at out_cap - 1, at out_cap and
    past it, an all-dead live, and out_cap below n."""
    from custrings_tpu_torch.ops import route

    grow, splits = _captured_expansions(torch, col)
    if len(grow) != 1 or not splits:
        raise AssertionError(f"expected one grow and some split expansions: {len(grow)}, {len(splits)}")
    g = torch.Generator(device="cpu").manual_seed(13)
    out = []

    def case(label, live, dist, planes, out_cap, want):
        def kern():
            return _expanded(route.expand_stream(live, dist, planes, out_cap, want))

        def plain():
            return _expanded(route._expand_plain(live.bool(), dist.to(torch.int32), planes, out_cap, want))

        names = "+".join(str(a.dtype).split(".")[-1] for a in planes)
        return (f"{names}[{live.shape[0]}] -> [{out_cap}]{' with placed' if want else ''} {label}",
                kern, plain, {"bound": _expand_bound(live, planes, out_cap, want)})

    live, dist, planes, bcap, want = grow[0]
    out.append(case("grow replace", live, dist, planes, bcap, want))
    for k, (sl, sd, sp, scap, sw) in enumerate(splits):
        out.append(case(f"split call {k}", sl, sd, sp, scap, sw))
    out.append(case("padded grid", live_grid, dist_grid, [col.data], col.size * width, True))
    n = live.shape[0]
    mixed = [planes[0], planes[0].to(torch.int32) * 7 - 3,
             torch.arange(n, dtype=torch.int64, device=live.device) << 20]
    out.append(case("mixed planes", live, dist, mixed, bcap, True))
    garbage = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g, dtype=torch.int32).cuda()
    out.append(case("dead lanes with garbage dist", live, torch.where(live, dist, garbage), planes, bcap, True))
    k = 1 << 20
    j = torch.arange(k, dtype=torch.int32, device=live.device)
    edge_dist = torch.where(j < k - 10, 3, 3 + (j - (k - 10)) * 5)
    edge_vals = (j % 251).to(torch.uint8)
    out.append(case("targets at out_cap - 1, out_cap and past", torch.ones(k, dtype=torch.bool, device=live.device),
                    edge_dist, [edge_vals], k - 7, True))
    out.append(case("all dead", torch.zeros(k, dtype=torch.bool, device=live.device),
                    torch.randint(-(1 << 31), (1 << 31) - 1, (k,), generator=g, dtype=torch.int32).cuda(),
                    [edge_vals], k, True))
    out.append(case("out_cap below n", live, dist, planes, n // 2, True))
    return out


#: fresh processes the launch checks may take, one after another, when a
#: profile came back without every device record of the calls it ran
LAUNCH_CHECK_PROCESSES = 2
#: the name of each group's record_function range in the profile
_GROUP_MARK = "launch check: "


def _device_counts(prof, cuda) -> dict:
    """{name: count} of the device's kernels, copies and memsets in a
    profile.  A record_function range (a launch check's group, the port's
    spans) shows on the device too, as a user annotation under its host
    name: those are left out."""
    ka = prof.key_averages()
    host = {e.key for e in ka if e.device_type != cuda}
    return {e.key: e.count for e in ka if e.device_type == cuda and e.self_device_time_total > 0 and e.key not in host}


def _launch_profile(torch, col):
    """torch.profiler over main-path calls of K4e, K1b, K6, K7 and K4c, all
    in one session (a record_function range a group): each expand_stream
    call (with and without placed, one or three planes) must run one
    expand_firsts, one expand_kernel and one fill of a single word (the
    pre-pass's ticket) and nothing else, so no fill of an output; each of
    the encode's ragged_gather_words calls one window_words kernel and
    nothing else; each hash_mm3 call one hash_rows kernel and nothing
    else; each compact_bytes call one compact_tiles kernel and one fill
    of its scratch status words (1 + its input tiles, int64) and nothing
    else: no K3 scan and no fill of an output; each compact_stream call
    (u8 at the capacity without k0, u8 + i32 there with k0 written, eight
    planes of 1M with k0 given) one compact_stream_tiles kernel, one
    memset of its status words (cs_compact makes it on the stream, so the
    host shows no aten fill) when k0 is not given and none when it is, no
    K3 scan, no fill of an output or of k0, and a route_compact count of
    one a call.  The device kernels are
    judged on their totals over the session (each kernel belongs to one
    group's calls, the fills to two: their aten ops, host events, are
    judged a group each).  The profiler can drop device records; a total
    below what the calls launched, with nothing extra, marks the profile
    incomplete rather than wrong.  Returns {"complete", "bad",
    "launched", "device_kernels", "fills", ...}."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from custrings_tpu_torch import kernels
    from custrings_tpu_torch.ops import compact, hash, route, window

    grow, splits = _captured_expansions(torch, col)
    live, dist, planes, bcap, _ = grow[0]
    sl, sd, sp, scap, _ = splits[-1]
    mixed = [planes[0], planes[0].to(torch.int32), planes[0].to(torch.int64)]
    calls = [lambda: route.expand_stream(live, dist, planes, bcap, True),
             lambda: route.expand_stream(sl, sd, sp, scap, False),
             lambda: route.expand_stream(live, dist, mixed, bcap, False)]
    words = [lambda data=data, st=st, w=w: window.ragged_gather_words(data, st, w)
             for _, data, st, w in _captured_word_gathers(col)]
    hashes = [lambda: hash.hash_mm3(col)] * 3
    cap = col.capacity
    space = col.data != 32
    compacts = [lambda: compact.compact_bytes(col.data, space, JAX_COMPACT_TB * -(-cap // JAX_COMPACT_TB)),
                lambda: compact.compact_bytes(col.data, space, cap // 2),
                lambda: compact.compact_bytes(col.data[1:], space[1:], cap - 1)]
    status = {f"[{kernels.lib().cs_compact_bytes_scratch_words(c)}]" for c in (cap, cap - 1)}
    g = torch.Generator(device="cpu").manual_seed(15)
    m = 1 << 20
    few = (torch.rand(m, generator=g) < 0.6).cuda()
    eight = [col.data[:m], few, col.data[:m].to(torch.int32), col.data[:m].to(torch.int64) << 33,
             col.data[m: 2 * m], col.offsets[:m], col.offsets[1: m + 1].to(torch.int64), few.roll(1)]
    few_k0 = route._compact_plain(few, [], None, True)[1]
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    streams = [lambda: route.compact_stream(space, [col.data], want_k0=False),
               lambda: route.compact_stream(space, [col.data, j]),
               lambda: route.compact_stream(few, eight, few_k0)]
    cuda = torch.autograd.DeviceType.CUDA
    groups = (("expand_stream", calls), ("ragged_gather_words", words), ("hash_mm3", hashes),
              ("compact_bytes", compacts), ("compact_stream", streams))
    for _, fns in groups:
        for fn in fns:
            fn()  # first use
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for name, fns in groups:
            with record_function(_GROUP_MARK + name):
                for fn in fns:
                    fn()
                torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("route_expand", "window_words", "hash",
                                                              "compact_bytes", "route_compact")}
    found = _device_counts(prof, cuda)
    # a fill is a FillFunctor kernel or a memset, whichever torch takes;
    # the shapes of the tensors the fills wrote (torch.zeros records a
    # zero_, an explicit fill a fill_), by the group whose range holds them
    events = prof.events()
    ranges = {e.name[len(_GROUP_MARK):]: e.time_range for e in events
              if e.device_type != cuda and e.name.startswith(_GROUP_MARK)}
    fill_counts = {name: {} for name, _ in groups}
    for e in events:
        if e.device_type != cuda and e.key in ("aten::fill_", "aten::zero_"):
            for name, span in ranges.items():
                if span.start <= e.time_range.start <= span.end:
                    key = (e.key, str(e.input_shapes[0] if e.input_shapes else None))
                    fill_counts[name][key] = fill_counts[name].get(key, 0) + 1
    fills = {name: [[shape, c] for (_, shape), c in per.items()] for name, per in fill_counts.items()}
    want = {"expand_firsts": len(calls), "expand_kernel": len(calls), "window_words": len(words),
            "hash_rows": len(hashes), "compact_tiles": len(compacts), "compact_stream_tiles": len(streams),
            "fill": len(calls) + len(compacts) + 2}  # and compact_stream's two memsets
    want_launched = {"route_expand": len(calls), "window_words": len(words), "hash": len(hashes),
                     "compact_bytes": len(compacts), "route_compact": len(streams)}
    want_fills = {"expand_stream": [["[1]", len(calls)]], "ragged_gather_words": [], "hash_mm3": [],
                  "compact_stream": []}

    def kind(key):
        if "FillFunctor" in key or "Memset" in key:
            return "fill"
        return next((k for k in want if k != "fill" and k in key), key)

    counts = {k: sum(c for key, c in found.items() if kind(key) == k) for k in want}
    bad = {}
    others = {key: c for key, c in found.items() if kind(key) not in want}
    if others:
        bad["other device kernels"] = others
    over = {k: c for k, c in counts.items() if c > want[k]}
    if over:
        bad["more device kernels than the calls launch"] = over
    if launched != want_launched:
        bad["launch counters"] = launched
    for name, _ in groups:
        if name == "compact_bytes":
            ok = {shape for shape, _ in fills[name]} <= status
        else:
            ok = fills[name] == want_fills[name]
        if not ok:
            bad[f"fills of {name}"] = fills[name]
    return {"calls": {name: len(fns) for name, fns in groups}, "complete": counts == want,
            "bad": bad, "launched": launched, "device_kernel_counts": counts, "want": want,
            "device_kernels": found, "fills": fills, "compact_status_shapes": sorted(status)}


def _launch_checks(torch, col):
    """_launch_profile in this process; if its profile came back
    incomplete (fewer device records than the calls launched, nothing
    else wrong), again in up to LAUNCH_CHECK_PROCESSES fresh processes
    (`chip_smoke.py --launch-checks`, each its first profiler session over
    the same corpus).  Fails on the first verdict that finds a call
    launching other kernels than its own, and when no profile came back
    complete."""
    verdict = _launch_profile(torch, col)
    _emit({"phase": "launch checks", "process": "main", **verdict})
    tries = 0
    while verdict["complete"] is not True and not verdict["bad"] and tries < LAUNCH_CHECK_PROCESSES:
        tries += 1
        torch.cuda.empty_cache()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--launch-checks"],
                             capture_output=True, text=True, timeout=300)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        try:
            verdict = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            verdict = {"complete": False, "bad": {"fresh process": res.returncode,
                                                  "stderr": res.stderr[-2000:]}}
        _emit({"phase": "launch checks", "process": f"fresh {tries}", "rc": res.returncode, **verdict})
    if verdict["bad"]:
        raise AssertionError(f"calls that launched other kernels than theirs: {verdict['bad']}")
    if verdict["complete"] is not True:
        raise AssertionError(f"the profiler lost device records in {tries + 1} profiles: "
                             f"{verdict.get('device_kernel_counts')} of {verdict.get('want')}")


def _launch_check_process() -> int:
    """`chip_smoke.py --launch-checks`: _launch_profile alone in this
    process, over the main run's corpus; prints its verdict as the last
    line and exits 0 when the profile was complete and clean, 1 when a
    call launched other kernels than its own (or no card), 3 when the
    profile was incomplete."""
    import torch

    if not torch.cuda.is_available():
        return 1
    from custrings_tpu_torch import column, kernels

    kernels.lib()
    col = column.from_host_strings(make_corpus(ROWS, seed=0), "cuda")
    verdict = _launch_profile(torch, col)
    _emit(verdict)
    if verdict["bad"]:
        return 1
    return 0 if verdict["complete"] else 3


def _scan_shapes(torch, col, lens, signed):
    """K3's shapes, each with its bound (every input byte read once, every
    output written once) and, where one torch call computes the same
    function, that call: (sum shapes, max shapes).  The first of each is
    the headline; then the main path's cumsum0 and row-id forms, int8
    input, lengths of 1, 4097, 8193 (one past the kernel's 8192-element
    tile) and one not a multiple of the tile, unaligned views and a sum
    that wraps past 2^31."""
    from custrings_tpu_torch.ops import scan

    n, cap = col.size, col.capacity
    g = torch.Generator(device="cpu").manual_seed(1)
    wraps = torch.randint(1 << 30, (1 << 31) - 1, (n,), generator=g, dtype=torch.int32).cuda()
    hi = col.data >= 0x80
    marks = torch.zeros(cap + 1, dtype=torch.int32, device=col.device)
    marks.index_add_(0, col.offsets[:-1].to(torch.int64), torch.ones_like(lens))
    marks = marks[:cap]
    buf = torch.zeros(cap + 1, dtype=torch.int32, device=col.device)
    x8 = col.data.view(torch.int8)

    def plain_sum(x):
        return torch.cumsum(x, 0, dtype=torch.int32)

    def s_case(label, x, in_bytes):
        k = x.shape[0]
        return (f"{label} {str(x.dtype).split('.')[-1]}[{k}]", lambda: scan.cumsum_i32(x),
                lambda: scan._cumsum_plain(x),
                {"bound": (k * (in_bytes + 4), k), "library": lambda: plain_sum(x)})

    def m_case(label, x, in_bytes):
        k = x.shape[0]
        return (f"{label} {str(x.dtype).split('.')[-1]}[{k}]", lambda: scan.cummax_i32(x),
                lambda: scan._cummax_plain(x),
                {"bound": (k * (in_bytes + 4), k), "library": lambda: torch.cummax(x, 0).values})

    sums = [
        s_case("bytes", col.data, 1),
        s_case("lengths", lens, 4),
        (f"cumsum0 bool[{cap}] -> i32[{cap + 1}] (non-ASCII bytes)", lambda: scan.cumsum0_i32(hi),
         lambda: scan._cumsum0_plain(hi),
         {"bound": (cap + 4 * (cap + 1), cap),
          "library": lambda: torch.cumsum(hi, 0, dtype=torch.int32, out=buf[1:])}),
        (f"row ids i32[{cap}] (row_ids_from_offsets)", lambda: scan.cumsum_row_ids(marks, n),
         lambda: scan._row_ids_plain(marks, n), {"bound": (8 * cap, 3 * cap)}),
        s_case("sign-extended", x8, 1),
        s_case("unaligned view data[1:]", col.data[1:], 1),
        s_case("unaligned view lengths[1:]", lens[1:], 4),
        s_case("wrapping past 2^31", wraps, 4),
        s_case("length 1", col.data[:1], 1),
        s_case("length 4097", col.data[:4097], 1),
        s_case("length 8193", col.data[:8193], 1),
        s_case("not a tile multiple", col.data[:1_000_003], 1),
    ]
    maxes = [
        m_case("signed", signed, 4),
        m_case("bytes", col.data, 1),
        (f"cummax0 i32[{n}] -> i32[{n + 1}] (split token ends)", lambda: scan.cummax0_i32(signed),
         lambda: scan._cummax0_plain(signed), {"bound": (4 * n + 4 * (n + 1), n)}),
        m_case("unaligned view signed[1:]", signed[1:], 4),
        m_case("length 1", signed[:1], 4),
        m_case("length 4097", signed[:4097], 4),
    ]
    return sums, maxes


def _scan_checks(torch, col):
    """100 back-to-back K3 calls (sum, cumsum0 and max, inputs of changing
    length, no sync between them), each exact against its plain version,
    so no scratch state leaks from one call to the next; and three calls
    of cumsum0 at capacity under torch.profiler, which must show one scan
    kernel per call."""
    from torch.profiler import ProfilerActivity, profile

    from custrings_tpu_torch.ops import scan

    g = torch.Generator(device="cpu").manual_seed(3)
    sizes = torch.randint(1, 1 << 20, (100,), generator=g).tolist()
    forms = [(scan.cumsum_i32, scan._cumsum_plain), (scan.cumsum0_i32, scan._cumsum0_plain),
             (scan.cummax_i32, scan._cummax_plain)]
    outs = [forms[i % 3][0](col.data[i: i + k]) for i, k in enumerate(sizes)]
    torch.cuda.synchronize()
    bad = [i for i, (k, got) in enumerate(zip(sizes, outs))
           if not torch.equal(got, forms[i % 3][1](col.data[i: i + k]))]
    hi = col.data >= 0x80
    scan.cumsum0_i32(hi)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            scan.cumsum0_i32(hi)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device_kernels = _device_counts(prof, cuda)
    scan_kernels = sum(c for k, c in device_kernels.items() if "scan_tiles" in k)
    _emit({"phase": "scan checks", "back_to_back_calls": len(sizes), "mismatched_calls": bad,
           "profiled_calls": calls, "device_kernels": device_kernels,
           "scan_kernels_per_call": scan_kernels / calls})
    if bad:
        raise AssertionError(f"K3 calls that disagree with their plain version: {bad}")
    if scan_kernels != calls:
        raise AssertionError(f"{calls} cumsum0 calls ran {scan_kernels} scan kernels: {device_kernels}")


def _measure(torch, cases, slow=(), one_plain=(), phase="kernel"):
    """Each case's kernel against its plain version at each shape, exactly,
    with median times; the plain walks of `slow` take 3 timed calls, those
    of `one_plain` one (which is also the comparison's).  A shape may carry
    a fourth item, {"bound": (bytes, ops), "library": fn, "back_to_back":
    True}, for its own bound, library time and back-to-back time (every
    shape of the kernels in BACK_TO_BACK has one).  Each case's record is
    printed as a `phase` line."""
    out = []
    for name, source, replaces, shapes, (nbytes, nops), library in cases:
        rec = {"name": name, "route": "cuda", "source": f"custrings_tpu_torch/{source}",
               "replaces": replaces, "tolerance": "exact (torch.equal)", "shapes": [],
               "max_abs_err": 0.0}
        for label, kern, plain, *extra in shapes:
            if name in one_plain:
                want, plain_ms = _timed(torch, plain)
                err = _compare(torch, f"{name} {label}", kern(), want)
                del want
            else:
                err = _compare(torch, f"{name} {label}", kern(), plain())
                plain_ms = _time_ms(torch, plain, reps=3 if name in slow else REPS)
            ms = _time_ms(torch, kern)
            shape = {"shape": label, "ms": ms, "plain_ms": plain_ms}
            if name in BACK_TO_BACK or (extra and extra[0].get("back_to_back")):
                shape["ms_back_to_back"], shape["host_ms_back_to_back"] = _back_to_back_ms(torch, kern)
            if extra:
                shape["bound_ms"], shape["bound_by"] = _bound(*extra[0]["bound"])
                lib_fn = extra[0].get("library")
                shape["library_ms"] = _time_ms(torch, lib_fn) if lib_fn is not None else None
            rec["shapes"].append(shape)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the headline numbers are the first (main-path) shape's
        rec["ms"] = rec["shapes"][0]["ms"]
        rec["plain_ms"] = rec["shapes"][0]["plain_ms"]
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, nops)
        rec["bound_bytes"] = int(nbytes)
        rec["bound_ops"] = int(nops)
        rec["library_ms"] = _time_ms(torch, library) if library is not None else None
        _emit({"phase": phase, **rec})
        out.append(rec)
    return out


def _walk_words(torch, nfa, first, end):
    """(bytes, ops) of K2b's walk over positions first..end-1 of each row:
    the chars (4 bytes a position; the predicates and closure variants are
    computed from them) plus lengths and output (5 bytes a row), and per
    position at least the injection, one closure row and the end test over
    the W words."""
    npos = (end.to(torch.int64) - first.to(torch.int64)).clamp(min=0).sum().item()
    return npos * 4 + 5 * first.shape[0], npos * (8 + 6 * nfa.W32)


#: the JAX package's output tile of compact_bytes: its callers round
#: out_cap up to whole tiles
JAX_COMPACT_TB = 2048


def _hash_bound(col):
    """(bytes, ops) of hash_mm3(col): each row's bytes read once, the
    offsets read and the int64 output written; ~10 ops per 4-byte block
    and ~20 a row (tail and fmix)."""
    n = col.size
    nbytes = int(col.offsets[-1] - col.offsets[0])
    return nbytes + 4 * (n + 1) + 8 * n, 10 * (nbytes // 4) + 20 * n


def _hash_shapes(torch, col, long_rows):
    """K6's shapes, each with its own bound: the tweet rows (the
    headline), the 2,048 long log rows, 2^20 rows of 0-9 bytes (every
    len & 3), one row of 10,003 bytes among short ones (far past the
    kernel's 128-byte step), a column whose last row ends on the
    buffer's last byte with cap % 16 = 7, and the tweet rows on a data
    view 3 bytes into its allocation."""
    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import hash

    rng = np.random.default_rng(17)

    def raw(lens):
        """Random bytes in rows of these lengths, capacity = the bytes."""
        offs = np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64))]).astype(np.int32)
        data = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
        return column.from_numpy(data, offs, np.ones(len(lens), bool), "cuda")

    ends = rng.integers(0, 300, 4099)
    ends[-1] += (7 - int(ends.sum())) % 16
    buf = torch.zeros(col.capacity + 3, dtype=torch.uint8, device=col.device)
    buf[3:] = col.data
    cases = [("tweets", col), ("long log rows", column.from_host_strings(long_rows, "cuda")),
             ("rows of 0-9 bytes", raw(rng.integers(0, 10, 1 << 20))),
             ("one row of 10,003 bytes", raw([5, 0, 10_003, 3, *rng.integers(0, 300, 60)])),
             ("last row ending at cap, cap % 16 = 7", raw(ends)),
             ("tweets on data[3:] of a buffer",
              column.StringColumn(buf[3:], col.offsets, col.validity))]
    return [(f"{label} [{c.size} rows, {int(c.offsets[-1])} bytes, cap {c.capacity}]",
             lambda c=c: hash.hash_mm3(c), lambda c=c: hash._hash_plain(c),
             {"bound": _hash_bound(c)}) for label, c in cases]


def _compact_bound(torch, keep, out_cap: int):
    """(bytes, ops) of compact_bytes(data, keep, out_cap): out_cap bytes
    written, and data and keep read up to the out_cap-th kept byte (the
    whole input when fewer are kept, since it takes reading all of keep
    to know there is no more)."""
    if out_cap == 0:
        return 0, 0
    cap = keep.shape[0]
    k0 = torch.cumsum(keep.to(torch.int64), 0)
    need = cap if int(k0[-1]) < out_cap else int(torch.searchsorted(k0, out_cap)) + 1
    return 2 * need + out_cap, 0


def _compact_shapes(torch, data):
    """K7's shapes, compact_bytes(data, keep, out_cap) as the JAX package
    exposes it, each with its bound (_compact_bound): "byte is not a
    space" (the headline) and 5% kept (seeded) with the JAX callers'
    out_cap (the kept count rounded up to whole 2,048-byte tiles) and
    torch.masked_select's time; then out_cap =
    capacity (a zero tail of ~28 MB), out_cap below the kept count,
    out_cap = 0, all and none kept, a uint8 keep, caps of 4k+1..4k+3,
    below one tile and below 16 bytes, data[1:] with keep[1:] (one
    offset mod 16) and with keep[:-1] (two)."""
    from custrings_tpu_torch.ops import compact

    cap = data.shape[0]
    g = torch.Generator(device="cpu").manual_seed(7)
    sparse = (torch.rand(cap, generator=g) < 0.05).cuda()
    space = data != 32
    kept = int(space.sum())

    def tiles(k):
        return JAX_COMPACT_TB * max(-(-k // JAX_COMPACT_TB), 1)

    def case(label, d, k, oc, library=False):
        extra = {"bound": _compact_bound(torch, k, oc)}
        if library:
            extra["library"] = lambda: torch.masked_select(d, k)
        return (f"u8[{d.shape[0]}] {label} -> u8[{oc}]", lambda: compact.compact_bytes(d, k, oc),
                lambda: compact._compact_plain(d, k.bool(), oc), extra)

    m = 1_000_000
    return [
        case("byte is not a space", data, space, tiles(kept), True),
        case("5% kept", data, sparse, tiles(int(sparse.sum())), True),
        case(f"not a space, out_cap = capacity (zero tail {cap - kept})", data, space, cap),
        case("not a space, out_cap below the kept count", data, space, kept // 2 + 5),
        case("out_cap 0", data, space, 0),
        case("all kept", data, torch.ones_like(space), cap),
        case("none kept", data, torch.zeros_like(space), cap),
        case("uint8 keep", data, space.to(torch.uint8), tiles(kept)),
        *[case(f"cap 4k+{r}", data[:m + r], space[:m + r], m + r) for r in (1, 2, 3)],
        case("cap below one tile", data[:5001], space[:5001], 6000),
        case("cap 7", data[:7], space[:7], 16),
        case("data[1:], keep[1:]", data[1:], space[1:], cap - 1),
        case("data[1:], keep[:-1]", data[1:], space[:-1], cap - 1),
    ]


def _compact_checks(torch, data):
    """100 back-to-back compact_bytes calls (slices of changing length and
    offset, out_cap below, at and above the slice, no sync between them),
    each exact against its plain version, so no scratch state leaks from
    one call to the next."""
    from custrings_tpu_torch.ops import compact

    g = torch.Generator(device="cpu").manual_seed(5)
    sizes = torch.randint(1, 1 << 20, (100,), generator=g).tolist()
    caps = [k * f // 4 for k, f in zip(sizes, torch.randint(0, 6, (100,), generator=g).tolist())]
    keep = data % 3 != 0
    outs = [compact.compact_bytes(data[i: i + k], keep[i: i + k], oc)
            for i, (k, oc) in enumerate(zip(sizes, caps))]
    torch.cuda.synchronize()
    bad = [i for i, (k, oc, got) in enumerate(zip(sizes, caps, outs))
           if not torch.equal(got, compact._compact_plain(data[i: i + k], keep[i: i + k], oc))]
    _emit({"phase": "compact checks", "back_to_back_calls": len(sizes), "mismatched_calls": bad})
    if bad:
        raise AssertionError(f"K7 calls that disagree with their plain version: {bad}")


def _kernel_phase_rest(torch, col, logs_col, err_starts, long_rows):
    """K2b on the log rows (ERR, ISO and MONTH, unanchored and anchored;
    ERR unanchored is the headline shape; then ERR without its word
    boundaries), K6 at its shapes (_hash_shapes) and K7 at its
    (_compact_shapes), each against its plain version."""
    from custrings_tpu_torch.ops import layout
    from custrings_tpu_torch.regex import ops as rx

    chars, nch = layout.char_matrix(logs_col)
    N, L = chars.shape
    k2b = []
    names = {ERR: "ERR", ISO: "ISO", MONTH: "MONTH", ERR_NB: "ERR without \\b"}
    for pat, anchored in [(p, a) for p in K2B_PATTERNS for a in (False, True)] + [(ERR_NB, False)]:
        nfa = rx._get_nfa(pat)
        mode = "anchored" if anchored else "unanchored"
        tag = f"{names[pat]} ({nfa.I} insts, W32 {nfa.W32}, U {nfa.U}) {mode} [{N},{L}]"
        k2b.append((tag, lambda nfa=nfa, a=anchored: nfa._matches_words(chars, nch, a),
                    lambda nfa=nfa, a=anchored: nfa._matches_plain(chars, nch, a)))
    # the positions K2b must read for ERR unanchored: each row up to at
    # least its leftmost match begin (Python re), the whole row where
    # nothing matches
    starts = torch.tensor(err_starts, dtype=torch.int32).cuda()
    row_end = torch.minimum(nch, torch.full_like(nch, L))
    k2b_end = torch.where(starts >= 0, starts + 1, row_end)
    hashes = _hash_shapes(torch, col, long_rows)
    compacts = _compact_shapes(torch, col.data)
    cases = [
        ("nfa_words", "csrc/nfa_words.cu", "custrings_tpu/regex/pallas_nfa.py:332", k2b,
         _walk_words(torch, rx._get_nfa(ERR), torch.zeros_like(nch), k2b_end), None),
        ("hash", "csrc/hash.cu", "custrings_tpu/ops/pallas_hash.py:111", hashes,
         hashes[0][3]["bound"], None),
        ("compact_bytes", "csrc/compact.cu", "custrings_tpu/ops/pallas_compact.py:184", compacts,
         compacts[0][3]["bound"], compacts[0][3]["library"]),
    ]
    return _measure(torch, cases, one_plain=("nfa_words",))


def _expanded(res):
    """expand_stream's (planes, placed or None) as one flat tuple."""
    outs, placed = res
    return (*outs, placed) if placed is not None else tuple(outs)


def _view_phase(torch, col, width):
    """The streaming padded view against the K1 window view at the widths
    the slice builds at 1M rows: the full width (char matrix; the stream
    runs K4e alone) and the encode's 64- and 256-byte key prefixes (K4c
    then K4e); plus the 64-byte key words both ways (packed view against
    K1b).  The window view is the route the package takes."""
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
    launches = _view_launches(torch, col, width)
    _emit({"phase": "views", "tolerance": "exact (torch.equal)", "views": rows,
           "entry_point_launches": launches})
    moved = {k: launches[k] for k in ("route_compact", "route_expand", "scan_sum_capacity") if launches[k]}
    if moved:
        raise AssertionError(f"the views' entry points took the streaming route: {moved}")


def _view_launches(torch, col, width):
    """The kernel launches of the views' entry points as the main path
    calls them (padded_view at the three widths, char_matrix, the 64- and
    256-byte key words) on a fresh column whose row facts (non-ASCII row
    ids, longest row) are already cached, as after the column's first op."""
    from custrings_tpu_torch import column, kernels
    from custrings_tpu_torch.ops import array, layout

    c = column.StringColumn(col.data, col.offsets, col.validity)
    layout.row_nonascii_ids(c)
    layout.max_row_bytes(c)
    torch.cuda.synchronize()
    kernels.reset_launches()
    for w in (width, 64, 256):
        layout.padded_view(c, w)
    layout.char_matrix(c, width)
    array._key_words(c, 64)
    array._key_words(c, 256)
    torch.cuda.synchronize()
    return {**{k: v for k, v in kernels.LAUNCHES.items() if v},
            "route_compact": kernels.LAUNCHES["route_compact"],
            "route_expand": kernels.LAUNCHES["route_expand"],
            "scan_sum_capacity": kernels.SCAN_SUM_SIZES["capacity"]}


def _category_oracle(strs):
    uniq = sorted({s for s in strs if s is not None}, key=lambda s: s.encode("utf-8"))
    keys = ([None] if any(s is None for s in strs) else []) + uniq
    rank = {k: i for i, k in enumerate(keys)}
    return keys, [rank[s] for s in strs]


def _stepper(torch, times, peaks=None, cuda=True):
    """step(name, fn, *args): fn(*args), its host-clock seconds in times[name]
    and, with `peaks`, its peak device memory in peaks[name]; without
    `cuda` (the CPU tests) the seconds alone."""
    def step(name, fn, *args):
        if cuda:
            torch.cuda.synchronize()
            if peaks is not None:
                torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
            if peaks is not None:
                peaks[name] = torch.cuda.max_memory_allocated()
        times[name] = time.perf_counter() - t0
        return out

    return step


def _records_to_host(recs):
    return [None if r is None else r.to_host() for r in recs]


def _run_slice(torch, strs):
    """The facade chain; returns (contains/replace/encode results, the
    size-changing rewrites' results, per-op seconds, the matcher engine
    calls of contains as _RouteLog records them)."""
    from custrings_tpu_torch import nvcategory, nvstrings

    times = {}
    step = _stepper(torch, times)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    with _RouteLog() as log:
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
    return (hits, replaced, keys, values, cat.keys_size()), (grown_h, shrunk_h, tokens_h), times, log.calls


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


class _SpanLog:
    """Records each DeviceProgram.all_spans call while active, by wrapping
    it: its rows, width, counts_only, span_all launches, matches and rows
    with a match."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from custrings_tpu_torch import kernels
        from custrings_tpu_torch.regex import device

        self._saved = all_spans = device.DeviceProgram.all_spans

        def logged_all_spans(dp, chars, *a, **k):
            n0 = kernels.LAUNCHES["span_all"]
            out = all_spans(dp, chars, *a, **k)
            self.calls.append({"rows": int(chars.shape[0]), "width": int(chars.shape[1]),
                               "counts_only": bool(k.get("counts_only", False)),
                               "launches": kernels.LAUNCHES["span_all"] - n0,
                               "matches": int(out[0].sum()), "rows_matched": int((out[0] > 0).sum())})
            return out

        device.DeviceProgram.all_spans = logged_all_spans
        return self

    def __exit__(self, *exc):
        from custrings_tpu_torch.regex import device

        device.DeviceProgram.all_spans = self._saved


def _run_spans(torch, strs):
    """The span ops through the facade; returns (results, per-op seconds,
    {op: [all_spans calls, as _SpanLog records them]})."""
    from custrings_tpu_torch import nvstrings

    times, calls = {}, {}
    step = _stepper(torch, times)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    ops = [("count", lambda: s.count(SPAN_COUNT)),
           ("findall_record", lambda: s.findall_record(SPAN_FIND)),
           ("replace_re", lambda: s.replace(SPAN_REPLACE, "EMAIL", regex=True))]
    out = {}
    for name, fn in ops:
        with _SpanLog() as log:
            out[name] = step(name, fn)
        calls[name] = log.calls
    found = step("findall_to_host", lambda: _records_to_host(out["findall_record"]))
    replaced = step("replace_re_to_host", out["replace_re"].to_host)
    return (out["count"], found, replaced), times, calls


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


def _matcher_sets(logs, long_rows):
    """(set, rows, [(filter, pattern)]) of the matchers phase: the log rows
    on K2b, their first BIG_ROWS on the vector engine, the long rows on the
    chunked engine (MATCHER_ROUTES)."""
    k2b = [("ERR", ERR), ("ISO", ISO), ("MONTH", MONTH)]
    return [("logs", logs, k2b), ("logs_big", logs[:BIG_ROWS], [("BIG", BIG)]), ("long", long_rows, k2b)]


#: the engines every call of each matcher set must take, and no other
MATCHER_ROUTES = {"logs": ["K2b"], "logs_big": ["vector"], "long": ["chunked"]}
#: (module, class, method, engine, kernel counter) of the boolean
#: matcher's four engines
_ENGINES = (("nfa_bits", "NFABits", "matches", "K2", "nfa_bits"),
            ("nfa_words", "NFAWords", "matches", "K2b", "nfa_words"),
            ("device", "DeviceProgram", "nfa_matches", "vector", None),
            ("device", "DeviceProgram", "nfa_matches_chunked", "chunked", None))


class _RouteLog:
    """Records each call of the boolean matcher's engines while active, by
    wrapping their entry points: its engine, rows, width and, for K2 and
    K2b, the launches of its kernel; `engines` lists the engines taken,
    sorted."""

    def __enter__(self):
        from custrings_tpu_torch import kernels
        from custrings_tpu_torch.regex import device, nfa_bits, nfa_words

        mods = {"device": device, "nfa_bits": nfa_bits, "nfa_words": nfa_words}
        self.calls, self._saved = [], []
        for mod, cls_name, meth, engine, counter in _ENGINES:
            cls = getattr(mods[mod], cls_name)
            fn = getattr(cls, meth)
            self._saved.append((cls, meth, fn))

            def logged(obj, chars, *a, _fn=fn, _engine=engine, _counter=counter, **k):
                n0 = kernels.LAUNCHES[_counter] if _counter else 0
                out = _fn(obj, chars, *a, **k)
                self.calls.append({
                    "engine": _engine, "rows": int(chars.shape[0]), "width": int(chars.shape[1]),
                    "launches": kernels.LAUNCHES[_counter] - n0 if _counter else None,
                })
                return out

            setattr(cls, meth, logged)
        return self

    def __exit__(self, *exc):
        for cls, meth, fn in self._saved:
            setattr(cls, meth, fn)

    @property
    def engines(self):
        return sorted({c["engine"] for c in self.calls})


def _relaunched(calls_by_op):
    """{op: launches of each engine call} of the ops routed to K2 or K2b
    that did not make exactly one engine call launching its kernel once."""
    bad = {}
    for op, calls in calls_by_op.items():
        launches = [c["launches"] for c in calls]
        if calls and {c["engine"] for c in calls} <= {"K2", "K2b"} and launches != [1]:
            bad[op] = launches
    return bad


def _matcher_oracle(sets):
    """{(set, filter, op): per-row results} from Python re (None for null
    rows)."""
    want = {}
    for set_name, strs, filters in sets:
        for fname, pat in filters:
            rx = re.compile(pat)
            want[set_name, fname, "contains"] = [None if s is None else rx.search(s) is not None for s in strs]
            want[set_name, fname, "match"] = [None if s is None else rx.match(s) is not None for s in strs]
    return want


def _run_matchers(torch, sets):
    """contains and match of every filter of every set through the facade;
    returns (results, per-op seconds, per-op peak device memory, per-op
    engine calls as _RouteLog records them)."""
    from custrings_tpu_torch import nvstrings

    times, peaks, out, calls = {}, {}, {}, {}
    step = _stepper(torch, times, peaks)
    for set_name, strs, filters in sets:
        s = step(f"{set_name} to_device", lambda: nvstrings.to_device(strs, device="cuda"))
        for fname, pat in filters:
            for op in ("contains", "match"):
                with _RouteLog() as log:
                    out[set_name, fname, op] = step(f"{set_name} {op} {fname}", getattr(s, op), pat)
                calls[set_name, fname, op] = log.calls
        del s
    return out, times, peaks, calls


def _run_hash(torch, strs):
    """nvstrings.hash through the facade; returns (hashes, per-op seconds,
    per-op peak device memory)."""
    from custrings_tpu_torch import nvstrings

    times, peaks = {}, {}
    step = _stepper(torch, times, peaks)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    return step("hash", s.hash), times, peaks


def _run_compact(torch, data):
    """compact_bytes(data, data != ' ', capacity), the JAX package's entry
    point; returns (result, the keep mask)."""
    from custrings_tpu_torch.ops import compact

    keep = data != 32
    return compact.compact_bytes(data, keep, data.shape[0]), keep


#: the text phase's nvtext targets: words of the corpus's token groups
TEXT_TARGETS = ("the", "theme", "there", "a", "to", "of", "love", "day", "lol", "rt", "people",
                "night", "#data", "#ai", "@user", "@nvidia", "http://t.co/abc123", "café", "日本語",
                "😀🔥")
#: replace_tokens' targets and replacements
TEXT_REPLACE = (("the", "THE"), ("#ai", "#AI"), ("café", "cafe"))
DISTANCE_TARGET = "the conference"
#: the rows whose tokens the n-grams take, and the rows (and vocabulary
#: words) the distance and Porter oracles sample
NGRAM_ROWS = 1 << 17
TEXT_SAMPLE = 4096
#: whitespace runs of the rewritten rows, and the two code points above
#: 0x20 that look like spaces and stay inside a token
_WS_RUNS = (" ", "  ", "\t", "\n", "\x0b", "\x1f", " \t ", "\r\n", "\x0c", "\x00")
_IN_TOKEN = ("\xa0", "　")


def make_text_rows(strs, seed: int = 4):
    """strs with a seeded ~10% of the rows rewritten for the whitespace
    split: each space becomes a run of mixed whitespace (\\t \\n \\x0b \\x1f
    \\x00 ...), about one join in twenty becomes \\xa0 or \\u3000 (which stay
    inside a token), and half of them gain leading or trailing whitespace;
    ~0.5% of the rows become whitespace only."""
    rng = np.random.default_rng(seed)
    out = list(strs)
    kind = rng.random(len(out))
    for i in np.nonzero(kind < 0.10)[0].tolist():
        if out[i] is None:
            continue
        words = out[i].split(" ")
        codes = rng.integers(0, 40, len(words) + 2).tolist()
        seps = [_IN_TOKEN[c] if c < 2 else _WS_RUNS[c % len(_WS_RUNS)] for c in codes[1:-1]]
        row = words[0] + "".join(sep + w for sep, w in zip(seps, words[1:]))
        lead = _WS_RUNS[codes[0] % len(_WS_RUNS)] if codes[0] < 10 else ""
        trail = _WS_RUNS[codes[-1] % len(_WS_RUNS)] if codes[-1] < 10 else ""
        out[i] = lead + row + trail
    for i in np.nonzero((kind >= 0.10) & (kind < 0.105))[0].tolist():
        out[i] = "".join(_WS_RUNS[c] for c in rng.integers(0, len(_WS_RUNS), 3).tolist())
    return out


#: str.split's whitespace made the split's: code points <= 0x20 become a
#: space, and the other str.isspace chars (all below 0x3001) private-use
#: chars, each mapped back after the split
_WS_TABLE = {c: 0x20 for c in range(0x21)}
_WS_TABLE.update((c, 0xE000 + c) for c in range(0x21, 0x3001) if chr(c).isspace())
_WS_BACK = {v: k for k, v in _WS_TABLE.items() if v != 0x20}
#: the code points <= 0x20 that str.split does not split on
_NOT_PY_WS = re.compile("[\x00-\x08\x0e-\x1b]")


def ws_split(s, n, right=False):
    """The whitespace split's oracle: words are runs of code points above
    0x20 (not str.isspace: \\xa0 and \\u3000 stay inside, \\x00-\\x1f split);
    a row without a word gives [""]; with n > 0 at most n splits, the last
    token (from the right, the first) keeping the rest of the row.  It is
    str.split / str.rsplit on the row with that whitespace."""
    if s is None:
        return None
    plain = s.isascii() and not _NOT_PY_WS.search(s)
    t = s if plain else s.translate(_WS_TABLE)
    parts = (t.rsplit if right else t.split)(None, n if n > 0 else -1)
    if not parts:
        return [""]
    if 0 < n < len(parts):  # the limit reached: the rest of the row, verbatim
        if right:
            parts[0] = s[: len(parts[0])]
        else:
            parts[-1] = s[len(s) - len(parts[-1]):]
    return parts if s.isascii() else [p.translate(_WS_BACK) for p in parts]


def levenshtein_batch(pairs):
    """Levenshtein distances of (a, b) string pairs: the textbook DP, one
    cell (i, j) at a time over the whole batch with numpy."""
    la = np.array([len(a) for a, _ in pairs])
    lb = np.array([len(b) for _, b in pairs])
    A = np.full((len(pairs), max(int(la.max(initial=0)), 1)), -1, np.int64)
    B = np.full((len(pairs), max(int(lb.max(initial=0)), 1)), -2, np.int64)
    for r, (a, b) in enumerate(pairs):
        A[r, : len(a)] = [ord(c) for c in a]
        B[r, : len(b)] = [ord(c) for c in b]
    prev = np.tile(np.arange(B.shape[1] + 1), (len(pairs), 1))
    rows = np.arange(len(pairs))
    res = lb.copy()  # an empty a
    for i in range(1, int(la.max(initial=0)) + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = i
        for j in range(1, B.shape[1] + 1):
            cur[:, j] = np.minimum(np.minimum(prev[:, j], cur[:, j - 1]) + 1,
                                   prev[:, j - 1] + (A[:, i - 1] != B[:, j - 1]))
        done = la == i
        res[done] = cur[rows[done], lb[done]]
        prev = cur
    return res.tolist()


def porter_measure(word: str, vowels: str = "aeiou", y: str = "y") -> int:
    """The Porter measure m of a word: its vowel-consonant sequences, y a
    consonant at the start and after a vowel, a vowel after a consonant."""
    cons = []
    for k, ch in enumerate(word):
        cons.append(not (k and cons[-1]) if ch == y and ch not in vowels else ch not in vowels)
    return sum(cons[k] and not cons[k - 1] for k in range(1, len(cons)))


def _records_host(recs):
    return [None if r is None else r.to_host() for r in recs]


def _run_text(torch, strs):
    """The text path through the facades: the whitespace and right-to-left
    splits, partition and rpartition, and every nvtext op; returns (host
    results, per-op seconds, per-op peak device memory).  Each record op's
    per-row nvstrings are read back at once (`<op> to_host`)."""
    from custrings_tpu_torch import nvstrings, nvtext

    times, peaks, out = {}, {}, {}
    step = _stepper(torch, times, peaks)
    s = step("to_device", lambda: nvstrings.to_device(strs, device="cuda"))
    tg = nvstrings.to_device(list(TEXT_TARGETS), device="cuda")
    rt = nvstrings.to_device([a for a, _ in TEXT_REPLACE], device="cuda")
    rr = nvstrings.to_device([b for _, b in TEXT_REPLACE], device="cuda")
    records = [("split_record(None)", lambda: s.split_record(None)),
               ("split_record(None, 2)", lambda: s.split_record(None, 2)),
               ("rsplit_record(None, 2)", lambda: s.rsplit_record(None, 2)),
               ('rsplit_record(" ", 1)', lambda: s.rsplit_record(" ", 1)),
               ('partition(" ")', lambda: s.partition(" ")),
               ('rpartition("#")', lambda: s.rpartition("#"))]
    for name, fn in records:
        recs = step(name, fn)
        out[name] = step(f"{name} to_host", _records_host, recs)
        del recs
    toks = step("tokenize", lambda: nvtext.tokenize(s))
    out["tokenize"] = step("tokenize to_host", toks.to_host)
    del toks
    out["token_count"] = step("token_count", lambda: nvtext.token_count(s))
    vocab = step("unique_tokens", lambda: nvtext.unique_tokens(s))
    out["unique_tokens"] = step("unique_tokens to_host", vocab.to_host)
    for name in ("tokens_counts", "contains_strings", "strings_counts"):
        out[name] = step(name, getattr(nvtext, name), s, tg)
    out["normalize_spaces"] = step("normalize_spaces", lambda: nvtext.normalize_spaces(s)).to_host()
    out["replace_tokens"] = step("replace_tokens", lambda: nvtext.replace_tokens(s, rt, rr)).to_host()
    head = nvstrings.to_device(strs[:NGRAM_ROWS], device="cuda")
    grams = step("ngrams", lambda: nvtext.ngrams(nvtext.tokenize(head), 2))
    out["ngrams"] = grams.to_host()
    del head, grams
    out["edit_distance"] = step("edit_distance", lambda: nvtext.edit_distance(s, DISTANCE_TARGET))
    upper = step("replace THE", lambda: s.replace("the", "THE", regex=False))
    out["edit_distance pairwise"] = step("edit_distance pairwise", lambda: nvtext.edit_distance(s, upper))
    out["porter_stemmer_measure"] = step("porter_stemmer_measure",
                                         lambda: nvtext.porter_stemmer_measure(vocab))
    return out, times, peaks


def _check_text(strs, res):
    """Mismatches of each text op against its Python oracle: every row, and
    TEXT_SAMPLE seeded rows (vocabulary words for the Porter measure) for
    the distances and the Porter measure."""
    words = [ws_split(s, -1) for s in strs]
    space_toks = [None if s is None else [t for t in s.split(" ") if t] for s in strs]
    bad = {
        "split_record(None)": _mismatches(res["split_record(None)"], words),
        "split_record(None, 2)": _mismatches(res["split_record(None, 2)"], [ws_split(s, 2) for s in strs]),
        "rsplit_record(None, 2)": _mismatches(res["rsplit_record(None, 2)"],
                                              [ws_split(s, 2, True) for s in strs]),
        'rsplit_record(" ", 1)': _mismatches(res['rsplit_record(" ", 1)'],
                                             [None if s is None else s.rsplit(" ", 1) for s in strs]),
        'partition(" ")': _mismatches(res['partition(" ")'],
                                      [[None] * 3 if s is None else list(s.partition(" ")) for s in strs]),
        'rpartition("#")': _mismatches(res['rpartition("#")'],
                                       [[None] * 3 if s is None else list(s.rpartition("#")) for s in strs]),
        "tokenize": _mismatches(res["tokenize"], [t for w in words if w for t in w if t]),
        "token_count": _mismatches(res["token_count"], [0 if t is None else len(t) for t in space_toks]),
        "normalize_spaces": _mismatches(res["normalize_spaces"],
                                        [None if w is None else " ".join(w) for w in words]),
    }
    vocab = sorted({t for ts in space_toks if ts for t in ts})
    bad["unique_tokens"] = _mismatches(res["unique_tokens"], vocab)
    n, k = len(strs), len(TEXT_TARGETS)
    # tokens equal to each target: the tokens' target ids, counted by row
    tid = {t: i for i, t in enumerate(TEXT_TARGETS)}
    lens = np.fromiter((0 if ts is None else len(ts) for ts in space_toks), np.int64, n)
    ids = np.fromiter((tid.get(t, k) for ts in space_toks if ts for t in ts), np.int64, int(lens.sum()))
    tc = np.bincount(np.repeat(np.arange(n), lens) * (k + 1) + ids, minlength=n * (k + 1))
    bad["tokens_counts"] = _mismatches(res["tokens_counts"], tc.reshape(n, k + 1)[:, :k].tolist())
    # occurrences of each target, overlapping ones included: str.count
    # finds them all unless the target overlaps itself (has a border);
    # then they are found in the rows joined by a char no target holds
    big = "\uffff".join("" if s is None else s for s in strs)
    starts = np.cumsum([0] + [1 + (0 if s is None else len(s)) for s in strs[:-1]])

    def occurrences(t):
        if not any(t[:j] == t[-j:] for j in range(1, len(t))):
            return [0 if s is None else s.count(t) for s in strs]
        at, i = [], big.find(t)
        while i >= 0:
            at.append(i)
            i = big.find(t, i + 1)
        return np.bincount(np.searchsorted(starts, at, side="right") - 1, minlength=n).tolist()

    sc = np.array([occurrences(t) for t in TEXT_TARGETS], np.int64).T
    bad["strings_counts"] = _mismatches(res["strings_counts"], sc.tolist())
    bad["contains_strings"] = _mismatches(res["contains_strings"], (sc > 0).tolist())
    # a target bounded by whitespace or the row's ends is a whole token
    rep = dict(TEXT_REPLACE)
    whole = re.compile(r"(?<![^\x00-\x20])(?:" + "|".join(map(re.escape, rep)) + r")(?![^\x00-\x20])")
    bad["replace_tokens"] = _mismatches(res["replace_tokens"], [
        None if s is None else whole.sub(lambda m: rep[m.group(0)], s) for s in strs])
    head = [t for w in words[:NGRAM_ROWS] if w for t in w if t]
    bad["ngrams"] = _mismatches(res["ngrams"], [a + "_" + b for a, b in zip(head, head[1:])])
    rng = np.random.default_rng(9)
    rows = sorted(rng.choice(len(strs), TEXT_SAMPLE, replace=False).tolist())
    live = [r for r in rows if strs[r] is not None]
    want = dict(zip(live, levenshtein_batch([(strs[r], DISTANCE_TARGET) for r in live])))
    bad["edit_distance"] = _mismatches([res["edit_distance"][r] for r in rows], [want.get(r, 0) for r in rows])
    want = dict(zip(live, levenshtein_batch([(strs[r], strs[r].replace("the", "THE")) for r in live])))
    bad["edit_distance pairwise"] = _mismatches([res["edit_distance pairwise"][r] for r in rows],
                                                [want.get(r, 0) for r in rows])
    picks = sorted(rng.choice(len(vocab), min(TEXT_SAMPLE, len(vocab)), replace=False).tolist())
    bad["porter_stemmer_measure"] = _mismatches([res["porter_stemmer_measure"][p] for p in picks],
                                                [porter_measure(vocab[p]) for p in picks])
    return bad, sum(len(w) for w in words if w and w[0]), len(vocab)


#: the clean phase's edge tokens: multi-char casings (ß, ŉ, ΐ), Greek
#: sigmas, 4-byte UTF-8, NUL, whitespace, signs for zfill, casings that
#: shrink (İ, ẞ)
CLEAN_EDGES = ("ß", "ŉ", "ΐ", "Σ", "ς", "ΣΑΣ", "straße", "ŉo", "😀", "x😀y", "🔥🔥", "\x00", "a\x00b",
               " ", "\t", "\n", "+12", "-", "-7", "+x", "İ", "ẞ", "ÀÉÎ", "õü", "RT", "the", "!", "m")
CLEAN_EDGE_ROWS = 4096
CLEAN_TRANSLATE = {"a": "4", "e": None, "é": "e", "😀": None, "!": "¡", "t": "T"}
CLEAN_TARGETS = ("the", "a", "#", "é")
CLEAN_WIDTH = 40


def make_clean_rows(strs, seed: int = 5):
    """strs and CLEAN_EDGE_ROWS seeded rows of 1-4 edge tokens joined by
    spaces, a third of them with leading or trailing " \\n\\t" runs, and a
    few empty, whitespace-only and null rows."""
    rng = np.random.default_rng(seed)
    ws = (" ", "\n", "\t", "  \t", "\n\n ")
    out = []
    for _ in range(CLEAN_EDGE_ROWS):
        k = rng.random()
        if k < 0.02:
            out.append(None)
        elif k < 0.04:
            out.append("")
        elif k < 0.08:
            out.append("".join(ws[i] for i in rng.integers(0, len(ws), 2).tolist()))
        else:
            toks = [CLEAN_EDGES[i] for i in rng.integers(0, len(CLEAN_EDGES), rng.integers(1, 5)).tolist()]
            row = " ".join(toks)
            if rng.random() < 0.33:
                row = ws[rng.integers(len(ws))] + row + ws[rng.integers(len(ws))]
            out.append(row)
    return list(strs) + out


def _case_tables():
    """(flags, swap) of every BMP code point, built as the 16-bit
    reference table is, from Python's unicodedata: flags as the
    predicates' bits (1 decimal, 2 numeric, 4 digit, 8 alpha, 16 space,
    32 upper, 64 lower), swap the first code point of the opposite case
    (so "ß" -> "S"), or the code point itself."""
    flags, swap = [0] * 65536, list(range(65536))
    for cp in range(65536):
        ch = chr(cp)
        f = (ch.isdecimal() | ch.isnumeric() << 1 | ch.isdigit() << 2 | ch.isalpha() << 3
             | ch.isspace() << 4 | ch.isupper() << 5 | ch.islower() << 6)
        flags[cp] = f
        other = ch.lower() if f & 32 else ch.upper() if f & 64 else ch
        if other != ch and ord(other[0]) < 65536:
            swap[cp] = ord(other[0])
    return flags, swap


class _CleanOracle:
    """The clean chain's semantics over a list of rows.  The case maps and
    the predicates are the JAX package's, not `str`'s where they differ:
    the case table is BMP-only and 1:1 (first code point of a multi-char
    casing), a code point above it has no flags, islower/isupper hold
    for a non-empty row without a letter of the other case ("123"), and
    title starts a word after any char that is not alpha.  An ASCII row
    takes the `str` method, which agrees there; the others go char by
    char through the table."""

    def __init__(self):
        self.flags, swap = _case_tables()
        self.lo = {cp: swap[cp] for cp in range(65536) if self.flags[cp] & 32 and swap[cp] != cp}
        self.up = {cp: swap[cp] for cp in range(65536) if self.flags[cp] & 64 and swap[cp] != cp}
        self.sw = {**self.lo, **self.up}

    def _case_row(self, s, kind):
        if kind == "lower":
            return s.translate(self.lo)
        if kind == "upper":
            return s.translate(self.up)
        if kind == "swapcase":
            return s.translate(self.sw)
        if kind == "capitalize":
            return s[:1].translate(self.up) + s[1:].translate(self.lo)
        out, prev_alpha = [], False
        for ch in s:
            cp = ord(ch)
            alpha = cp < 65536 and bool(self.flags[cp] & 8)
            out.append(ch.translate(self.lo if prev_alpha else self.up) if alpha else ch)
            prev_alpha = alpha
        return "".join(out)

    def case(self, strs, kind):
        fast = getattr(str, kind)
        return [None if s is None else fast(s) if s.isascii() else self._case_row(s, kind) for s in strs]

    _PRED = {"isalnum": 15, "isalpha": 8, "isdigit": 4, "isspace": 16, "isdecimal": 1, "isnumeric": 2}

    def _pred_row(self, s):
        """Every predicate of a non-ASCII row from one pass over its chars."""
        fl = [self.flags[o] if o < 65536 else 0 for o in map(ord, s)]
        out = {k: bool(fl) and all(f & m for f in fl) for k, m in self._PRED.items()}
        for kind, good in (("islower", 64), ("isupper", 32)):
            out[kind] = bool(fl) and not any(f & 8 and not f & good for f in fl)
        return out

    def preds(self, strs):
        """{predicate: per-row values} for CLEAN_PREDICATES."""
        slow = {i: self._pred_row(s) for i, s in enumerate(strs) if s is not None and not s.isascii()}
        out = {"is_empty": [None if s is None else s == "" for s in strs]}
        for kind in CLEAN_PREDICATES:
            if kind == "is_empty":
                continue
            if kind in ("islower", "isupper"):
                to = str.lower if kind == "islower" else str.upper
                fast = lambda s: s != "" and to(s) == s  # noqa: E731
            else:
                fast = getattr(str, kind)
            out[kind] = [None if s is None else slow[i][kind] if i in slow else fast(s)
                         for i, s in enumerate(strs)]
        return out


_WRAP_CTRL = re.compile("[\x00-\x1f]")


def wrap_py(s, width: int):
    """The greedy wrap: every char <= ' ' becomes ' '; walking the chars,
    once the current line reaches `width` chars and has seen a space since
    its last break, that space becomes '\n' and starts the next line.
    Event by event: a break comes at the later of the line's width and
    the next space, at the last space up to there."""
    if s is None:
        return None
    out = _WRAP_CTRL.sub(" ", s)
    n = len(out)
    if n <= width:
        return out
    pieces, spos, pb, done = [], 0, -1, 0
    while (q := out.find(" ", pb + 1)) >= 0:
        p = max(spos + width, q)
        if p >= n:
            break
        ls = out.rfind(" ", 0, p + 1)
        pieces += [out[done:ls], "\n"]
        spos, pb, done = ls, p, ls + 1
    return "".join(pieces) + out[done:] if pieces else out


def compare_py(s, pat: str):
    """find.cu compare: the first differing byte's difference, -1 where
    the row is a proper prefix of pat, 1 where pat is one of the row."""
    if s is None:
        return None
    a, b = s.encode(), pat.encode()
    for t in range(len(b)):
        if t >= len(a):
            return -1
        if a[t] != b[t]:
            return a[t] - b[t]
    return int(len(a) > len(b))


def order_py(strs, stype: int, asc: bool, nullfirst: bool):
    """Stable order (ties in row order): the null rows as one group first
    or last, the others by byte length (stype 1), UTF-8 bytes (2) or both
    (3), descending when not asc."""
    enc = [None if s is None else s.encode() for s in strs]
    keyf = {1: len, 2: lambda b: b, 3: lambda b: (len(b), b)}[stype]
    live = sorted((i for i, b in enumerate(enc) if b is not None), key=lambda i: keyf(enc[i]),
                  reverse=not asc)
    nulls = [i for i, b in enumerate(enc) if b is None]
    return nulls + live if nullfirst else live + nulls


CLEAN_SORTS = ((1, True, True), (2, True, True), (3, True, True),
               (1, False, False), (2, False, False), (3, False, False))
CLEAN_PREDICATES = ("isalnum", "isalpha", "isdigit", "isspace", "isdecimal", "isnumeric",
                    "islower", "isupper", "is_empty")


def _clean_inputs(n: int, seed: int = 6):
    """The per-row find_from starts and the scatter indexes, seeded."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 12, n).tolist()
    idx = rng.choice(n, size=min(1000, n), replace=False)
    idx = [int(i) - n if k % 3 == 0 else int(i) for k, i in enumerate(idx.tolist())]
    return starts, idx


def _run_clean(torch, strs, device="cuda"):
    """The cleanup chain through the facade; returns (host results,
    per-op seconds, per-op peak device memory).  An op returning strings
    is read back at once and its column freed.  The CPU tests run it with
    device="cpu"."""
    from custrings_tpu_torch import nvstrings

    times, peaks, out = {}, {}, {}
    step = _stepper(torch, times, peaks, cuda=device == "cuda")
    n = len(strs)
    starts, idx = _clean_inputs(n)
    s = step("to_device", lambda: nvstrings.to_device(strs, device=device))
    st = step("strip", s.strip)
    out["strip"] = st.to_host()

    def host(name, fn):
        col = step(name, fn)
        out[name] = col.to_host()

    for kind in ("lower", "upper", "title", "capitalize", "swapcase"):
        host(kind, getattr(st, kind))
    host("translate", lambda: s.translate(CLEAN_TRANSLATE))
    host("slice(2, 40, 3)", lambda: s.slice(2, 40, 3))
    host("get(0)", lambda: s.get(0))
    host("zfill(12)", lambda: s.zfill(12))
    host('pad(40, "both", "*")', lambda: s.pad(CLEAN_WIDTH, "both", "*"))
    host("wrap(40)", lambda: s.wrap(CLEAN_WIDTH))
    out['startswith("RT")'] = step('startswith("RT")', lambda: s.startswith("RT"))
    out['endswith("!")'] = step('endswith("!")', lambda: s.endswith("!"))
    out['find_from("the")'] = step('find_from("the")', lambda: s.find_from("the", starts))
    out['compare("m")'] = step('compare("m")', lambda: s.compare("m"))
    out["match_strings"] = step("match_strings", lambda: s.match_strings(st))
    out["find_multiple"] = step("find_multiple", lambda: s.find_multiple(list(CLEAN_TARGETS)))
    out["len"] = step("len", s.len)
    for p in CLEAN_PREDICATES:
        out[p] = step(p, getattr(s, p))
    del st
    host('cat(sep="|", na_rep="-")', lambda: s.cat(s, sep="|", na_rep="-"))
    host('fillna("-")', lambda: s.fillna("-"))
    host('insert(5, "_X_")', lambda: s.insert(5, "_X_"))
    host('slice_replace(2, 6, "##")', lambda: s.slice_replace(2, 6, "##"))
    for stype, asc, nf in CLEAN_SORTS:
        out[f"order{stype, asc, nf}"] = step(f"order{stype, asc, nf}", lambda: s.order(stype, asc, nf))
        host(f"sort{stype, asc, nf}", lambda: s.sort(stype, asc, nf))
    other = nvstrings.to_device(strs[: len(idx)], device=device)
    host("scatter", lambda: s.scatter(other, idx))
    host('scalar_scatter("X")', lambda: s.scalar_scatter("X", idx))
    host("remove_strings", lambda: s.remove_strings(idx))
    host("add_strings", lambda: s.add_strings(other))
    return out, times, peaks


def _check_clean(strs, res):
    """Mismatches of each clean op against its oracle, every row."""
    o = _CleanOracle()
    t_wrap = time.perf_counter()
    want_wrap = [wrap_py(x, CLEAN_WIDTH) for x in strs]
    wrap_s = time.perf_counter() - t_wrap
    stripped = [None if x is None else x.strip(" \n\t") for x in strs]
    starts, idx = _clean_inputs(len(strs))

    def translated(x):
        # CLEAN_TRANSLATE's keys are single chars and no value holds a
        # later key, so its replaces in turn are str.translate with it
        for k, v in CLEAN_TRANSLATE.items():
            x = x.replace(k, v or "")
        return x

    def center(x):
        p = max(CLEAN_WIDTH - len(x), 0)
        return "*" * (p // 2) + x + "*" * (p - p // 2)

    def each(fn):
        return [None if x is None else fn(x) for x in strs]

    bad = {
        "strip": _mismatches(res["strip"], stripped),
        "translate": _mismatches(res["translate"], each(translated)),
        "slice(2, 40, 3)": _mismatches(res["slice(2, 40, 3)"], each(lambda x: x[2:40:3])),
        "get(0)": _mismatches(res["get(0)"], each(lambda x: x[:1])),
        "zfill(12)": _mismatches(res["zfill(12)"], each(lambda x: x.zfill(12))),
        'pad(40, "both", "*")': _mismatches(res['pad(40, "both", "*")'], each(center)),
        "wrap(40)": _mismatches(res["wrap(40)"], want_wrap),
        'startswith("RT")': _mismatches(res['startswith("RT")'], each(lambda x: x.startswith("RT"))),
        'endswith("!")': _mismatches(res['endswith("!")'], each(lambda x: x.endswith("!"))),
        'find_from("the")': _mismatches(res['find_from("the")'], [
            None if x is None else x.find("the", a) for x, a in zip(strs, starts)]),
        'compare("m")': _mismatches(res['compare("m")'], [compare_py(x, "m") for x in strs]),
        "match_strings": _mismatches(res["match_strings"], [a == b for a, b in zip(strs, stripped)]),
        "find_multiple": _mismatches(res["find_multiple"], [
            [None] * len(CLEAN_TARGETS) if x is None else [x.find(t) for t in CLEAN_TARGETS] for x in strs]),
        "len": _mismatches(res["len"], each(len)),
        'cat(sep="|", na_rep="-")': _mismatches(res['cat(sep="|", na_rep="-")'], [
            ("-" if x is None else x) + "|" + ("-" if x is None else x) for x in strs]),
        'fillna("-")': _mismatches(res['fillna("-")'], ["-" if x is None else x for x in strs]),
        'insert(5, "_X_")': _mismatches(res['insert(5, "_X_")'], each(lambda x: x[:5] + "_X_" + x[5:])),
        'slice_replace(2, 6, "##")': _mismatches(res['slice_replace(2, 6, "##")'],
                                                  each(lambda x: x[:2] + "##" + x[6:])),
    }
    for kind in ("lower", "upper", "title", "capitalize", "swapcase"):
        bad[kind] = _mismatches(res[kind], o.case(stripped, kind))
    for p, want in o.preds(strs).items():
        bad[p] = _mismatches(res[p], want)
    for key in CLEAN_SORTS:
        want = order_py(strs, *key)
        bad[f"order{key}"] = _mismatches(res[f"order{key}"], want)
        bad[f"sort{key}"] = _mismatches(res[f"sort{key}"], [strs[i] for i in want])
    n, other = len(strs), strs[: len(idx)]
    scattered, single = list(strs), list(strs)
    for k, i in enumerate(idx):
        scattered[i] = other[k]
        single[i] = "X"
    drop = {i % n for i in idx}
    bad["scatter"] = _mismatches(res["scatter"], scattered)
    bad['scalar_scatter("X")'] = _mismatches(res['scalar_scatter("X")'], single)
    bad["remove_strings"] = _mismatches(res["remove_strings"], [x for i, x in enumerate(strs) if i not in drop])
    bad["add_strings"] = _mismatches(res["add_strings"], list(strs) + other)
    return bad, wrap_s


def _clean_kernel_shapes(torch, strs, device="cuda"):
    """K4e, K1b and K1 at the clean path's own calls, captured by wrapping
    the names their callers look up, each with its own bound: charwise's
    byte expansion of lower() (the codepoints to the byte capacity, with
    placed; K4e), order()'s key words (K1b), compare()'s view of the
    rows' first bytes (K1).  Returns [(name, source, replaces, shapes)];
    the CPU tests run it with device="cpu"."""
    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import array, case, find, layout, route, shift_compact, window

    col = column.from_host_strings(strs, device)
    with _Calls((shift_compact, "expand_to")) as k4e:
        case.lower(col)
    with _Calls((array, "ragged_gather_words")) as k1b:
        array.order(col, 2)
    with _Calls((layout, "ragged_gather")) as k1:
        find.compare(col, "m")
    if len(k4e.calls) != 1 or len(k1b.calls) != 1 or len(k1.calls) != 1:
        raise AssertionError(f"clean path calls not captured: K4e {len(k4e.calls)}, K1b {len(k1b.calls)}, "
                             f"K1 {len(k1.calls)} (want one each)")

    def expand(live, dist, planes, out_cap, want=True):
        return (f"i32[{live.shape[0]}] -> [{out_cap}] with placed, lower()'s charwise bytes",
                lambda: _expanded(route.expand_stream(live, dist, planes, out_cap, want)),
                lambda: _expanded(route._expand_plain(live.bool(), dist.to(torch.int32), planes, out_cap, want)),
                {"bound": _expand_bound(live, planes, out_cap, want)})

    def words(data, st, w):
        rows, wq = st.shape[0], -(-w // 4)
        return (f"i32[{rows},{wq}] order()'s key words, width {w}",
                lambda: window.ragged_gather_words(data, st, w),
                lambda: _chunked(torch, lambda i, j: window._words_plain(data, st[i:j], w), rows, 4 * wq),
                {"bound": _words_bound(torch, data, st, w)})

    def view(data, st, w, lens):
        return (f"u8[{st.shape[0]},{w}] compare()'s view, masked at the lengths",
                lambda: window.ragged_gather(data, st, w, lens),
                lambda: window._gather_plain(data, st, w, lens),
                {"bound": _window_bound(lens, w, 1)})

    return [("route_expand", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:448", [expand(*k4e.calls[0][1])]),
            ("window_words", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170", [words(*k1b.calls[0][1])]),
            ("window_bytes", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170", [view(*k1.calls[0][1])])]


# ---------------------------------------------------------------- convert

CONVERT_COLUMNS = ("int", "float", "hex", "ip", "ts", "ts_ms", "bool", "url")
#: from_csv's flags for each column.  The CSV dialect has one blank
#: field, null or (CSV_NULL_IS_EMPTY, 8) empty, so each column comes back
#: with ~2% of one of the two; the hex column comes back sorted by name
#: (CSV_SORT_NAME, 2: array.sort on K1b's key words)
CONVERT_FLAGS = {"int": 0, "float": 8, "hex": 2, "ip": 0, "ts": 0, "ts_ms": 8, "bool": 8, "url": 0}
TS_MS_FORMAT = "%Y-%m-%d %H:%M:%S.%f %Z"
TS_MS_OUT = "%Y-%m-%d %H:%M:%S.%f"
CONVERT_EDGE_ROWS = 4096
_INT_EDGES = ("9223372036854775807", "-9223372036854775808", "9223372036854775808", "-9223372036854775809",
              "18446744073709551616", "+0", "-0", "0", "+", "-", "00000000000000000000123", "-000")
_INT_SUFFIX = ("ab", "x", ".5", "e3", " 9", "-1", "+", "abc", "12ab")
_INT_PREFIX = ("a", " ", "--", "+-", "x", ".", "-+")
_FLOAT_SHORT = (".5", "-.02", "3.", "-0", "-0.0", "0.0", "+.5", "1.", "00012.50")
_FLOAT_SPECIAL = ("nan", "NaN", "inf", "-inf", "Inf", "-Inf", "infinity", "+inf", "nan(0)", "-nan", "INF")
_FLOAT_JUNK = ("1.2.3", "abc", "1e", "e5", "--1", "1e+", "12x", "-e5", "+.e3", "1e5x3", "0e400", "1e-400",
               "1" + "0" * 30, "0." + "0" * 25 + "1", "12345678901234567890123", "9.99e308", "4.9e-324",
               "2.2250738585072014e-308", "1e-310", "1.5e-45", "3.4e38", "1e2147483648", "1E+05", ".", "-", "e")
_HEX_JUNK = ("zz12", "12g3", "-1f", " ff", "x1", "1x2", "0xg", "0x", "X", "0x0x1", "fffffffffffffffff", "-")
_BOOL_WORDS = ("true", "TRUE", "False ", "yes", "1", "0", "Truex", "Tru", "T", " True")
_TS_SUFFIX = ("UTC", "utc", "Utc", "uTC", "GMT", "EST", "UT")
_URL_PIECES = ("%4", "%%41", "%zz", "%C3%A9", "%F0%9F%98%80", "%2", "%", "%%", "a%2Fb", "%25", "%4a%4A",
               "%FF", "%C3", "100%", "%0", "%20%20", "%e6%97%a5", "x%", "%%%", "%7E", "%2g", " ", "é", "+")


def _blank(rng, rows, p: float = 0.01):
    """~p of the rows null and ~p empty, in place."""
    k = rng.random(len(rows))
    for i in np.nonzero(k < 2 * p)[0].tolist():
        rows[i] = None if k[i] < p else ""
    return rows


def _int_rows(rng, n):
    nd = rng.integers(1, 19, n)
    mag = rng.integers(0, 10**18, n, dtype=np.int64) // np.power(10, 18 - nd).astype(np.int64)
    rows = [("-" if s else "") + str(m) for s, m in zip((rng.random(n) < 0.4).tolist(), mag.tolist())]
    kind, pick = rng.random(n), rng.integers(0, 1 << 30, n)
    for i in np.nonzero(kind < 0.19)[0].tolist():
        k, p, r = kind[i], int(pick[i]), rows[i]
        if k < 0.05:
            rows[i] = "+" + r.lstrip("-")
        elif k < 0.10:
            rows[i] = ("-" if r[0] == "-" else "") + "0" * (1 + p % 4) + r.lstrip("-")
        elif k < 0.12:
            rows[i] = _INT_EDGES[p % len(_INT_EDGES)]
        elif k < 0.14:
            rows[i] = ("-" if p & 1 else "") + str(10**18 + p) + str(p)[: 1 + p % 6]
        elif k < 0.17:
            rows[i] = r + _INT_SUFFIX[p % len(_INT_SUFFIX)]
        else:
            rows[i] = _INT_PREFIX[p % len(_INT_PREFIX)] + r
    return rows


def _float_rows(rng, n):
    sign = np.where(rng.random(n) < 0.3, -1.0, 1.0)
    with np.errstate(over="ignore"):
        vals = (sign * (rng.random(n) * 9 + 1) * np.power(10.0, rng.integers(-320, 309, n))).tolist()
    kind, pick = rng.random(n).tolist(), rng.integers(0, 1 << 30, n).tolist()
    short = rng.normal(0, 1000, n)
    rows = []
    for i, v in enumerate(vals):
        k, p = kind[i], pick[i]
        if k < 0.40:
            rows.append(f"{v:.17g}")
        elif k < 0.65:
            rows.append(f"{v:e}" if p & 1 else f"{v:E}")
        elif k < 0.77:
            rows.append(f"{short[i]:.{p % 5}f}")
        elif k < 0.80:
            rows.append(_FLOAT_SHORT[p % len(_FLOAT_SHORT)])
        elif k < 0.88:
            rows.append(str(p - (1 << 29)))
        elif k < 0.93:
            rows.append(_FLOAT_SPECIAL[p % len(_FLOAT_SPECIAL)])
        else:
            rows.append(_FLOAT_JUNK[p % len(_FLOAT_JUNK)])
    return rows


def _hex_rows(rng, n):
    nd = rng.integers(1, 17, n).tolist()
    vals = rng.integers(0, 1 << 63, n, dtype=np.int64).tolist()
    kind, pick = rng.random(n), rng.integers(0, 1 << 30, n)
    rows = []
    for i in range(n):
        k, p = kind[i], int(pick[i])
        h = format(vals[i], "016x")[16 - nd[i]:]
        pre = ("0x", "0X", "", "", "")[p % 5]
        if k > 0.97:
            rows.append(_HEX_JUNK[p % len(_HEX_JUNK)])
        elif k > 0.95:
            rows.append(pre + format(vals[i], "x") + format(p, "x"))  # past 16 digits: wraps
        else:
            rows.append(pre + (h.upper() if k < 0.40 else h))
    return rows


def _ts_strings(rng, n, unit: str):
    lo = calendar.timegm((1900, 1, 1, 0, 0, 0))
    hi = calendar.timegm((2101, 1, 1, 0, 0, 0))
    k = 1000 if unit == "ms" else 1
    t = rng.integers(lo * k, hi * k, n).astype(f"datetime64[{unit}]")
    return np.datetime_as_string(t).tolist()


def _cut_some(rng, rows, p: float):
    """~p of the rows cut short at a random length (too short to parse)."""
    k = rng.random(len(rows))
    for i in np.nonzero(k < p)[0].tolist():
        rows[i] = rows[i][: int(k[i] / p * (len(rows[i]) - 1))]
    return rows


def make_convert_rows(n: int, seed: int = 7, tweets=None):
    """The conversion path's table: {column: n rows} (CONVERT_COLUMNS),
    each with ~1% null and ~1% empty rows.  int: signed, with a leading +,
    leading zeros, INT64_MIN/MAX, overflowing values and junk before or
    after; float: %.17g and %e forms with exponents -320..308, short
    decimals (.5, -.02), integers, nan/inf spellings and junk; hex: 1-16
    digits, either case, with or without 0x/0X, some past 16 digits,
    junk; ip: dotted quads; ts: DEFAULT_FORMAT over the years 1900-2100,
    some cut short; ts_ms: TS_MS_FORMAT with UTC in any case, other zones
    and cut rows; bool: True, False and other words; url: `tweets`
    (by default make_corpus(n, seed=0)) with CONVERT_EDGE_ROWS of them (a quarter of a smaller table)
    replaced by % edge rows (an escape cut at the row end, %%41, %zz,
    multi-byte escapes, bytes that decode to invalid UTF-8)."""
    rng = np.random.default_rng(seed)
    table = {"int": _int_rows(rng, n), "float": _float_rows(rng, n), "hex": _hex_rows(rng, n),
             "ip": [".".join(map(str, q)) for q in rng.integers(0, 256, (n, 4)).tolist()]}
    sfx = rng.choice(len(_TS_SUFFIX), n, p=[0.5, 0.2, 0.1, 0.05, 0.08, 0.04, 0.03]).tolist()
    table["ts"] = _cut_some(rng, [t + "Z" for t in _ts_strings(rng, n, "s")], 0.015)
    table["ts_ms"] = _cut_some(rng, [t.replace("T", " ") + " " + _TS_SUFFIX[s]
                                     for t, s in zip(_ts_strings(rng, n, "ms"), sfx)], 0.01)
    words = rng.random(n).tolist()
    pick = rng.integers(0, len(_BOOL_WORDS), n).tolist()
    table["bool"] = ["True" if w < 0.45 else "False" if w < 0.85 else _BOOL_WORDS[p] for w, p in zip(words, pick)]
    for name in CONVERT_COLUMNS[:-1]:
        _blank(rng, table[name])
    url = make_corpus(n, seed=0) if tweets is None else list(tweets)
    for i in rng.choice(n, size=min(CONVERT_EDGE_ROWS, n // 4), replace=False).tolist():
        url[i] = "".join(_URL_PIECES[j] for j in rng.integers(0, len(_URL_PIECES), rng.integers(1, 5)).tolist())
    table["url"] = url
    return table


def write_csv(table, path: str) -> int:
    """The table as a CSV file with a header line, in the reference's
    dialect: a field holding a comma or a quote is quoted, its quotes
    doubled (the reader keeps them doubled), a null or empty row is a
    blank field.  Returns the file's bytes."""
    def field(x):
        if not x:
            return ""
        return '"' + x.replace('"', '""') + '"' if "," in x or '"' in x else x

    cols = [[field(x) for x in table[name]] for name in CONVERT_COLUMNS]
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(",".join(CONVERT_COLUMNS) + "\n")
        f.writelines(",".join(row) + "\n" for row in zip(*cols))
    return os.path.getsize(path)


def read_back_py(table):
    """{column: what from_csv must read}: a blank field is None or (with
    CSV_NULL_IS_EMPTY) "", quotes come back doubled, the hex column
    sorted as array.sort(stype 2) sorts (nulls first, then by bytes)."""
    out = {}
    for name in CONVERT_COLUMNS:
        blank = "" if CONVERT_FLAGS[name] & 8 else None
        rows = [blank if not x else x.replace('"', '""') for x in table[name]]
        if CONVERT_FLAGS[name] & 2:
            rows = [rows[i] for i in order_py(rows, 2, True, True)]
        out[name] = rows
    return out


def _wrap(v: int, bits: int) -> int:
    return (v + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))


_INT_HEAD = re.compile(r"([+-]?)([0-9]*)")


def stol_py(s: str) -> int:
    """custr stol: a sign at the first byte, then the digits up to the
    first non-digit, wrapping in int64."""
    m = _INT_HEAD.match(s)
    v = int(m[2] or "0")
    return _wrap(-v if m[1] == "-" else v, 64)


_HEX_WHOLE = re.compile(r"(0[xX])?([0-9a-fA-F]+)")


def htoi_py(s: str) -> int:
    """convert.cu htoi as the JAX package runs it: non-hex bytes before the
    first hex digit and an x/X at byte 0 or 1 are skipped, then hex
    digits up to the first other byte, wrapping in int64."""
    m = _HEX_WHOLE.fullmatch(s)
    if m:
        return _wrap(int(m[2], 16), 64)
    val, done, started = 0, False, False
    for j, c in enumerate(s.encode()):
        hv = int(chr(c), 16) if chr(c) in string.hexdigits else -1
        skip = c in (0x78, 0x58) and j <= 1
        ok = hv >= 0 and not done
        if ok:
            val = _wrap(val * 16 + hv, 64)
        done = done or (hv < 0 and not skip and started)
        started = started or ok or skip
    return val


_FLOAT_HEAD = re.compile(r"([+-]?)([0-9.]*)([eE](.*))?", re.S)
_MAXM = 0x0FFFFFFFFFFFFF


def stod_py(strs):
    """float64[rows]: custr::stod as the JAX package computes it, in numpy
    (0 for null rows): a sign at the first byte, a mantissa of digits and
    dots whose digits stop accumulating above 0x0FFFFFFFFFFFFF (a digit
    dropped before the first dot adds 1 to the exponent, one kept after
    it takes 1 away), then after an e/E an optional sign and every later
    digit of the row (int32 arithmetic), and sign * digits * 10.0**exp;
    rows starting nan/NaN, inf/Inf, -inf/-Inf are the specials."""
    sign, digits, exp, special = stod_parts(strs)
    with np.errstate(over="ignore", invalid="ignore"):
        val = sign * digits * np.power(10.0, exp)
    for i, v in special.items():
        val[i] = v
    return val


def stod_parts(strs):
    """stod_py's (sign, digits, exp) float64[rows] and its {row: special
    value}."""
    n = len(strs)
    sign, digits, exp = np.ones(n), np.zeros(n), np.zeros(n)
    special = {}
    for i, s in enumerate(strs):
        if not s:
            continue
        if s[:3] in ("nan", "NaN"):
            special[i] = math.nan
        elif s[:3] in ("inf", "Inf"):
            special[i] = math.inf
        elif s[:4] in ("-inf", "-Inf"):
            special[i] = -math.inf
        m = _FLOAT_HEAD.match(s)
        if m[1] == "-":
            sign[i] = -1.0
        mant = m[2]
        ds = mant.replace(".", "")
        if len(ds) <= 15:  # below _MAXM whatever the digits
            dot = mant.find(".")
            d, off = int(ds or "0"), (dot - len(ds) if dot >= 0 else 0)
        else:
            d, off, dec = 0, 0, False
            for ch in mant:
                if ch == ".":
                    dec = True
                elif d * 10 + int(ch) <= _MAXM:
                    d, off = d * 10 + int(ch), off - dec
                else:
                    off += not dec
        e10 = 0
        if m[3] is not None:
            rest = m[4]
            e10 = _wrap(int("".join(ch for ch in rest if "0" <= ch <= "9") or "0"), 32)
            e10 = _wrap(-e10 if rest[:1] == "-" else e10, 32)
        digits[i] = d
        exp[i] = _wrap(off + e10, 32)
    return sign, digits, exp, special


def _ulps(got, want):
    """Per row, the float gap in units in the last place; NaNs, infinities
    and signs must agree exactly (else the gap is 2^62)."""
    a, b = np.asarray(got), np.asarray(want)
    bits = np.int64 if a.dtype == np.float64 else np.int32
    gap = np.abs(a.view(bits).astype(np.int64) - b.view(bits).astype(np.int64))
    gap = np.where(np.isnan(a) & np.isnan(b), 0, gap)
    same = (np.isnan(a) == np.isnan(b)) & (np.isinf(a) == np.isinf(b)) & (np.signbit(a) == np.signbit(b))
    return np.where(same, gap, 1 << 62)


def _parts(vals, dtype):
    """A facade list (None for null rows) as (values, null mask), the
    formatters' `values` and `nulls`."""
    return (np.asarray([0 if v is None else v for v in vals], dtype),
            np.asarray([v is None for v in vals], np.bool_))


_EPOCH = datetime.datetime(1970, 1, 1)


def ts_parse_py(s, ms: bool) -> int:
    """A DEFAULT_FORMAT row in seconds, or a TS_MS_FORMAT row in
    milliseconds whose zone is UTC in any case, by Python's calendar; 0
    for a row too short or in another zone."""
    if not s or len(s) < (27 if ms else 19):
        return 0
    t = calendar.timegm((int(s[0:4]), int(s[5:7]), int(s[8:10]), int(s[11:13]), int(s[14:16]), int(s[17:19])))
    if not ms:
        return t
    return t * 1000 + int(s[20:23]) if s[24:27].upper() == "UTC" else 0


def ts_format_py(v: int, ms: bool) -> str:
    """v seconds (DEFAULT_FORMAT) or milliseconds (TS_MS_OUT) after the
    epoch, by Python's datetime."""
    d = _EPOCH + (datetime.timedelta(milliseconds=v) if ms else datetime.timedelta(seconds=v))
    head = f"{d.year:04d}-{d.month:02d}-{d.day:02d}"
    if ms:
        return f"{head} {d.hour:02d}:{d.minute:02d}:{d.second:02d}.{d.microsecond // 1000:03d}"
    return f"{head}T{d.hour:02d}:{d.minute:02d}:{d.second:02d}Z"


def url_decode_py(s: str) -> bytes:
    """url_decode as the JAX package runs it, on the row's UTF-8 bytes: a
    '%' with two more bytes in the row starts an escape, a non-hex digit
    counting as 0 (so "%zz" is 0x00); the two bytes after it are consumed
    whatever they are."""
    b = s.encode()
    if b"%" not in b:
        return b
    out, j = bytearray(), 0
    while j < len(b):
        if b[j] == 0x25 and j + 2 < len(b):
            hv = [int(chr(c), 16) if chr(c) in string.hexdigits else 0 for c in b[j + 1: j + 3]]
            out.append(hv[0] * 16 + hv[1])
            j += 3
        else:
            out.append(b[j])
            j += 1
    return bytes(out)


def row_bytes(buffers, n: int):
    """nvstrings.to_offsets()'s (bytes, offsets, null bitmask) as each
    row's bytes (None for null rows)."""
    data, offs, nulls = buffers
    valid = np.unpackbits(nulls, bitorder="little")[:n].astype(bool)
    buf = data.tobytes()
    return [buf[a:b] if v else None for a, b, v in zip(offs[:-1].tolist(), offs[1:].tolist(), valid.tolist())]


def stats_py(strs):
    """get_info's dict from Python for a column of ASCII rows (where the
    flag table agrees with str's predicates), without device_memory."""
    vl = np.asarray([len(s.encode()) for s in strs if s is not None], np.int32)
    chars = collections.Counter(ch for s in strs if s for ch in s)

    def count(pred):
        return sum(c for ch, c in chars.items() if pred(ch))

    return {
        "total_strings": len(strs), "null_strings": sum(s is None for s in strs),
        "empty_strings": sum(s == "" for s in strs), "unique_strings": len(set(strs)),
        "total_bytes": int(vl.sum()), "total_chars": sum(chars.values()),
        "avg_bytes": float(vl.mean()) if len(vl) else 0.0, "max_bytes": int(vl.max()) if len(vl) else 0,
        "min_bytes": int(vl.min()) if len(vl) else 0,
        "pct95_bytes": float(np.percentile(vl, 95)) if len(vl) else 0.0,
        "whitespace_count": count(str.isspace), "digits_count": count(str.isdigit),
        "alpha_count": count(str.isalpha), "uppercase_count": count(str.isupper),
        "lowercase_count": count(str.islower), "char_histogram": {ord(ch): c for ch, c in chars.items()},
    }


def _run_convert(torch, path, device="cuda"):
    """The conversion path through the facade on the CSV file at `path`:
    from_csv of every column, the parsers, the formatters on the parsed
    values, url_encode, url_decode of its output and of the url column,
    get_info of the int column.  Returns (host results, per-op seconds,
    per-op peak device memory); a column made by an op is read back at
    once.  The CPU tests run it with device="cpu"."""
    from custrings_tpu_torch import nvstrings

    times, peaks, out = {}, {}, {}
    step = _stepper(torch, times, peaks, cuda=device == "cuda")
    c = {}
    for k, name in enumerate(CONVERT_COLUMNS):
        c[name] = step(f"from_csv({name})",
                       lambda k=k, name=name: nvstrings.from_csv(path, k, flags=CONVERT_FLAGS[name], device=device))
        out[f"from_csv({name})"] = c[name].to_host()
    for name, col in (("stoi", "int"), ("stol", "int"), ("htoi", "hex"), ("stof", "float"), ("stod", "float"),
                      ("ip2int", "ip"), ("to_booleans", "bool"), ("timestamp2int", "ts")):
        out[name] = step(name, getattr(c[col], name))
    out["timestamp2int(ms)"] = step("timestamp2int(ms)", lambda: c["ts_ms"].timestamp2int(TS_MS_FORMAT, "ms"))

    def host(name, fn):
        out[name] = step(name, fn).to_host()

    for name, fn, src, dtype in (("itos", nvstrings.itos, "stoi", np.int32),
                                 ("ltos", nvstrings.ltos, "stol", np.int64),
                                 ("ftos", nvstrings.ftos, "stof", np.float32),
                                 ("dtos", nvstrings.dtos, "stod", np.float64),
                                 ("int2ip", nvstrings.int2ip, "ip2int", np.int64),
                                 ("from_booleans", nvstrings.from_booleans, "to_booleans", np.bool_)):
        vals, nulls = _parts(out[src], dtype)
        host(name, lambda fn=fn, vals=vals, nulls=nulls: fn(vals, nulls=nulls, device=device))
    for name, src, units, fmt in (("int2timestamp", "ts", "s", None), ("int2timestamp(ms)", "ts_ms", "ms", TS_MS_OUT)):
        nulls = np.asarray([x is None for x in out[f"from_csv({src})"]], np.bool_)
        vals = out[name.replace("int2timestamp", "timestamp2int")]
        host(name, lambda vals=vals, units=units, fmt=fmt, nulls=nulls:
             nvstrings.int2timestamp(vals, units, fmt, nulls=nulls, device=device))
    enc = step("url_encode", c["url"].url_encode)
    out["url_encode"] = enc.to_host()
    host("url_decode(url_encode)", enc.url_decode)
    del enc
    raw = step("url_decode", c["url"].url_decode)
    out["url_decode"] = row_bytes(raw.to_offsets(), raw.size())
    del raw
    out["get_info(int)"] = step("get_info(int)", c["int"].get_info)
    out["memsize(int)"] = c["int"].memsize()
    return out, times, peaks


def _check_convert(table, res):
    """(mismatches of each convert op against its oracle, every row; the
    largest stod and stof gaps in ulps)."""
    from custrings_tpu_torch.ops.convert import _float_to_string

    want = read_back_py(table)
    bad = {f"from_csv({k})": _mismatches(res[f"from_csv({k})"], v) for k, v in want.items()}

    def each(name, fn):
        return [None if x is None else fn(x) for x in want[name]]

    def formatted(name, fn):
        return [None if v is None else fn(v) for v in res[name]]

    want_stol = each("int", stol_py)
    bad["stol"] = _mismatches(res["stol"], want_stol)
    bad["stoi"] = _mismatches(res["stoi"], [None if v is None else _wrap(v, 32) for v in want_stol])
    bad["htoi"] = _mismatches(res["htoi"], each("hex", htoi_py))
    bad["ip2int"] = _mismatches(res["ip2int"], each("ip", lambda x: int(ipaddress.IPv4Address(x))))
    bad["to_booleans"] = _mismatches(res["to_booleans"], each("bool", lambda x: x == "True"))
    bad["timestamp2int"] = _mismatches(res["timestamp2int"], [ts_parse_py(x, False) for x in want["ts"]])
    bad["timestamp2int(ms)"] = _mismatches(res["timestamp2int(ms)"], [ts_parse_py(x, True) for x in want["ts_ms"]])
    # stod and stof against the numpy formula: within 2 ulp (CUDA
    # documents its double pow to 2 ulp), NaN, the infinities and the
    # sign exact
    null = np.asarray([x is None for x in want["float"]])
    want_d = stod_py(want["float"])
    gaps = {}
    for name, dtype in (("stod", np.float64), ("stof", np.float32)):
        got, nulls = _parts(res[name], dtype)
        with np.errstate(over="ignore"):
            g = np.where(null, 0, _ulps(got, want_d.astype(dtype)))
        gaps[name] = int(g.max()) if len(g) else 0
        bad[name] = int((g > 2).sum()) + int((nulls != null).sum())
    bad["itos"] = _mismatches(res["itos"], formatted("stoi", str))
    bad["ltos"] = _mismatches(res["ltos"], formatted("stol", str))
    bad["ftos"] = _mismatches(res["ftos"], formatted("stof", _float_to_string))
    bad["dtos"] = _mismatches(res["dtos"], formatted("stod", _float_to_string))
    bad["int2ip"] = _mismatches(res["int2ip"], formatted("ip2int", lambda v: str(ipaddress.IPv4Address(v))))
    bad["from_booleans"] = _mismatches(res["from_booleans"], formatted("to_booleans", str))
    for name, src, ms in (("int2timestamp", "ts", False), ("int2timestamp(ms)", "ts_ms", True)):
        parsed = res[name.replace("int2timestamp", "timestamp2int")]
        bad[name] = _mismatches(res[name], [None if x is None else ts_format_py(v, ms)
                                            for x, v in zip(want[src], parsed)])
    url = want["url"]
    bad["url_encode"] = _mismatches(res["url_encode"], [None if x is None else urllib.parse.quote(x, safe="")
                                                        for x in url])
    bad["url_decode(url_encode)"] = _mismatches(res["url_decode(url_encode)"], url)
    bad["url_decode"] = _mismatches(res["url_decode"], [None if x is None else url_decode_py(x) for x in url])
    info = dict(res["get_info(int)"])
    bad["get_info(int)"] = int(info.pop("device_memory") != res["memsize(int)"]) + int(info != stats_py(want["int"]))
    return bad, gaps


def _convert_kernel_shapes(torch, url_strs, float_strs, device="cuda"):
    """K4e, K7 and K1 at the conversion path's own calls, captured by
    wrapping the names their callers look up, each with its own bound:
    url_encode's expansion of the url rows (each byte to its first output
    slot, with placed; K4e), url_decode's compaction of the encoded rows
    (K7, with torch.masked_select's time) and stod's padded view (K1).
    Returns [(name, source, replaces, shapes)]; the CPU tests run it with
    device="cpu"."""
    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import compact, convert, layout, route, shift_compact, urlencode, window

    url = column.from_host_strings(url_strs, device)
    with _Calls((shift_compact, "expand_to")) as k4e:
        enc = urlencode.url_encode(url)
    with _Calls((compact, "compact_bytes")) as k7:
        urlencode.url_decode(enc)
    with _Calls((layout, "ragged_gather")) as k1:
        convert.stod(column.from_host_strings(float_strs, device))
    if len(k4e.calls) != 1 or len(k7.calls) != 1 or len(k1.calls) != 1:
        raise AssertionError(f"convert path calls not captured: K4e {len(k4e.calls)}, K7 {len(k7.calls)}, "
                             f"K1 {len(k1.calls)} (want one each)")
    del url, enc

    def expand(live, dist, planes, out_cap, want):
        return (f"u8[{live.shape[0]}] -> [{out_cap}] with placed, url_encode's bytes",
                lambda: _expanded(route.expand_stream(live, dist, planes, out_cap, want)),
                lambda: _expanded(route._expand_plain(live.bool(), dist.to(torch.int32), planes, out_cap, want)),
                {"bound": _expand_bound(live, planes, out_cap, want)})

    def compacted(data, keep, out_cap):
        return (f"u8[{data.shape[0]}] -> u8[{out_cap}] url_decode's write",
                lambda: compact.compact_bytes(data, keep, out_cap),
                lambda: compact._compact_plain(data, keep.bool(), out_cap),
                {"bound": _compact_bound(torch, keep, out_cap), "library": lambda: torch.masked_select(data, keep)})

    def view(data, st, w, lens):
        return (f"u8[{st.shape[0]},{w}] stod's view, masked at the lengths",
                lambda: window.ragged_gather(data, st, w, lens),
                lambda: window._gather_plain(data, st, w, lens),
                {"bound": _window_bound(lens, w, 1)})

    return [("route_expand", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:448", [expand(*k4e.calls[0][1])]),
            ("compact_bytes", "csrc/compact.cu", "custrings_tpu/ops/pallas_compact.py:184",
             [compacted(*k7.calls[0][1])]),
            ("window_bytes", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170", [view(*k1.calls[0][1])])]


# ---------------------------------------------------------------- category

CATEGORY_KEYS = 50_000
CATEGORY_B_ROWS = 1 << 18
CATEGORY_LOOKUPS = 100
NUMERIC_DTYPES = ("int8", "int32", "int64", "float32", "float64")
_P256 = _cut(" ".join([_PREFIXES[0]] + _PREFIXES * 3), 256)  # starts with _PREFIXES[0]


def _category_keys(rng, n: int):
    """n distinct keys of one to three corpus tokens, ~5% led by a
    non-ASCII token (4-byte UTF-8 among them), and 64 long keys: 32 share
    the 64-byte _PREFIXES[0] and 32 the 256-byte _P256 that starts with
    it (the prefixes themselves among them); shuffled."""
    tok, probs = _tokens()
    longs = [_PREFIXES[0]] + [f"{_PREFIXES[0]} part {i:02d}" for i in range(31)]
    longs += [_P256] + [f"{_P256} part {i:02d}" for i in range(31)]
    seen = dict.fromkeys(longs)
    while len(seen) < n:
        k = rng.integers(1, 4, 4 * n)
        draws = tok[rng.choice(len(tok), (4 * n, 3), p=probs)]
        na = rng.random(4 * n) < 0.05
        lead = rng.integers(0, len(_NONASCII), 4 * n)
        for i in range(4 * n):
            key = " ".join(draws[i, : k[i]])
            seen.setdefault(_NONASCII[lead[i]] + " " + key if na[i] else key)
            if len(seen) == n:
                break
    keys = list(seen)
    return [keys[i] for i in rng.permutation(n)]


def _zipf_rows(rng, keys, n: int):
    """n Zipf draws (s = 1) over the keys, ~1% null and ~1% empty."""
    p = 1.0 / np.arange(1, len(keys) + 1)
    pick = rng.choice(len(keys), n, p=p / p.sum())
    kind = rng.random(n)
    return [None if k < 0.01 else "" if k < 0.02 else keys[i] for i, k in zip(pick.tolist(), kind.tolist())]


def make_category_rows(n: int, seed: int = 8, nkeys: int = CATEGORY_KEYS, b_rows: int = CATEGORY_B_ROWS):
    """(rows a, rows b, the keys): a categorical column of n Zipf draws
    over nkeys distinct keys (_category_keys), and a second of b_rows
    rows drawing from the last half of a's keys and as many new ones."""
    rng = np.random.default_rng(seed)
    keys = _category_keys(rng, nkeys + nkeys // 2)
    return _zipf_rows(rng, keys[:nkeys], n), _zipf_rows(rng, keys[nkeys // 2:], b_rows), keys


_INT_RANGE = {"int8": (-128, 127), "int32": (-(1 << 31), (1 << 31) - 1), "int64": (-(1 << 63), (1 << 63) - 1)}


def _numeric_edges(dtype: str):
    if dtype in _INT_RANGE:
        lo, hi = _INT_RANGE[dtype]
        return np.array([lo, hi, 0, -1, 1, lo + 1, hi - 1], dtype=dtype)
    f = np.finfo(dtype)
    return np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, f.max, -f.max, f.smallest_subnormal,
                     -f.smallest_subnormal, f.tiny], dtype=dtype)


def make_numeric_columns(n: int, seed: int = 9, b_rows: int = CATEGORY_B_ROWS):
    """{dtype: (values a, a's Arrow null bitmask, values b, b's bitmask)}
    for each of NUMERIC_DTYPES: Zipf draws (s = 1) over a pool of ~5,000
    values (every int8), the dtype's edge values (its extremes; NaN,
    -NaN, +-0.0, +-inf, the largest, the smallest subnormal) at ~0.1%
    each, ~1% null; b draws from the pool's last half and as many new
    values."""
    rng = np.random.default_rng(seed)
    out = {}
    for dt in NUMERIC_DTYPES:
        if dt == "int8":
            pool = rng.permutation(np.arange(-128, 128)).astype(dt)
        elif dt in _INT_RANGE:
            span = 1 << (20 if dt == "int32" else 62)
            pool = np.unique(rng.integers(-span, span, 7500)).astype(dt)
            pool = pool[rng.permutation(len(pool))]
        else:
            pool = np.unique(np.round(rng.standard_normal(7500) * 1000, 2).astype(dt))
            pool = pool[rng.permutation(len(pool))]
        m = len(pool) * 2 // 3
        edges = _numeric_edges(dt)
        cols = []
        for vals_pool, rows in ((pool[:m], n), (pool[m // 2:], b_rows)):
            p = 1.0 / np.arange(1, len(vals_pool) + 1)
            vals = vals_pool[rng.choice(len(vals_pool), rows, p=p / p.sum())]
            edge = rng.random(rows) < 0.001 * len(edges)
            vals[edge] = edges[rng.integers(0, len(edges), int(edge.sum()))]
            valid = rng.random(rows) >= 0.01
            cols += [vals, np.packbits(valid, bitorder="little")]
        out[dt] = tuple(cols)
    return out


def _bits_valid(bitmask, n: int):
    return np.unpackbits(bitmask, bitorder="little")[:n].astype(bool)


def _utf8_key(s):
    return (s is not None, b"" if s is None else s.encode("utf-8"))


class _CatOracle:
    """A string category written to the JAX package's semantics: keys in
    keyset order (sorted by UTF-8 bytes, None first, until merge_category
    appends), values int64 (-1 for a removed key)."""

    def __init__(self, keys, values):
        self.keys = list(keys)
        self.values = np.asarray(values, np.int64)
        self.index = {k: i for i, k in enumerate(self.keys)}

    @classmethod
    def encode(cls, rows):
        keys = sorted(set(rows), key=_utf8_key)
        index = {k: i for i, k in enumerate(keys)}
        return cls(keys, np.fromiter((index[r] for r in rows), np.int64, len(rows)))

    def rows(self):
        return [None if v < 0 else self.keys[v] for v in self.values.tolist()]

    def value(self, key):
        return self.index.get(key, -1)

    def bounds(self, key):
        v = self.value(key)
        if v >= 0:
            return (v, v)
        if not hasattr(self, "_sort_keys"):
            self._sort_keys = [_utf8_key(k) for k in self.keys]
        q = _utf8_key(key)
        p = next((i for i, k in enumerate(self._sort_keys) if not k < q), len(self.keys))
        return (p - 1, p)

    def indexes(self, key):
        v = self.value(key)
        return [] if v < 0 else np.nonzero(self.values == v)[0].tolist()

    def remap(self, keys):
        index = {k: i for i, k in enumerate(keys)}
        table = np.array([index.get(k, -1) for k in self.keys] + [-1], np.int64)
        return table[self.values]  # -1 indexes the appended -1

    def with_keys(self, keys):
        return _CatOracle(keys, self.remap(keys))

    def add_keys(self, keys):
        return self.with_keys(sorted(set(self.keys) | set(keys), key=_utf8_key))

    def remove_keys(self, keys):
        drop = set(keys)
        return self.with_keys([k for k in self.keys if k not in drop])

    def remove_unused(self):
        used = set(self.values[self.values >= 0].tolist())
        return self.with_keys([k for i, k in enumerate(self.keys) if i in used])

    def set_keys(self, keys):
        return self.with_keys(sorted(set(keys), key=_utf8_key))

    def merge_and_remap(self, other):
        keys = sorted(set(self.keys) | set(other.keys), key=_utf8_key)
        return _CatOracle(keys, np.concatenate([self.remap(keys), other.remap(keys)]))

    def merge_category(self, other):
        keys = self.keys + [k for k in other.keys if k not in self.index]
        return _CatOracle(keys, np.concatenate([self.values, other.remap(keys)]))


def _num_canon(x, valid: bool):
    """A number's identity as a key: None for null, one NaN (-0.0 and 0.0
    are one dict key already)."""
    if not valid:
        return None
    x = x.item()
    return ("nan",) if x != x else x


class _NumOracle:
    """A numeric category written to the JAX package's semantics with
    numpy: rows ordered by (null first, value, NaN after +inf, -0.0 as
    0.0), stably; a key's value is its first row's in that order, so the
    null key holds the least value under a null."""

    def __init__(self, keys, valid, values):
        self.keys, self.valid = keys, np.asarray(valid, bool)
        self.values = np.asarray(values, np.int64)
        self.index = {}
        for i, (k, ok) in enumerate(zip(keys, self.valid)):
            self.index.setdefault(_num_canon(k, ok), i)

    @classmethod
    def encode(cls, vals, valid):
        n = len(vals)
        if n == 0:
            return cls(vals[:0], valid[:0], [])
        if vals.dtype.kind == "f":
            nan = np.isnan(vals)
            v = np.where(nan, 0, vals)
            order = np.lexsort((np.arange(n), v, nan, valid))
            same = (v[order][1:] == v[order][:-1]) & (nan[order][1:] == nan[order][:-1])
        else:
            order = np.lexsort((np.arange(n), vals, valid))
            same = vals[order][1:] == vals[order][:-1]
        sv = valid[order]
        new = np.concatenate([[True], ~(((sv[1:] == sv[:-1]) & same) | (~sv[1:] & ~sv[:-1]))])
        values = np.empty(n, np.int64)
        values[order] = np.cumsum(new) - 1
        rows = order[new]
        return cls(vals[rows], valid[rows], values)

    def value(self, key):
        if isinstance(key, float) and key != key and self.keys.dtype.kind != "f":
            return -1
        return self.index.get(_num_canon(np.asarray(key, self.keys.dtype), True), -1)

    def remap(self, other):
        table = np.array([other.index.get(_num_canon(k, ok), -1) for k, ok in zip(self.keys, self.valid)]
                         + [-1], np.int64)
        return table[self.values]

    def with_keys(self, keys, valid):
        new = _NumOracle(keys, valid, [])
        return _NumOracle(keys, valid, self.remap(new))

    def add_keys(self, vals, isnull):
        u = _NumOracle.encode(np.concatenate([self.keys, vals.astype(self.keys.dtype)]),
                              np.concatenate([self.valid, ~isnull]))
        return self.with_keys(u.keys, u.valid)

    def remove_keys(self, vals, isnull):
        drop = {self.index.get(_num_canon(v, not z), -1) for v, z in zip(vals.astype(self.keys.dtype), isnull)}
        keep = [i for i in range(len(self.keys)) if i not in drop]
        return self.with_keys(self.keys[keep], self.valid[keep])

    def remove_unused(self):
        keep = np.unique(self.values[self.values >= 0])
        return self.with_keys(self.keys[keep], self.valid[keep])

    def set_keys(self, vals, isnull):
        u = _NumOracle.encode(vals.astype(self.keys.dtype), ~isnull)
        return self.with_keys(u.keys, u.valid)

    def gather(self, idx):
        return _NumOracle(self.keys, self.valid, idx)

    def merge_and_remap(self, other):
        u = _NumOracle.encode(np.concatenate([self.keys, other.keys.astype(self.keys.dtype)]),
                              np.concatenate([self.valid, other.valid]))
        return _NumOracle(u.keys, u.valid, np.concatenate([self.remap(u), other.remap(u)]))

    def merge_category(self, other):
        new = [i for i, (k, ok) in enumerate(zip(other.keys, other.valid)) if _num_canon(k, ok) not in self.index]
        keys = np.concatenate([self.keys, other.keys[new]])
        valid = np.concatenate([self.valid, other.valid[new]])
        merged = _NumOracle(keys, valid, [])
        return _NumOracle(keys, valid, np.concatenate([self.values, other.remap(merged)]))


def _category_lookups(keys, rng, n: int = CATEGORY_LOOKUPS):
    """n keys to look up: half drawn from `keys` (the long ones, None and
    "" first), half absent (prefixes cut, extensions, non-ASCII)."""
    present = [None, "", _PREFIXES[0], _P256, f"{_P256} part 07"]
    present += [keys[i] for i in rng.integers(0, len(keys), n // 2 - len(present))]
    absent = [_PREFIXES[0][:63], _P256 + " part", _P256 + "\x00", "\U0001F600 not a key", "zzzz"]
    absent += [keys[i] + "!" for i in rng.integers(0, len(keys), n - n // 2 - len(absent))]
    return present + absent


def _num_lookups(vals, dtype: str, rng, n: int = CATEGORY_LOOKUPS):
    """n numbers to look up: edge values, drawn values and absent ones."""
    edges = _numeric_edges(dtype).tolist()
    drawn = vals[rng.integers(0, len(vals), n // 2)].tolist()
    if dtype in _INT_RANGE:
        lo, hi = _INT_RANGE[dtype]
        absent = [int(x) for x in rng.integers(lo, hi, n - len(edges) - len(drawn), endpoint=True)]
    else:
        absent = [float(x) for x in rng.standard_normal(n - len(edges) - len(drawn)) * 1e3 + 0.005]
        absent[:2] = [float("nan"), -0.0]
    return edges + drawn + absent


def _host_cat(c):
    """(keys, values) of an nvcategory as host lists."""
    return c.keys().to_host(), c.values()


def _host_num(c):
    """(keys, keys' validity, values) of a numeric_category as numpy."""
    keys = c.keys(np.empty(c.keys_size(), c.keys_type()))
    return keys, np.asarray(c._cat.keys_valid.cpu()), c.values(np.empty(c.size(), np.int32))


def _run_category(torch, a, b, nums, device="cuda"):
    """Every facade method of nvcategory and numeric_category: the string
    category of rows a, with b, on CATEGORY_LOOKUPS lookups, gathers,
    row adds and removes, the keyset algebra and both merges (and a
    second merge_category, whose keyset is unsorted, looked up); each
    numeric category of `nums` (make_numeric_columns) through every
    method.  Returns (host results, per-op seconds, per-op peak device
    memory); the CPU tests run it with device="cpu"."""
    from custrings_tpu_torch import nvcategory, nvstrings

    times, peaks, out = {}, {}, {}
    step = _stepper(torch, times, peaks if device == "cuda" else None, cuda=device == "cuda")
    rng = np.random.default_rng(10)
    sa = step("to_device", lambda: nvstrings.to_device(a, device=device))
    sb = nvstrings.to_device(b, device=device)
    cat = step("from_strings", lambda: nvcategory.from_strings(sa))
    out["from_strings"] = _host_cat(cat)
    out["sizes"] = (cat.size(), cat.keys_size(), cat.keys_type(), cat.has_nulls(), cat.get_cpointer(),
                    cat.values_cpointer() == cat._cat.values.data_ptr())
    keys = out["from_strings"][0]
    look = _category_lookups([k for k in keys if k is not None], rng)
    out["lookups"] = look
    catb = step("from_strings(b)", lambda: nvcategory.from_strings(sb))
    out["from_strings(b)"] = _host_cat(catb)
    out["from_strings_list"] = _host_cat(step("from_strings_list", lambda: nvcategory.from_strings_list([sa, sb])))
    out["to_strings"] = step("to_strings", cat.to_strings).to_host()
    out["value"] = step("value", lambda: [cat.value(k) for k in look])
    out["get_value_bounds"] = step("get_value_bounds", lambda: [cat.get_value_bounds(k) for k in look])
    out["indexes_for_key"] = step("indexes_for_key", lambda: [cat.indexes_for_key(k) for k in look[:8] + look[-2:]])
    rows = rng.integers(0, len(a), 100)
    out["value_for_index"] = (rows.tolist(), [cat.value_for_index(int(i)) for i in rows])
    K = cat.keys_size()
    gidx = rng.integers(0, K, len(a)).astype(np.int32)
    sidx = gidx[:4096]
    out["gather_idx"] = (gidx, sidx)
    out["gather_strings"] = step("gather_strings", lambda: cat.gather_strings(sidx)).to_host()
    out["gather"] = _host_cat(step("gather", lambda: cat.gather(gidx)))
    out["gather_and_remap"] = _host_cat(step("gather_and_remap", lambda: cat.gather_and_remap(sidx)))
    out["add_strings"] = _host_cat(step("add_strings", lambda: cat.add_strings(sb)))
    drop = look[:10] + look[-10:]
    out["remove_strings"] = _host_cat(step("remove_strings",
                                           lambda: cat.remove_strings(nvstrings.to_device(drop, device=device))))
    new_keys = [k for k in b[:20000] if k is not None][:2000] + look[-50:]
    out["add_keys"] = _host_cat(step("add_keys", lambda: cat.add_keys(new_keys)))
    gone = keys[: K // 3] + look[-5:]
    out["remove_keys"] = _host_cat(step("remove_keys", lambda: cat.remove_keys(gone)))
    kept = keys[K // 2:] + new_keys
    sk = step("set_keys", lambda: cat.set_keys(nvstrings.to_device(kept, device=device)))
    out["set_keys"] = _host_cat(sk)
    out["remove_unused_keys"] = _host_cat(step("remove_unused_keys", sk.remove_unused_keys))
    merged = step("merge_category", lambda: cat.merge_category(catb))
    out["merge_category"] = _host_cat(merged)
    catc = nvcategory.from_strings(nvstrings.to_device(look + new_keys[:100], device=device))
    merged2 = step("merge_category(unsorted)", lambda: merged.merge_category(catc))
    out["merge_category(unsorted)"] = _host_cat(merged2)
    out["unsorted lookups"] = step("unsorted lookups", lambda: (
        [merged2.value(k) for k in look], [merged2.get_value_bounds(k) for k in look],
        [merged2.indexes_for_key(k) for k in look[-12:]]))
    out["merge_and_remap"] = _host_cat(step("merge_and_remap", lambda: cat.merge_and_remap(catb)))
    del sa, sb, cat, catb, sk, merged, merged2, catc
    for dt, (va, ma, vb, mb) in nums.items():
        res = out[f"numeric {dt}"] = {}
        nc = step(f"from_numbers({dt})", lambda va=va, ma=ma: nvcategory.from_numbers(va, ma, device=device))
        ncb = nvcategory.from_numbers(vb, mb, device=device)
        res["from_numbers"] = _host_num(nc)
        res["from_numbers(b)"] = _host_num(ncb)
        res["sizes"] = (nc.size(), nc.keys_size(), nc.keys_type())
        nl = _num_lookups(va, dt, rng)
        res["lookups"] = nl
        res["value"] = step(f"value({dt})", lambda nc=nc, nl=nl: [nc.value(k) for k in nl])
        res["indexes_for_key"] = step(f"indexes_for_key({dt})", lambda nc=nc, nl=nl: (
            [nc.indexes_for_key(k) for k in nl],
            [nc.indexes_for_key(k, np.empty(len(va), np.int32))
             for k in nl[:2]]))
        nrows = rng.integers(0, len(va), 100)
        res["value_for_index"] = (nrows.tolist(), [nc.value_for_index(int(i)) for i in nrows])
        res["to_numbers"] = step(f"to_numbers({dt})", lambda nc=nc: nc.to_numbers(np.empty(len(va), va.dtype)))
        kidx = rng.integers(0, nc.keys_size(), 4096).astype(np.int32)
        gidx = rng.integers(0, nc.keys_size(), len(va)).astype(np.int32)
        res["idx"] = (kidx, gidx)
        res["gather_numbers"] = np.asarray(nc.gather_numbers(kidx, np.empty(len(kidx), va.dtype)))
        extra = np.concatenate([vb[:64], _numeric_edges(dt)])
        extra_null = np.arange(len(extra)) % 7 == 0
        res["keys_args"] = (extra, extra_null)
        res["add_keys"] = _host_num(step(f"add_keys({dt})", lambda nc=nc: nc.add_keys(extra, extra_null)))
        res["remove_keys"] = _host_num(step(f"remove_keys({dt})", lambda nc=nc: nc.remove_keys(extra, extra_null)))
        sk = step(f"set_keys({dt})", lambda nc=nc: nc.set_keys(extra, extra_null))
        res["set_keys"] = _host_num(sk)
        res["remove_unused_keys"] = _host_num(step(f"remove_unused_keys({dt})", sk.remove_unused_keys))
        res["gather"] = _host_num(step(f"gather({dt})", lambda nc=nc, gidx=gidx: nc.gather(gidx)))
        res["gather_and_remap"] = _host_num(step(f"gather_and_remap({dt})",
                                                 lambda nc=nc, kidx=kidx: nc.gather_and_remap(kidx)))
        res["merge_category"] = _host_num(step(f"merge_category({dt})", lambda nc=nc, ncb=ncb: nc.merge_category(ncb)))
        res["merge_and_remap"] = _host_num(step(f"merge_and_remap({dt})",
                                                lambda nc=nc, ncb=ncb: nc.merge_and_remap(ncb)))
        del nc, ncb, sk
    return out, times, peaks


def _cat_bad(got, want: _CatOracle) -> int:
    keys, values = got
    return _mismatches(keys, want.keys) + _mismatches(values, want.values.tolist())


def _num_bad(got, want: _NumOracle) -> int:
    """Rows of keys (bitwise), keys' validity and values that differ."""
    keys, valid, values = got
    if keys.dtype != want.keys.dtype or len(keys) != len(want.keys):
        return max(len(keys), len(want.keys), 1) + abs(len(values) - len(want.values))
    w = keys.dtype.itemsize
    kb = (keys.view(np.uint8).reshape(-1, w) != want.keys.view(np.uint8).reshape(-1, w)).any(axis=1)
    return int(kb.sum()) + int((valid != want.valid).sum()) + _mismatches(values.tolist(), want.values.tolist())


def _bits_bad(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.size, want.size, 1)
    return int((got.view(np.uint8) != want.view(np.uint8)).reshape(len(got), -1).any(axis=1).sum())


def _check_category(a, b, nums, res):
    """{check: rows that differ from the oracles}, every row of every
    result (numeric keys bitwise)."""
    bad = {}
    ca, cb = _CatOracle.encode(a), _CatOracle.encode(b)
    look = res["lookups"]
    bad["from_strings"] = _cat_bad(res["from_strings"], ca)
    bad["sizes"] = int(res["sizes"] != (len(a), len(ca.keys), "str", None in ca.index, 0, True))
    bad["from_strings(b)"] = _cat_bad(res["from_strings(b)"], cb)
    bad["from_strings_list"] = _cat_bad(res["from_strings_list"], _CatOracle.encode(a + b))
    bad["to_strings"] = _mismatches(res["to_strings"], a)
    bad["value"] = _mismatches(res["value"], [ca.value(k) for k in look])
    bad["get_value_bounds"] = _mismatches(res["get_value_bounds"], [ca.bounds(k) for k in look])
    bad["indexes_for_key"] = _mismatches(res["indexes_for_key"], [ca.indexes(k) for k in look[:8] + look[-2:]])
    rows, vals = res["value_for_index"]
    bad["value_for_index"] = _mismatches(vals, [int(ca.values[i]) for i in rows])
    gidx, sidx = res["gather_idx"]
    bad["gather_strings"] = _mismatches(res["gather_strings"], [ca.keys[i] for i in sidx.tolist()])
    bad["gather"] = _cat_bad(res["gather"], _CatOracle(ca.keys, gidx))
    bad["gather_and_remap"] = _cat_bad(res["gather_and_remap"], _CatOracle(ca.keys, sidx).remove_unused())
    bad["add_strings"] = _cat_bad(res["add_strings"], _CatOracle.encode(a + b))
    drop = set(look[:10] + look[-10:])
    bad["remove_strings"] = _cat_bad(res["remove_strings"], _CatOracle.encode([r for r in a if r not in drop]))
    new_keys = [k for k in b[:20000] if k is not None][:2000] + look[-50:]
    bad["add_keys"] = _cat_bad(res["add_keys"], ca.add_keys(new_keys))
    K = len(ca.keys)
    bad["remove_keys"] = _cat_bad(res["remove_keys"], ca.remove_keys(ca.keys[: K // 3] + look[-5:]))
    sk = ca.set_keys(ca.keys[K // 2:] + new_keys)
    bad["set_keys"] = _cat_bad(res["set_keys"], sk)
    bad["remove_unused_keys"] = _cat_bad(res["remove_unused_keys"], sk.remove_unused())
    merged = ca.merge_category(cb)
    bad["merge_category"] = _cat_bad(res["merge_category"], merged)
    merged2 = merged.merge_category(_CatOracle.encode(look + new_keys[:100]))
    bad["merge_category(unsorted)"] = _cat_bad(res["merge_category(unsorted)"], merged2)
    values, bounds, idxs = res["unsorted lookups"]
    bad["unsorted lookups"] = (_mismatches(values, [merged2.value(k) for k in look])
                               + _mismatches(bounds, [merged2.bounds(k) for k in look])
                               + _mismatches(idxs, [merged2.indexes(k) for k in look[-12:]]))
    bad["merge_and_remap"] = _cat_bad(res["merge_and_remap"], ca.merge_and_remap(cb))
    for dt, (va, ma, vb, mb) in nums.items():
        r, p = res[f"numeric {dt}"], f"{dt} "
        na = _NumOracle.encode(va, _bits_valid(ma, len(va)))
        nb = _NumOracle.encode(vb, _bits_valid(mb, len(vb)))
        bad[p + "from_numbers"] = _num_bad(r["from_numbers"], na)
        bad[p + "from_numbers(b)"] = _num_bad(r["from_numbers(b)"], nb)
        bad[p + "sizes"] = int(r["sizes"] != (len(va), len(na.keys), dt))
        nl = r["lookups"]
        want_v = [na.value(k) for k in nl]
        bad[p + "value"] = _mismatches(r["value"], want_v)
        counts, filled = r["indexes_for_key"]
        bad[p + "indexes_for_key"] = (_mismatches(counts, [int((na.values == v).sum()) for v in want_v])
                                      + _mismatches(filled, counts[:2]))
        nrows, nvals = r["value_for_index"]
        bad[p + "value_for_index"] = _mismatches(nvals, [int(na.values[i]) for i in nrows])
        want_n = np.where(na.values >= 0, na.keys[na.values.clip(0)], 0).astype(va.dtype)
        bad[p + "to_numbers"] = _bits_bad(r["to_numbers"], want_n)
        kidx, gidx = r["idx"]
        bad[p + "gather_numbers"] = _bits_bad(r["gather_numbers"], na.keys[kidx])
        extra, extra_null = r["keys_args"]
        bad[p + "add_keys"] = _num_bad(r["add_keys"], na.add_keys(extra, extra_null))
        bad[p + "remove_keys"] = _num_bad(r["remove_keys"], na.remove_keys(extra, extra_null))
        sk = na.set_keys(extra, extra_null)
        bad[p + "set_keys"] = _num_bad(r["set_keys"], sk)
        bad[p + "remove_unused_keys"] = _num_bad(r["remove_unused_keys"], sk.remove_unused())
        bad[p + "gather"] = _num_bad(r["gather"], na.gather(gidx))
        bad[p + "gather_and_remap"] = _num_bad(r["gather_and_remap"], na.gather(kidx).remove_unused())
        bad[p + "merge_category"] = _num_bad(r["merge_category"], na.merge_category(nb))
        bad[p + "merge_and_remap"] = _num_bad(r["merge_and_remap"], na.merge_and_remap(nb))
    return bad


def _category_kernel_shapes(torch, a, nums, device="cuda"):
    """K1b and K3 at the category path's own calls, captured by wrapping
    the names their callers look up, each with its own bound:
    searchsorted_keys' key words as remove_strings passes it the dropped
    keys and the category's 1M rows (K1b, the keys' and the queries'),
    and from_numbers' rank scan of the float64 column (K3).  Returns
    [(name, source, replaces, shapes)]; the CPU tests run it with
    device="cpu"."""
    from custrings_tpu_torch import category, column, numeric
    from custrings_tpu_torch.ops import array, scan, segments, unique, window

    col = column.from_host_strings(a, device)
    cat = category.from_strings(col)
    drop = column.from_host_strings(a[:64] + [None, "zzzz"], device)
    with _Calls((unique, "searchsorted_keys")) as lookups:
        category.remove_strings(cat, drop)
    if len(lookups.calls) != 1:
        raise AssertionError(f"remove_strings made {len(lookups.calls)} searchsorted_keys calls (want one)")
    with _Calls((array, "ragged_gather_words")) as k1b:
        unique.searchsorted_keys(*lookups.calls[0][1])
    va, ma = nums["float64"][:2]
    with _Calls((segments, "cumsum")) as k3:
        numeric.from_numbers(va, ~_bits_valid(ma, len(va)), device=device)
    if len(k1b.calls) != 2 or len(k3.calls) != 1:
        raise AssertionError(f"category path calls not captured: K1b {len(k1b.calls)} (want 2), "
                             f"K3 {len(k3.calls)} (want 1)")
    del col, cat, drop, lookups

    def words(label, data, st, w):
        rows, wq = st.shape[0], -(-w // 4)
        return (f"i32[{rows},{wq}] searchsorted_keys' {label}, width {w}",
                lambda: window.ragged_gather_words(data, st, w),
                lambda: _chunked(torch, lambda i, j: window._words_plain(data, st[i:j], w), rows, 4 * wq),
                {"bound": _words_bound(torch, data, st, w)})

    (neq,) = k3.calls[0][1]
    n = neq.shape[0]
    rank = (f"bool[{n}] -> i32[{n}] from_numbers' rank scan (float64)", lambda: scan.cumsum_i32(neq),
            lambda: scan._cumsum_plain(neq),
            {"bound": (5 * n, n), "library": lambda: torch.cumsum(neq, 0, dtype=torch.int32)})
    return [("window_words", "csrc/window.cu", "custrings_tpu/ops/pallas_window.py:170",
             [words(label, *call[1]) for label, call in reversed(list(zip(("keys' words", "queries' words"),
                                                                          k1b.calls)))]),
            ("scan_sum", "csrc/scan.cu", "custrings_tpu/ops/pallas_scan.py:235", [rank])]


# ---------------------------------------------------------------- regex

#: the regex phase's patterns: addresses and their groups (K5 first match,
#: ordered groups), a multi-pattern clean-up (ordered + K5), URLs (the
#: ordered engine's round loop), IPv4 addresses in log lines (ordered, 30
#: insts), eight words (min-plus, 40 insts), hashtags with a word
#: boundary (the per-row DFS, 142 insts)
REGEX_EMAIL = r"(\w+)@(\w+)"
REGEX_SWAP = r"\2 at \1"
REGEX_WHOLE = r"<\0|\2>"
REGEX_MULTI = ((r"https?://\S+", r"@\w+", r"#\w+"), ("URL", "USER", "TAG"))
REGEX_URL = r"https?://\S+"
REGEX_IP = r"(\d{1,3}\.){3}\d{1,3}"
REGEX_WORDS = " ".join([r"(\w+)"] * 8)
REGEX_DFS = r"#\w{1,70}\b"
REGEX_IP_ROWS = 1 << 18
REGEX_RECORD_ROWS = 1 << 16
REGEX_WORDS_ROWS = 1 << 16
REGEX_DFS_ROWS = 4096
#: the reference's \b for Python re: a change of IS_ALPHANUM (letters and
#: digits, without the '_' that Python's \b counts as a word char)
REF_BOUNDARY = r"(?:(?<=[^\W_])(?![^\W_])|(?<![^\W_])(?=[^\W_]))"


def _py_template(t: str) -> str:
    r"""A backref template for Python re.sub: \N becomes \g<N>."""
    return re.sub(r"\\(\d+)", lambda m: "\\g<%s>" % m.group(1), t)


def replace_multi_py(s, rxs, reps):
    """One row of replace_multi: at each step every pattern's first match
    from the row's begin, the earliest begin winning and a tie going to
    the lowest index, then the reference's advance rule (begin = end if
    end > begin of the match, else begin + 1).  A pattern's match from an
    earlier begin is reused while it starts at or after the begin."""
    if s is None:
        return None
    out, cur, begin = [], 0, 0
    cache = [None] * len(rxs)
    while begin <= len(s):
        best = None
        for k, rx in enumerate(rxs):
            c = cache[k]
            if c is None or (c is not False and c[0] < begin):
                m = rx.search(s, begin)
                c = cache[k] = (m.start(), m.end()) if m else False
            if c is not False and (best is None or c[0] < best[0]):
                best = (c[0], c[1], k)
        if best is None:
            break
        b, e, k = best
        out += [s[cur:b], reps[k]]
        cur = e
        begin = e if e > b else begin + 1
    return "".join(out) + s[cur:]


def regex_oracle(strs, logs, ip_rows=REGEX_IP_ROWS, head_rows=REGEX_RECORD_ROWS,
                 words_rows=REGEX_WORDS_ROWS, dfs_rows=REGEX_DFS_ROWS):
    """Python re's answers to the regex phase, keyed as _run_regex's."""
    em, url, ip = re.compile(REGEX_EMAIL), re.compile(REGEX_URL), re.compile(REGEX_IP)
    words, dfs = re.compile(REGEX_WORDS), re.compile(REGEX_DFS.replace(r"\b", REF_BOUNDARY))
    first = [None if s is None else em.search(s) for s in strs]
    found = [None if s is None else [m.group(0) for m in url.finditer(s)] for s in strs]
    wfirst = [None if s is None else words.search(s) for s in strs[:words_rows]]
    multi = [re.compile(p) for p in REGEX_MULTI[0]]
    return {
        "extract": [[None if m is None else m.group(g) for m in first] for g in (1, 2)],
        "replace_with_backrefs": [None if s is None else em.sub(_py_template(REGEX_SWAP), s) for s in strs],
        "replace_with_backrefs(\\0)": [None if s is None else em.sub(_py_template(REGEX_WHOLE), s)
                                       for s in strs],
        "replace_multi": [replace_multi_py(s, multi, REGEX_MULTI[1]) for s in strs],
        "count": [0 if f is None else len(f) for f in found],
        "findall_record": found,
        "replace(ip)": [None if s is None else ip.sub("IP", s) for s in logs[:ip_rows]],
        "extract_record": [[None, None] if m is None else [m.group(1), m.group(2)] for m in first[:head_rows]],
        "extract(8 words)": [[None if m is None else m.group(g) for m in wfirst] for g in range(1, 9)],
        "count(dfs)": [0 if s is None else sum(1 for _ in dfs.finditer(s)) for s in strs[:dfs_rows]],
    }


def _run_regex(torch, strs, logs, device="cuda"):
    """The regex phase through the facade: extract, replace_with_backrefs
    (two templates), replace_multi, count and findall_record of URLs on
    the tweet rows; replace of IPv4 addresses on the first REGEX_IP_ROWS
    log rows; extract_record and the eight-word extract on the first
    REGEX_RECORD_ROWS / REGEX_WORDS_ROWS rows; the DFS count on the first
    REGEX_DFS_ROWS.  Returns (results read back to the host, per-op
    seconds, per-op peak device memory, per-op kernel launches); the CPU
    tests run it with device="cpu" at a few thousand rows."""
    from custrings_tpu_torch import kernels, nvstrings

    cuda = device == "cuda"
    times, peaks, launches = {}, {}, {}
    step = _stepper(torch, times, peaks if cuda else None, cuda)

    def op(name, fn):
        before = dict(kernels.LAUNCHES)
        out = step(name, fn)
        launches[name] = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        return out

    def host(name, x):
        return step(f"{name}_to_host", lambda: [c.to_host() for c in x] if isinstance(x, list) else x.to_host())

    s = op("to_device", lambda: nvstrings.to_device(strs, device=device))
    res = {"extract": host("extract", op("extract", lambda: s.extract(REGEX_EMAIL)))}
    for name, tpl in (("replace_with_backrefs", REGEX_SWAP), ("replace_with_backrefs(\\0)", REGEX_WHOLE)):
        res[name] = host(name, op(name, lambda tpl=tpl: s.replace_with_backrefs(REGEX_EMAIL, tpl)))
    res["replace_multi"] = host("replace_multi", op(
        "replace_multi", lambda: s.replace_multi(list(REGEX_MULTI[0]), list(REGEX_MULTI[1]))))
    res["count"] = op("count", lambda: s.count(REGEX_URL))
    found = op("findall_record", lambda: s.findall_record(REGEX_URL))
    res["findall_record"] = step("findall_record_to_host", lambda: _records_to_host(found))
    del s, found
    ip = op("to_device(logs)", lambda: nvstrings.to_device(logs[:REGEX_IP_ROWS], device=device))
    res["replace(ip)"] = host("replace(ip)", op("replace(ip)", lambda: ip.replace(REGEX_IP, "IP")))
    del ip
    head = op("to_device(head)", lambda: nvstrings.to_device(strs[:REGEX_RECORD_ROWS], device=device))
    recs = op("extract_record", lambda: head.extract_record(REGEX_EMAIL))
    res["extract_record"] = step("extract_record_to_host", lambda: _records_to_host(recs))
    del head, recs
    words = op("to_device(words)", lambda: nvstrings.to_device(strs[:REGEX_WORDS_ROWS], device=device))
    res["extract(8 words)"] = host("extract(8 words)", op("extract(8 words)", lambda: words.extract(REGEX_WORDS)))
    dfs = op("to_device(dfs)", lambda: nvstrings.to_device(strs[:REGEX_DFS_ROWS], device=device))
    res["count(dfs)"] = op("count(dfs)", lambda: dfs.count(REGEX_DFS))
    return res, times, peaks, launches


def _check_regex(want, res):
    return {k: _mismatches(res[k], want[k]) for k in want}


def _regex_kernel_shapes(torch, strs, device="cuda"):
    """K4e, K4c and K5 at the regex path's own calls on the tweet rows,
    captured by wrapping the names their callers look up, each with its
    own bound: replace_with_backrefs' gap expansion (shift_compact.
    expand_to) and stream_expand_spans' expansion of the first group's
    bytes (route.expand_stream) (K4e), the gap compaction of
    _replace_frame (K4c, the bytes and their inserted-bytes counts, k0
    written as the path asks and given), and
    extract's first-match call (SpanBits.single; K5).  Returns [(name,
    source, replaces, shapes)]; the CPU tests run it with device="cpu"."""
    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import route, shift_compact
    from custrings_tpu_torch.regex import ops as rx
    from custrings_tpu_torch.regex.span_bits import SpanBits

    col = column.from_host_strings(strs, device)
    with _Calls((shift_compact, "expand_to"), (shift_compact, "compact_arrays"), (route, "expand_stream")) as log:
        rx.replace_with_backrefs(col, REGEX_EMAIL, REGEX_SWAP)
    with _Calls((SpanBits, "single")) as k5:
        rx.extract(col, REGEX_EMAIL)
    gap = [a for site, a in log.calls if site == "shift_compact.expand_to"]
    stream = [a for site, a in log.calls if site == "route.expand_stream"]
    comp = [a for site, a in log.calls if site == "shift_compact.compact_arrays"]
    if not gap or not stream or not comp or len(k5.calls) != 1:
        raise AssertionError(f"regex path calls not captured: expand_to {len(gap)}, expand_stream {len(stream)}, "
                             f"compact_arrays {len(comp)}, SpanBits.single {len(k5.calls)} (want one)")

    def expand(label, live, dist, planes, out_cap, want=True):
        names = "+".join(str(a.dtype).split(".")[-1] for a in planes)
        return (f"{names}[{live.shape[0]}] -> [{out_cap}] {label}",
                lambda: _expanded(route.expand_stream(live, dist, planes, out_cap, want)),
                lambda: _expanded(route._expand_plain(live.bool(), dist.to(torch.int32), planes, out_cap, want)),
                {"bound": _expand_bound(live, planes, out_cap, want)})

    k4e = [expand("replace_with_backrefs' gap bytes", *gap[0]),
           expand("stream_expand_spans (group 2's bytes)", *stream[0])]
    keep, planes, *want = comp[0]
    if want not in ([], [True]):
        raise AssertionError(f"_replace_frame's gap compaction gave up its k0: {want}")
    k0 = route._compact_plain(keep.bool(), [], None, True)[1]
    k4c = _compact_stream_cases(torch, f"_replace_frame's gap bytes ({int(k0[-1])} kept)", keep, planes, k0,
                                ("path", "given"))
    sb, chars, nch, start = k5.calls[0][1][:4]
    n, L = chars.shape
    valid = torch.ones(n, dtype=torch.bool, device=chars.device)
    st = torch.as_tensor(start, dtype=torch.int32, device=chars.device).expand(n).contiguous()

    def first(call):
        return lambda: call(chars, nch, valid, 1, st, False)

    _, B, E = sb._all_plain(chars, nch, valid, 1, st, False)
    k5c = (f"i32[{n},{L}] extract's first match of {REGEX_EMAIL}", first(sb._launch) if chars.is_cuda
           else first(sb._all_plain), first(sb._all_plain),
           {"bound": _span_all_bound(torch, nch, valid, L, 1, B, E)})
    return [("route_expand", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:448", k4e),
            ("route_compact", "csrc/route.cu", "custrings_tpu/ops/pallas_route.py:290", k4c),
            ("span_all", "csrc/spans.cu", "custrings_tpu/regex/pallas_spans.py:251", [k5c])]


def _traced_slice(torch, strs, device="cuda"):
    """The slice's three ops (contains, replace, dictionary encode) through
    the facades once untraced and once with tracing enabled: (the spans'
    records {name: (calls, total host seconds, self host seconds)},
    whether the results are identical)."""
    from custrings_tpu_torch import nvcategory, nvstrings
    from custrings_tpu_torch.utils import tracing

    def run():
        s = nvstrings.to_device(strs, device=device)
        hits = s.contains(PATTERN)
        r = s.replace("the", "THE", regex=False)
        cat = nvcategory.from_strings(r)
        return hits, r.to_host(), cat.keys().to_host(), cat.values()

    plain = run()
    tracing.reset()
    with tracing.enabled():
        traced = run()
    rows = {name: tuple(rec) for name, rec in tracing._records.items()}
    tracing.reset()
    return rows, plain == traced


TRACED_OPS = ("regex.contains_re", "modify.replace_literal", "unique.dictionary_encode")


def _driven(torch, kernels, run, strs):
    """Run one path with every launch counter set to 0 just before it and
    read just after; returns (run's result, the counters)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = run(torch, strs)
    torch.cuda.synchronize()
    return res, {**kernels.LAUNCHES, "scan_sum_by_size": dict(kernels.SCAN_SUM_SIZES)}


PARALLEL_REPLACE = ("the", "THEIR!")
#: rows of each corpus in the two-rank gloo job
PARALLEL_RANK_ROWS = 1 << 16
#: a hung two-rank job fails the phase after this many seconds
PARALLEL_RANK_TIMEOUT = 300


def token_oracle(strs):
    """(the global id of every whitespace token in row order, the unique
    count): a token's rank among the sorted (UTF-8 byte order) unique
    tokens, whitespace being code points <= 0x20 (ws_split)."""
    toks = [t for s in strs if s is not None for t in ws_split(s, -1) if t]
    uniq = sorted(set(toks), key=lambda t: t.encode("utf-8"))
    rank = {t: i for i, t in enumerate(uniq)}
    return [rank[t] for t in toks], len(uniq)


def skewed_rows(n: int):
    """Sorted distinct keys: in row shards each rank's keys form one range."""
    return [f"k{i:06d}" for i in range(n)]


def _sharded_ops(sc, step):
    """The sharded path on one column: replace (growing) and to_column,
    contains_re(PATTERN) with its job total, categorize, unique_tokens; the
    results as host lists of this rank's alive rows (ids: its tokens)."""
    grown = step("replace", lambda: sc.replace(*PARALLEL_REPLACE))
    back = step("to_column", grown.to_column)
    mask, total = step("contains_re", lambda: sc.contains_re(PATTERN))
    values, nkeys = step("categorize", sc.categorize)
    ids, nuniq = step("unique_tokens", sc.unique_tokens)
    from custrings_tpu_torch import column

    n = int(sc.alive.sum())
    return {"replaced": column.to_host_strings(back), "mask": mask[:n].tolist(), "total": total,
            "values": values[:n].tolist(), "keys": nkeys, "ids": ids[ids >= 0].tolist(), "unique": nuniq}


def _categorized(sc, step, name):
    values, n = step(name, sc.categorize)
    return {"values": values[: int(sc.alive.sum())].tolist(), "keys": n}


def _parallel_path(torch, strs, cat_rows, mesh):
    """The sharded path on a world of one (NCCL): shard_global of the
    tweets and the sharded ops, then shard_global and categorize of the
    category rows.  Returns (results, per-op seconds)."""
    from custrings_tpu_torch.parallel import runtime

    times = {}
    step = _stepper(torch, times)
    sc = step("shard_global", lambda: runtime.shard_global(strs, mesh))
    res = _sharded_ops(sc, step)
    del sc
    cat = step("shard_global(category)", lambda: runtime.shard_global(cat_rows, mesh))
    res["category"] = _categorized(cat, step, "categorize(category)")
    return res, times


def _single_chip(torch, strs, cat_rows):
    """The same ops on one device without the mesh: (results, seconds)."""
    from custrings_tpu_torch import column, nvcategory, nvstrings
    from custrings_tpu_torch.ops import modify, unique
    from custrings_tpu_torch.regex import ops as rops
    from custrings_tpu_torch.text import token

    times = {}
    step = _stepper(torch, times)
    col = step("from_host_strings", lambda: column.from_host_strings(strs, "cuda"))
    step("replace", lambda: modify.replace_literal(col, *PARALLEL_REPLACE))
    step("contains_re", lambda: rops.contains_re(col, PATTERN))
    s = nvstrings.to_device(strs, device="cuda")
    cat = step("categorize", lambda: nvcategory.from_strings(s))
    _, ids = step("unique_tokens", lambda: unique.dictionary_encode(token.tokenize(col)))
    c = nvstrings.to_device(cat_rows, device="cuda")
    ccat = step("categorize(category)", lambda: nvcategory.from_strings(c))
    return {"values": cat.values(), "ids": ids.tolist(), "category": ccat.values()}, times


def _check_parallel(strs, cat_rows, res, single=None):
    """Mismatched rows of a sharded run (its ranks' results joined in rank
    order) against the Python oracles and, where given, the single-device
    run."""
    rx = re.compile(PATTERN)
    hits = [s is not None and rx.search(s) is not None for s in strs]
    _, want_values = _category_oracle(strs)
    _, want_cat = _category_oracle(cat_rows)
    want_ids, want_unique = token_oracle(strs)
    bad = {
        "replace": _mismatches(res["replaced"], [None if s is None else s.replace(*PARALLEL_REPLACE)
                                                 for s in strs]),
        "contains": _mismatches(res["mask"], hits) + int(res["total"] != sum(hits)),
        "categorize": _mismatches(res["values"], want_values) + int(res["keys"] != len(set(strs))),
        "unique_tokens": _mismatches(res["ids"], want_ids) + int(res["unique"] != want_unique),
        "categorize(category)": (_mismatches(res["category"]["values"], want_cat)
                                 + int(res["category"]["keys"] != len(set(cat_rows)))),
    }
    if single is not None:
        bad["categorize vs single"] = _mismatches(res["values"], single["values"])
        bad["unique_tokens vs single"] = _mismatches(res["ids"], single["ids"])
        bad["categorize(category) vs single"] = _mismatches(res["category"]["values"], single["category"])
    return bad


def _gloo_cuda_check(torch, group, S: int, me: int, device):
    """gloo takes tensors on `device` for all_gather, all_to_all_single at
    uneven splits and all_reduce, and moves them right."""
    import torch.distributed as dist

    x = torch.arange(3, dtype=torch.int32, device=device) + 10 * me
    got = x.new_empty(3 * S)
    dist.all_gather_into_tensor(got, x, group=group)
    send = [me + 1 + k for k in range(S)]
    recv = [k + 1 + me for k in range(S)]
    out = x.new_empty(sum(recv))
    dist.all_to_all_single(out, torch.full((sum(send),), me, dtype=torch.int32, device=device),
                           output_split_sizes=recv, input_split_sizes=send, group=group)
    t = torch.tensor([me + 1], dtype=torch.int64, device=device)
    dist.all_reduce(t, group=group)
    ok = (got.tolist() == [i + 10 * r for r in range(S) for i in range(3)]
          and out.tolist() == [r for r in range(S) for _ in range(r + 1 + me)]
          and int(t) == S * (S + 1) // 2 and got.device == out.device == t.device == torch.device(device))
    if not ok:
        raise AssertionError(f"gloo moved {device} tensors wrongly: {got.tolist()} {out.tolist()} {int(t)}")


def _parallel_rank(rank: int, world: int, store: str, out: str) -> int:
    """One rank of the gloo job: `chip_smoke.py --parallel-rank RANK WORLD
    STORE OUT`.  Every rank drives the one card; writes its results to
    OUT/rank{RANK}.json."""
    from datetime import timedelta

    import torch

    from custrings_tpu_torch.parallel import dist as pdist
    from custrings_tpu_torch.parallel import runtime

    runtime.init_runtime(f"file://{store}", world, rank, backend="gloo",
                         timeout=timedelta(seconds=PARALLEL_RANK_TIMEOUT))
    mesh = runtime.global_mesh()
    group, S, me = pdist._group(mesh, "data")
    _gloo_cuda_check(torch, group, S, me, runtime.device())
    times = {}
    step = _stepper(torch, times)
    rows = PARALLEL_RANK_ROWS
    res = _sharded_ops(runtime.shard_global(make_corpus(rows, seed=0), mesh), step)
    cat = make_category_rows(rows, seed=8, b_rows=1)[0]
    res["category"] = _categorized(runtime.shard_global(cat, mesh), step, "categorize(category)")
    res["skewed"] = _categorized(runtime.shard_global(skewed_rows(rows), mesh), step, "categorize(skewed)")
    res["ms"] = {k: v * 1e3 for k, v in times.items()}
    runtime.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _parallel_ranks(world: int):
    """Run the gloo job of `world` ranks in processes of their own: each
    rank's results, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {k: v for k, v in os.environ.items()
               if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
        cmd = [sys.executable, os.path.abspath(__file__), "--parallel-rank"]
        procs = [subprocess.Popen([*cmd, str(r), str(world), os.path.join(tmp, "store"), tmp],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + PARALLEL_RANK_TIMEOUT
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of the gloo job failed:\n{log[-4000:]}")
        return [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]


def _joined(ranks):
    """The ranks' results as one run's: rows and tokens in rank order."""
    res = {"replaced": ranks[0]["replaced"], "total": ranks[0]["total"], "keys": ranks[0]["keys"],
           "unique": ranks[0]["unique"]}
    for k in ("mask", "values", "ids"):
        res[k] = [x for r in ranks for x in r[k]]
    for k in ("category", "skewed"):
        res[k] = {"values": [x for r in ranks for x in r[k]["values"]], "keys": ranks[0][k]["keys"]}
    res["agree"] = all(r[k] == ranks[0][k] for r in ranks for k in ("replaced", "total", "keys", "unique"))
    return res


def _check_parallel_ranks(ranks):
    rows = PARALLEL_RANK_ROWS
    res = _joined(ranks)
    strs = make_corpus(rows, seed=0)
    bad = _check_parallel(strs, make_category_rows(rows, seed=8, b_rows=1)[0], res)
    skewed = skewed_rows(rows)
    bad["categorize(skewed)"] = (_mismatches(res["skewed"]["values"], list(range(rows)))
                                 + int(res["skewed"]["keys"] != rows))
    bad["ranks disagree"] = int(not res["agree"])
    return bad


def _parallel_phase(torch, kernels, strs, t_main):
    """The parallel path: a world of one over NCCL on the card at ROWS
    rows of the tweets and of the category rows, launch-counted, each row
    held to the oracles and to the single-device ops; then a world of two
    over gloo, both ranks on the card, at PARALLEL_RANK_ROWS rows.
    Returns the world of one's launch counts."""
    import torch.distributed as dist
    from datetime import timedelta

    from custrings_tpu_torch.parallel import runtime

    t_par = time.perf_counter()
    cat_rows = make_category_rows(ROWS, seed=8, b_rows=1)[0]
    with tempfile.TemporaryDirectory() as tmp:
        runtime.init_runtime(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                             timeout=timedelta(seconds=PARALLEL_RANK_TIMEOUT))
        try:
            mesh = runtime.global_mesh()
            backend = dist.get_backend()
            _parallel_path(torch, strs[:4096], cat_rows[:4096], mesh)  # first use
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            (res, times), launches = _driven(
                torch, kernels, lambda torch, _: _parallel_path(torch, strs, cat_rows, mesh), None)
            peak = torch.cuda.max_memory_allocated()
        finally:
            runtime.shutdown()
    torch.cuda.empty_cache()
    single, single_times = _single_chip(torch, strs, cat_rows)
    t_check = time.perf_counter()
    bad = _check_parallel(strs, cat_rows, res, single)
    _emit({"phase": "parallel", "world": 1, "backend": backend, "rows": ROWS, "category_rows": ROWS,
           "ms": {k: v * 1e3 for k, v in times.items()},
           "single_device_ms": {k: v * 1e3 for k, v in single_times.items()},
           "max_memory_allocated": peak, "allocated_before_phase": held,
           "keys": res["keys"], "category_keys": res["category"]["keys"],
           "tokens": len(res["ids"]), "unique_tokens": res["unique"], "matches": res["total"],
           "oracle_seconds": time.perf_counter() - t_check, "phase_seconds": time.perf_counter() - t_par,
           "script_seconds_before_phase": t_par - t_main, "mismatches": bad})
    if any(bad.values()):
        raise AssertionError(f"the sharded path disagrees with its oracles: {bad}")
    del res, single
    torch.cuda.empty_cache()

    t_two = time.perf_counter()
    ranks = _parallel_ranks(2)
    bad = _check_parallel_ranks(ranks)
    _emit({"phase": "parallel_gloo", "world": 2, "backend": "gloo", "device": "cuda:0 (both ranks)",
           "rows": PARALLEL_RANK_ROWS, "ms_by_rank": [r["ms"] for r in ranks],
           "keys": ranks[0]["keys"], "unique_tokens": ranks[0]["unique"],
           "tokens_by_rank": [len(r["ids"]) for r in ranks],
           "seconds": time.perf_counter() - t_two, "mismatches": bad})
    if any(bad.values()):
        raise AssertionError(f"the two-rank sharded path disagrees with its oracles: {bad}")
    return launches


#: the kernels each path must launch at 1M rows
SLICE_KERNELS = ("scan_sum", "scan_max", "window_bytes", "window_words", "nfa_bits",
                 "route_compact", "route_expand")
SPAN_KERNELS = ("span_all",)
MATCHER_KERNELS = ("nfa_words",)
HASH_KERNELS = ("hash",)
COMPACT_KERNELS = ("compact_bytes",)
TEXT_KERNELS = ("scan_sum", "route_compact", "window_bytes", "window_words")
CLEAN_KERNELS = ("scan_sum", "route_compact", "route_expand", "window_bytes", "window_words")
CONVERT_KERNELS = ("scan_sum", "scan_max", "window_bytes", "window_words", "route_expand", "compact_bytes")
CATEGORY_KERNELS = ("scan_sum", "window_words")
REGEX_KERNELS = ("span_all", "scan_sum", "window_bytes", "route_compact", "route_expand")
PARALLEL_KERNELS = ("scan_sum", "window_bytes", "window_words", "nfa_bits", "route_compact", "route_expand")


def main() -> int:
    if sys.argv[1:] == ["--launch-checks"]:
        return _launch_check_process()
    if sys.argv[1:2] == ["--parallel-rank"]:
        rank, world, store, out = sys.argv[2:]
        return _parallel_rank(int(rank), int(world), store, out)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from custrings_tpu_torch import column, kernels
    from custrings_tpu_torch.ops import layout

    t_main = time.perf_counter()
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
    _launch_checks(torch, col)
    _scan_checks(torch, col)

    t0 = time.perf_counter()
    logs = make_logs(LOG_ROWS, seed=2)
    long_rows = make_long_logs(LONG_ROWS, seed=3)
    logs_s = time.perf_counter() - t0
    sets = _matcher_sets(logs, long_rows)
    t0 = time.perf_counter()
    want = _matcher_oracle(sets)
    rx_err = re.compile(ERR)
    err_starts = [-1 if s is None or (m := rx_err.search(s)) is None else m.start() for s in logs]
    oracle_s = time.perf_counter() - t0
    logs_col = column.from_host_strings(logs, "cuda")
    _emit({"phase": "logs", "rows": LOG_ROWS, "bytes": int(logs_col.offsets[-1]),
           "capacity": logs_col.capacity, "width": layout.max_row_bytes(logs_col),
           "long_rows": LONG_ROWS, "long_bytes": sum(len(s.encode()) for s in long_rows),
           "seconds": logs_s, "oracle_seconds": oracle_s})
    recs += _kernel_phase_rest(torch, col, logs_col, err_starts, long_rows)
    _compact_checks(torch, col.data)
    del logs_col
    (compacted, keep), compact_launches = _driven(torch, kernels, _run_compact, col.data)
    if not torch.equal(compacted[: int(keep.sum())], torch.masked_select(col.data, keep)):
        raise AssertionError("compact_bytes disagrees with torch.masked_select")
    del compacted, keep
    _view_phase(torch, col, width)
    del col
    torch.cuda.empty_cache()

    # first-use set-up (tables, regex compiles), then each path once
    _run_slice(torch, strs[:4096])
    _run_spans(torch, strs[:4096])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (results, rewrites, times, contains_calls), slice_launches = _driven(torch, kernels, _run_slice, strs)
    peak = torch.cuda.max_memory_allocated()
    bad, nkeys = _check_slice(strs, results)
    bad.update(_check_rewrites(strs, rewrites))
    op_s = sum(v for k, v in times.items() if k in ("contains", "replace", "dictionary_encode"))
    _emit({"phase": "slice", "rows": ROWS, "ms": {k: v * 1e3 for k, v in times.items()},
           "rows_per_s_contains_replace_encode": ROWS / op_s,
           "max_memory_allocated": peak, "keys": nkeys, "contains_engine_calls": contains_calls,
           "mismatches": bad})
    if any(bad.values()):
        raise AssertionError(f"slice output disagrees with the Python oracles: {bad}")
    relaunched = _relaunched({"contains": contains_calls})
    if relaunched or [c["engine"] for c in contains_calls] != ["K2"]:
        raise AssertionError(f"the slice's contains did not take K2 in one launch: {contains_calls}")

    torch.cuda.reset_peak_memory_stats()
    (sresults, stimes, span_calls), span_launches = _driven(torch, kernels, _run_spans, strs)
    speak = torch.cuda.max_memory_allocated()
    sbad = _check_spans(strs, sresults)
    _emit({"phase": "spans", "rows": ROWS, "ms": {k: v * 1e3 for k, v in stimes.items()},
           "all_spans_calls": span_calls, "matches": {"count": sum(sresults[0]),
           "findall_record": sum(len(r) for r in sresults[1] if r is not None)},
           "max_memory_allocated": speak, "mismatches": sbad})
    if any(sbad.values()):
        raise AssertionError(f"span ops disagree with Python re: {sbad}")
    relaunched = {op: [c["launches"] for c in cs] for op, cs in span_calls.items()
                  if any(c["rows"] and c["launches"] != 1 for c in cs)}
    if relaunched:
        raise AssertionError(f"all_spans calls that did not launch span_all exactly once: {relaunched}")

    # the matchers: first-use set-up (pattern compiles, tables) on a few
    # rows of each set, then the whole sets once
    _run_matchers(torch, [(n, rows[:64], f) for n, rows, f in sets])
    (mresults, mtimes, mpeaks, mcalls), matcher_launches = _driven(torch, kernels, _run_matchers, sets)
    mbad = {" ".join(k): _mismatches(mresults[k], want[k]) for k in want}
    mroutes = {" ".join(k): sorted({c["engine"] for c in v}) for k, v in mcalls.items()}
    off_route = {k: v for k, v in mroutes.items() if v != MATCHER_ROUTES[k.split(" ")[0]]}
    kernel_calls = {" ".join(k): [c["launches"] for c in v] for k, v in mcalls.items()
                    if v and v[0]["launches"] is not None}
    _emit({"phase": "matchers", "rows": {n: len(rows) for n, rows, _ in sets},
           "ms": {k: v * 1e3 for k, v in mtimes.items()}, "max_memory_allocated": mpeaks,
           "engines": mroutes, "kernel_launches_per_engine_call": kernel_calls,
           "true_rows": {" ".join(k): sum(bool(b) for b in v) for k, v in mresults.items()},
           "mismatches": mbad})
    if any(mbad.values()):
        raise AssertionError(f"matchers disagree with Python re: {mbad}")
    if off_route:
        raise AssertionError(f"matchers took other engines than {MATCHER_ROUTES}: {off_route}")
    relaunched = _relaunched({" ".join(k): v for k, v in mcalls.items()})
    if relaunched:
        raise AssertionError(f"K2/K2b matcher calls that did not launch their kernel once: {relaunched}")
    del mresults, want
    torch.cuda.empty_cache()

    hash_strs, hash_want = HASH_VECTOR
    if murmur3_np(hash_strs) != hash_want:
        raise AssertionError("the numpy MurmurHash3 oracle misses the reference vector")
    _run_hash(torch, hash_strs)  # first use
    (hashes, htimes, hpeaks), hash_launches = _driven(torch, kernels, _run_hash, strs)
    hbad = {"hash": _mismatches(hashes, murmur3_np(strs))}
    _emit({"phase": "hash", "rows": ROWS, "ms": {k: v * 1e3 for k, v in htimes.items()},
           "max_memory_allocated": hpeaks, "mismatches": hbad})
    if any(hbad.values()):
        raise AssertionError(f"hash disagrees with the numpy MurmurHash3: {hbad}")

    del hashes
    text_strs = make_text_rows(strs)
    t_text = time.perf_counter()
    _run_text(torch, text_strs[:4096])  # first use
    (tres, ttimes, tpeaks), text_launches = _driven(torch, kernels, _run_text, text_strs)
    t_check = time.perf_counter()
    tbad, ntokens, nvocab = _check_text(text_strs, tres)
    _emit({"phase": "text", "rows": ROWS, "rewritten_rows": sum(a != b for a, b in zip(strs, text_strs)),
           "ms": {k: v * 1e3 for k, v in ttimes.items()}, "max_memory_allocated": max(tpeaks.values()),
           "max_memory_allocated_by_op": tpeaks, "tokens": ntokens, "vocabulary": nvocab,
           "ngram_rows": NGRAM_ROWS, "sampled_rows": TEXT_SAMPLE,
           "oracle_seconds": time.perf_counter() - t_check,
           "phase_seconds": time.perf_counter() - t_text,
           "script_seconds_before_phase": t_text - t_main, "mismatches": tbad})
    if any(tbad.values()):
        raise AssertionError(f"text ops disagree with their Python oracles: {tbad}")
    del tres
    torch.cuda.empty_cache()
    # K1, K1b and K4c at the text path's own calls, each shape added to
    # its kernel's record (whose headline stays the first main-path shape)
    by_name = {r["name"]: r for r in recs}
    text_cases = [(name, src, rep, shapes, shapes[0][3]["bound"], None)
                  for name, src, rep, shapes in _text_kernel_shapes(torch, text_strs)]
    for t in _measure(torch, text_cases, slow=("window_words", "window_bytes"), phase="kernel_text"):
        by_name[t["name"]]["shapes"] += t["shapes"]
        by_name[t["name"]]["max_abs_err"] = max(by_name[t["name"]]["max_abs_err"], t["max_abs_err"])
    torch.cuda.empty_cache()

    # the cleanup chain: the tweet rows and CLEAN_EDGE_ROWS edge rows
    clean_strs = make_clean_rows(strs)
    t_clean = time.perf_counter()
    _run_clean(torch, clean_strs[-4096:])  # first use
    (cres, ctimes, cpeaks), clean_launches = _driven(torch, kernels, _run_clean, clean_strs)
    t_check = time.perf_counter()
    cbad, wrap_s = _check_clean(clean_strs, cres)
    _emit({"phase": "clean", "rows": len(clean_strs), "edge_rows": CLEAN_EDGE_ROWS,
           "ms": {k: v * 1e3 for k, v in ctimes.items()}, "max_memory_allocated": max(cpeaks.values()),
           "max_memory_allocated_by_op": cpeaks, "oracle_seconds": time.perf_counter() - t_check,
           "wrap_oracle_seconds": wrap_s, "phase_seconds": time.perf_counter() - t_clean,
           "script_seconds_before_phase": t_clean - t_main, "mismatches": cbad})
    if any(cbad.values()):
        raise AssertionError(f"clean ops disagree with their oracles: {cbad}")
    del cres
    torch.cuda.empty_cache()
    clean_cases = [(name, src, rep, shapes, shapes[0][3]["bound"], None)
                   for name, src, rep, shapes in _clean_kernel_shapes(torch, clean_strs)]
    for t in _measure(torch, clean_cases, slow=("window_words", "route_expand"), phase="kernel_clean"):
        by_name[t["name"]]["shapes"] += t["shapes"]
        by_name[t["name"]]["max_abs_err"] = max(by_name[t["name"]]["max_abs_err"], t["max_abs_err"])
    torch.cuda.empty_cache()

    # the conversion path: a CSV table of numbers, addresses, booleans,
    # timestamps and URLs read back with from_csv, parsed and formatted
    t_conv = time.perf_counter()
    table = make_convert_rows(ROWS, seed=7, tweets=strs)
    with tempfile.TemporaryDirectory() as tmp:
        head = os.path.join(tmp, "head.csv")
        write_csv({k: v[:4096] for k, v in table.items()}, head)
        _run_convert(torch, head)  # first use
        path = os.path.join(tmp, "convert.csv")
        csv_bytes = write_csv(table, path)
        (vres, vtimes, vpeaks), convert_launches = _driven(torch, kernels, _run_convert, path)
    t_check = time.perf_counter()
    vbad, gaps = _check_convert(table, vres)
    _emit({"phase": "convert", "rows": ROWS, "csv_bytes": csv_bytes, "url_edge_rows": CONVERT_EDGE_ROWS,
           "ms": {k: v * 1e3 for k, v in vtimes.items()}, "max_memory_allocated": max(vpeaks.values()),
           "max_memory_allocated_by_op": vpeaks, "stod_max_ulps": gaps["stod"], "stof_max_ulps": gaps["stof"],
           "oracle_seconds": time.perf_counter() - t_check, "phase_seconds": time.perf_counter() - t_conv,
           "script_seconds_before_phase": t_conv - t_main, "mismatches": vbad})
    if any(vbad.values()):
        raise AssertionError(f"convert ops disagree with their oracles: {vbad}")
    url_strs, float_strs = vres["from_csv(url)"], vres["from_csv(float)"]
    del vres, table
    torch.cuda.empty_cache()
    convert_cases = [(name, src, rep, shapes, shapes[0][3]["bound"], None)
                     for name, src, rep, shapes in _convert_kernel_shapes(torch, url_strs, float_strs)]
    for t in _measure(torch, convert_cases, slow=("route_expand",), phase="kernel_convert"):
        by_name[t["name"]]["shapes"] += t["shapes"]
        by_name[t["name"]]["max_abs_err"] = max(by_name[t["name"]]["max_abs_err"], t["max_abs_err"])
    del url_strs, float_strs
    torch.cuda.empty_cache()

    # the category path: a categorical column, a second sharing half its
    # keys, and numeric columns of the five key types, through every
    # method of nvcategory and numeric_category
    t_cat = time.perf_counter()
    cat_a, cat_b, _ = make_category_rows(ROWS, seed=8, b_rows=ROWS // 4)
    nums = make_numeric_columns(ROWS, seed=9, b_rows=ROWS // 4)
    data_s = time.perf_counter() - t_cat
    _run_category(torch, cat_a[:4096], cat_b[:4096],
                  {dt: (v[:4096], m[:512], vb[:4096], mb[:512]) for dt, (v, m, vb, mb) in nums.items()})
    torch.cuda.empty_cache()
    (gres, gtimes, gpeaks), category_launches = _driven(
        torch, kernels, lambda torch, _: _run_category(torch, cat_a, cat_b, nums), None)
    t_check = time.perf_counter()
    gbad = _check_category(cat_a, cat_b, nums, gres)
    _emit({"phase": "category", "rows": ROWS, "b_rows": len(cat_b), "keys": len(gres["from_strings"][0]),
           "numeric_keys": {dt: len(gres[f"numeric {dt}"]["from_numbers"][0])
                                                          for dt in nums},
           "ms": {k: v * 1e3 for k, v in gtimes.items()}, "max_memory_allocated": max(gpeaks.values()),
           "max_memory_allocated_by_op": gpeaks, "data_seconds": data_s,
           "oracle_seconds": time.perf_counter() - t_check, "phase_seconds": time.perf_counter() - t_cat,
           "script_seconds_before_phase": t_cat - t_main, "mismatches": gbad})
    if any(gbad.values()):
        raise AssertionError(f"category ops disagree with their oracles: {gbad}")
    del gres
    torch.cuda.empty_cache()
    category_cases = [(name, src, rep, shapes, shapes[0][3]["bound"], shapes[0][3].get("library"))
                      for name, src, rep, shapes in _category_kernel_shapes(torch, cat_a, nums)]
    for t in _measure(torch, category_cases, slow=("window_words",), phase="kernel_category"):
        by_name[t["name"]]["shapes"] += t["shapes"]
        by_name[t["name"]]["max_abs_err"] = max(by_name[t["name"]]["max_abs_err"], t["max_abs_err"])
    del cat_a, cat_b, nums
    torch.cuda.empty_cache()

    # the regex path: the span engines with capture groups and the
    # facade's extract, extract_record, replace_multi, replace_with_backrefs
    t_rx = time.perf_counter()
    rx_want = regex_oracle(strs, logs)
    rx_oracle_s = time.perf_counter() - t_rx
    warm = [None if x is None else x[:48] for x in strs[:512]]
    _run_regex(torch, warm, [None if x is None else x[:64] for x in logs[:512]])  # first use
    torch.cuda.empty_cache()
    (xres, xtimes, xpeaks, xlaunches), regex_launches = _driven(
        torch, kernels, lambda torch, _: _run_regex(torch, strs, logs), None)
    xbad = _check_regex(rx_want, xres)
    _emit({"phase": "regex", "rows": ROWS, "ip_rows": REGEX_IP_ROWS, "record_rows": REGEX_RECORD_ROWS,
           "words_rows": REGEX_WORDS_ROWS, "dfs_rows": REGEX_DFS_ROWS,
           "matches": {"extract": sum(x is not None for x in xres["extract"][0]), "count": sum(xres["count"]),
                       "count(dfs)": sum(xres["count(dfs)"])},
           "ms": {k: v * 1e3 for k, v in xtimes.items()}, "max_memory_allocated": max(xpeaks.values()),
           "max_memory_allocated_by_op": xpeaks, "launches_by_op": xlaunches, "oracle_seconds": rx_oracle_s,
           "phase_seconds": time.perf_counter() - t_rx, "script_seconds_before_phase": t_rx - t_main,
           "mismatches": xbad})
    if any(xbad.values()):
        raise AssertionError(f"regex ops disagree with Python re: {xbad}")
    del xres, rx_want
    torch.cuda.empty_cache()
    regex_cases = [(name, src, rep, shapes, shapes[0][3]["bound"], None)
                   for name, src, rep, shapes in _regex_kernel_shapes(torch, strs)]
    for t in _measure(torch, regex_cases, slow=("route_expand", "route_compact"), one_plain=("span_all",),
                      phase="kernel_regex"):
        by_name[t["name"]]["shapes"] += t["shapes"]
        by_name[t["name"]]["max_abs_err"] = max(by_name[t["name"]]["max_abs_err"], t["max_abs_err"])
    torch.cuda.empty_cache()

    # tracing: the slice's three ops once with the wrappers active
    trace_rows, same = _traced_slice(torch, strs[:65536])
    _emit({"phase": "tracing", "rows": 65536, "report": trace_rows, "results_identical": same})
    short = [op for op in TRACED_OPS if op not in trace_rows or trace_rows[op][0] < 1 or trace_rows[op][1] <= 0]
    if short or not same:
        raise AssertionError(f"tracing: ops without a calls >= 1, seconds > 0 record {short}, identical {same}")

    # the parallel path: a world of one over NCCL at the slice's 1M rows,
    # then two ranks over gloo sharing the card
    parallel_launches = _parallel_phase(torch, kernels, strs, t_main)

    paths = {"slice": slice_launches, "spans": span_launches, "matchers": matcher_launches,
             "hash": hash_launches, "compact": compact_launches, "text": text_launches,
             "clean": clean_launches, "convert": convert_launches, "category": category_launches,
             "regex": regex_launches, "parallel": parallel_launches}
    _emit({"phase": "launches", **paths})
    missing = []
    for path_name, need in (("slice", SLICE_KERNELS), ("spans", SPAN_KERNELS),
                            ("matchers", MATCHER_KERNELS), ("hash", HASH_KERNELS),
                            ("compact", COMPACT_KERNELS), ("text", TEXT_KERNELS),
                            ("clean", CLEAN_KERNELS), ("convert", CONVERT_KERNELS),
                            ("category", CATEGORY_KERNELS), ("regex", REGEX_KERNELS),
                            ("parallel", PARALLEL_KERNELS)):
        missing += [f"{path_name}: {k}" for k in need if paths[path_name][k] <= 0]
    if missing:
        raise AssertionError(f"kernels their path never launched: {missing}")

    for r in recs:
        r["launches"] = sum(p[r["name"]] for p in paths.values())
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
