"""Where the port's slice spends its time at 1M rows, on one CUDA card.

    python3 profile_slice.py               # after chip_smoke.py has passed
    python3 profile_slice.py --all-spans   # the all_spans part alone
    python3 profile_slice.py --matchers    # the K2 / K2b matchers alone
    python3 profile_slice.py --ops dictionary_encode,replace_grow
                                           # the per-op rows of those ops alone
    python3 profile_slice.py --ops text    # the per-op rows of the text ops
    python3 profile_slice.py --ops clean   # the per-op rows of the clean ops
    python3 profile_slice.py --ops convert # the per-op rows of the conversion ops
    python3 profile_slice.py --ops category  # the per-op rows of the category ops
    python3 profile_slice.py --ops regex   # the per-op rows of the regex ops
    python3 profile_slice.py --compact     # compact_arrays at K4c's main-path calls

For each op of the slice (contains_re(#\\w+), replace_literal("the",
"THE"), dictionary_encode, the growing and shrinking replace_literal
("THEE", "T"), split_record(" ")), each span op (count_re("the|that"),
findall_record(#\\w+), replace_re((\\w+)@(\\w+))), hash and
compact_bytes(data, data != " ", capacity) on a fresh 1M-row column of
chip_smoke.make_corpus(), each text op of chip_smoke.py's text phase at
the op level (the whitespace and right-to-left splits, partition,
rpartition, and nvtext's ops) on chip_smoke.make_text_rows() of those
rows (the n-grams on the tokens of their first 2^17, the Porter measure
on their vocabulary), each op of chip_smoke.py's clean phase at the op
level (strip, the case maps, translate, the slices, the paddings, wrap,
the searches and compares, len and the predicates, cat, fillna, insert,
slice_replace, order and sort, scatter, append) on
chip_smoke.make_clean_rows() of those rows, each op of chip_smoke.py's
convert phase at the op level (the parsers, the formatters on the
parsers' results, url_encode, url_decode of its output and of the url
rows, get_info) on the columns of chip_smoke.make_convert_rows() as
from_csv reads them, each category op of chip_smoke.py's category phase
at the op level (category.py's build, lookups, gathers, row edits, keyset
algebra and merges on chip_smoke.make_category_rows(), numeric.py's
build and merge_and_remap at each key type of
chip_smoke.make_numeric_columns()), each op of chip_smoke.py's regex
phase at the op level (extract, replace_with_backrefs with two
templates, replace_multi_re, count_re and findall_record of URLs on the
tweets; replace_re of IPv4 addresses on the first 2^18 log rows; the
eight-word extract on the first 2^16 tweets; the DFS count on the first
4,096), and for each matcher of the
matchers phase (contains_re of ERR, ISO and MONTH on the 2^20 log rows of
chip_smoke.make_logs(), of BIG on their first 65,536, of ERR on the 2,048
long rows): the wall time without the profiler, and under torch.profiler
the wall time, the summed device time, the twelve device items that took
longest and the peak device memory above the op's input column.  Then
the parts of contains_re(#\\w+) and contains_re(ERR) timed alone with
CUDA events: the char matrix (for #\\w+ on the K1 window route the
package takes and on the streaming view) and the K2 wrapper; and the K2b
wrapper by program on the log rows (ERR, ERR without its word
boundaries, ISO, MONTH), each
unanchored and anchored (`--matchers` runs the ops on K2 and K2b and
these parts alone).  Then the three ops in sequence on a fresh column on
each padded-view route (the K1 window view the package takes, and the
streaming view forced through `layout.STREAM_VIEW_MIN`), alternated
stream, window, window, stream.
Last, DeviceProgram.all_spans per call on the tweet rows' [1M, 320] char
matrix for each span pattern of chip_smoke.py's span_all case, counts
only and with full planes: CUDA event ms, peak device memory above the
inputs, and the kernel launches of one call.  The all_spans part and the
matchers call only the package's
entry points, so they time an earlier tree's package the same way, with
that tree's package first on sys.path.  One JSON line each, after one
naming the package's directory.

`--compact` times shift_compact.compact_arrays, the entry point of the
package's compactions, at K4c's main-path calls on the tweet rows: the
width-64 view's u8[capacity] keep, the group representatives'
i64[1M], _replace_frame's gap compaction of the bytes and their
inserted-bytes counts (captured from replace_with_backrefs) and the
whitespace split writer's (captured from split_record(None) on
chip_smoke.make_text_rows()): CUDA event ms (median of 5) and 20 calls
back to back with the host's time a call, k0 written and, where the
package's compact_arrays takes want_k0, without k0.  It calls only the
package's entry points, so an earlier tree's package (first on sys.path)
is timed the same way, in turns with this one in one call.

`--ops a,b,...` runs the per-op rows of the named ops alone (names as in
the op table in main(); `text` names every text op, `clean` every clean
op, `convert` every conversion op, `category` every category op, `regex`
every regex phase op); they call only the package's entry points, so an earlier tree's
package is profiled the same way.  The kernels' own
times at the main path's calls are chip_smoke.py's kernel phase.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as cs


def _timed(torch, fn):
    """(fn's result, its wall ms with the device drained on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _kernel_ms(torch, nfa, chars, nch):
    """The K2 / K2b wrapper's ms on the char matrix, unanchored and
    anchored."""
    return {f"{'anchored' if a else 'unanchored'}_ms": cs._time_ms(torch, lambda: nfa.matches(chars, nch, a))
            for a in (False, True)}


def all_spans_part(torch, strs) -> None:
    """all_spans per call at [1M, 320] for each span kernel pattern."""
    from custrings_tpu_torch import column, kernels
    from custrings_tpu_torch.ops import layout
    from custrings_tpu_torch.regex import ops as rx

    col = column.from_host_strings(strs, "cuda")
    chars, nch = layout.char_matrix(col, layout.max_row_bytes(col))
    L = chars.shape[1]
    for pat in cs.SPAN_KERNEL_PATTERNS:
        dp = rx.get_program(pat)
        most = max(int(dp.all_spans(chars, nch, col.validity, L + 2, counts_only=True)[0].max()), 1)
        for label, R, co in (("counts only", L + 2, True), ("full planes", most, False)):
            call = lambda R=R, co=co: dp.all_spans(chars, nch, col.validity, R, counts_only=co)  # noqa: E731
            call()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            call()
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            peak = torch.cuda.max_memory_allocated() - base
            print(json.dumps({
                "part": "all_spans", "pattern": pat, "call": label, "Rcap": R,
                "shape": [int(chars.shape[0]), int(L)], "ms": cs._time_ms(torch, call),
                "peak_bytes_above_inputs": peak, "launches": launches,
            }), flush=True)


def compact_part(torch, strs) -> None:
    """compact_arrays at K4c's main-path calls, one JSON line a call and
    form (see the module's note)."""
    import inspect

    from custrings_tpu_torch import column
    from custrings_tpu_torch.ops import layout, shift_compact, split
    from custrings_tpu_torch.regex import ops as rx

    col = column.from_host_strings(strs, "cuda")
    keep, _, _, _ = cs._route_inputs(torch, col, layout.max_row_bytes(col))
    g = torch.Generator(device="cpu").manual_seed(0)
    torch.randint(-(1 << 30), 1 << 30, (col.size,), generator=g, dtype=torch.int32)  # chip_smoke's draws
    perm = torch.randperm(col.size, generator=g).cuda()
    first = torch.rand(col.size, generator=g).cuda() < 0.6
    with cs._Calls((shift_compact, "compact_arrays")) as gap:
        rx.replace_with_backrefs(col, cs.REGEX_EMAIL, cs.REGEX_SWAP)
    text = column.from_host_strings(cs.make_text_rows(strs), "cuda")
    with cs._Calls((shift_compact, "compact_arrays")) as ws:
        split.split_record(text, None)
    calls = [("width-64 view", keep, [col.data]), ("group representatives", first, [perm]),
             ("_replace_frame's gap bytes", *gap.calls[0][1][:2]),
             ("whitespace split writer", *ws.calls[0][1][:2])]
    takes_want = "want_k0" in inspect.signature(shift_compact.compact_arrays).parameters
    for label, k, planes in calls:
        forms = [("k0 written", {})] + ([("k0 not wanted", {"want_k0": False})] if takes_want else [])
        for how, kw in forms:
            fn = lambda k=k, planes=planes, kw=kw: shift_compact.compact_arrays(k, planes, **kw)  # noqa: E731
            b2b, host = cs._back_to_back_ms(torch, fn)
            names = "+".join(str(a.dtype).split(".")[-1] for a in planes)
            print(json.dumps({"part": "compact", "call": f"{names}[{k.shape[0]}] {label}", "form": how,
                              "ms": cs._time_ms(torch, fn), "ms_back_to_back": b2b,
                              "host_ms_back_to_back": host}), flush=True)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    import custrings_tpu_torch

    print(json.dumps({"package": custrings_tpu_torch.__path__[0]}), flush=True)
    if "--all-spans" in sys.argv[1:]:
        all_spans_part(torch, cs.make_corpus(cs.ROWS, seed=0))
        print(cs._nvidia_smi(), flush=True)
        return 0
    if "--compact" in sys.argv[1:]:
        compact_part(torch, cs.make_corpus(cs.ROWS, seed=0))
        print(cs._nvidia_smi(), flush=True)
        return 0
    from custrings_tpu_torch import category, column, numeric
    from custrings_tpu_torch.ops import (array, attrs, case, combine, compact, convert, datetime_k, find,
                                         format_k, hash, layout, modify, pad, split, strip, substr, unique,
                                         urlencode)
    from custrings_tpu_torch.utils import stats
    from custrings_tpu_torch.regex import ops as rx
    from custrings_tpu_torch.text import distance, ngram, token

    args = sys.argv[1:]
    matchers = "--matchers" in args
    only = args[args.index("--ops") + 1].split(",") if "--ops" in args else None

    ops = {
        "contains_re": ("tweets", lambda c: rx.contains_re(c, cs.PATTERN)),
        "replace_literal": ("tweets", lambda c: modify.replace_literal(c, "the", "THE")),
        "dictionary_encode": ("tweets", lambda c: unique.dictionary_encode(c)),
        "replace_grow": ("tweets", lambda c: modify.replace_literal(c, "the", "THEE")),
        "replace_shrink": ("tweets", lambda c: modify.replace_literal(c, "the", "T")),
        "split_record": ("tweets", lambda c: split.split_record(c, " ")),
        "count_re": ("tweets", lambda c: rx.count_re(c, cs.SPAN_COUNT)),
        "findall_record": ("tweets", lambda c: rx.findall_record(c, cs.SPAN_FIND)),
        "replace_re": ("tweets", lambda c: rx.replace_re(c, cs.SPAN_REPLACE, "EMAIL")),
        "hash": ("tweets", lambda c: hash.hash_mm3(c)),
        "compact_bytes": ("tweets", lambda c: compact.compact_bytes(c.data, c.data != 32, c.capacity)),
        "contains_re ERR (K2b)": ("logs", lambda c: rx.contains_re(c, cs.ERR)),
        "contains_re ISO (K2b)": ("logs", lambda c: rx.contains_re(c, cs.ISO)),
        "contains_re MONTH (K2b)": ("logs", lambda c: rx.contains_re(c, cs.MONTH)),
        "contains_re BIG (vector)": ("logs_big", lambda c: rx.contains_re(c, cs.BIG)),
        "contains_re ERR (chunked)": ("long", lambda c: rx.contains_re(c, cs.ERR)),
    }
    cols = {}  # the text ops' second columns, made at their first (warm-up) call

    def made(key):
        if key not in cols:
            cols[key] = column.from_host_strings(list(corpora[key]), "cuda")
        return cols[key]

    text_ops = {
        "split_ws": ("text", lambda c: split.split_record(c, None)),
        "split_ws_2": ("text", lambda c: split.split_record(c, None, 2)),
        "rsplit_ws_2": ("text", lambda c: split.rsplit_record(c, None, 2)),
        "rsplit_space_1": ("text", lambda c: split.rsplit_record(c, " ", 1)),
        "partition": ("text", lambda c: split.partition(c, " ")),
        "rpartition": ("text", lambda c: split.rpartition(c, "#")),
        "tokenize": ("text", lambda c: token.tokenize(c)),
        "token_count": ("text", lambda c: token.token_count(c)),
        "unique_tokens": ("text", lambda c: token.unique_tokens(c)),
        "tokens_counts": ("text", lambda c: token.tokens_counts(c, made("targets"))),
        "contains_strings": ("text", lambda c: token.contains_strings(c, made("targets"))),
        "strings_counts": ("text", lambda c: token.strings_counts(c, made("targets"))),
        "normalize_spaces": ("text", lambda c: token.normalize_spaces(c)),
        "replace_tokens": ("text", lambda c: token.replace_tokens(c, made("replace targets"),
                                                                   made("replacements"))),
        "ngrams": ("text head tokens", lambda c: ngram.create_ngrams(c, 2)),
        "edit_distance": ("text", lambda c: distance.edit_distance_scalar(c, cs.DISTANCE_TARGET)),
        "edit_distance_pairwise": ("text", lambda c: distance.edit_distance_pairwise(c, made("text THE"))),
        "porter_stemmer_measure": ("vocabulary", lambda c: distance.porter_stemmer_measure(c)),
    }
    def per_row(key):  # the find_from starts and the scatter indexes, on the card
        if key not in cols:
            starts, idx = cs._clean_inputs(len(corpora["clean"]))
            cols[key] = torch.tensor(starts if key == "starts" else idx, device="cuda")
        return cols[key]

    clean_ops = {
        "strip": ("clean", lambda c: strip.strip(c)),
        **{kind: ("clean", lambda c, k=kind: getattr(case, k)(c))
           for kind in ("lower", "upper", "title", "capitalize", "swapcase")},
        "translate": ("clean", lambda c: modify.translate(c, cs.CLEAN_TRANSLATE)),
        "slice(2, 40, 3)": ("clean", lambda c: substr.slice_chars(c, 2, 40, 3)),
        "get(0)": ("clean", lambda c: substr.get_char(c, 0)),
        "zfill(12)": ("clean", lambda c: pad.zfill(c, 12)),
        "center(40, *)": ("clean", lambda c: pad.center(c, cs.CLEAN_WIDTH, "*")),
        "wrap(40)": ("clean", lambda c: pad.wrap(c, cs.CLEAN_WIDTH)),
        "startswith": ("clean", lambda c: find.startswith(c, "RT")),
        "endswith": ("clean", lambda c: find.endswith(c, "!")),
        "find_from": ("clean", lambda c: find.find_from(c, "the", per_row("starts"))),
        "compare": ("clean", lambda c: find.compare(c, "m")),
        "match_strings": ("clean", lambda c: find.match_strings(c, made("clean stripped"))),
        "find_multiple": ("clean", lambda c: find.find_multiple(c, made("clean targets"))),
        "len": ("clean", lambda c: attrs.len_chars(c)),
        **{p: ("clean", lambda c, p=p: getattr(attrs, p)(c)) for p in cs.CLEAN_PREDICATES},
        "cat": ("clean", lambda c: combine.cat(c, c, "|", "-")),
        "fillna": ("clean", lambda c: modify.fillna_scalar(c, "-")),
        "insert": ("clean", lambda c: modify.insert(c, 5, "_X_")),
        "slice_replace": ("clean", lambda c: modify.slice_replace(c, 2, 6, "##")),
        **{f"order{key}": ("clean", lambda c, key=key: array.order(c, *key)) for key in cs.CLEAN_SORTS},
        "sort(2)": ("clean", lambda c: array.sort(c, 2)),
        "scatter": ("clean", lambda c: array.scatter(c, made("clean head"), per_row("idx"))),
        "scalar_scatter": ("clean", lambda c: array.scalar_scatter(c, made("X"), per_row("idx"))),
        "remove_strings": ("clean", lambda c: array.remove_strings(c, per_row("idx"))),
        "append": ("clean", lambda c: array.append([c, made("clean head")])),
    }
    def parsed(key):  # a parser's result on its whole column, made once
        if key not in cols:
            fn, src = {"stoi": (convert.stoi, "int"), "stol": (convert.stol, "int"),
                       "stof": (convert.stof, "float"), "stod": (convert.stod, "float"),
                       "ip2int": (convert.ip2int, "ip"), "to_booleans": (convert.to_booleans, "bool"),
                       "timestamp2int": (datetime_k.timestamp2int, "ts")}[key]
            cols[key] = fn(made(f"conv {src}"))
        return cols[key]

    convert_ops = {
        **{name: (f"conv {src}", lambda c, name=name: getattr(convert, name)(c))
           for name, src in (("stoi", "int"), ("stol", "int"), ("htoi", "hex"), ("stof", "float"),
                             ("stod", "float"), ("ip2int", "ip"), ("to_booleans", "bool"))},
        "timestamp2int": ("conv ts", lambda c: datetime_k.timestamp2int(c)),
        "timestamp2int(ms)": ("conv ts_ms", lambda c: datetime_k.timestamp2int(c, cs.TS_MS_FORMAT, "ms")),
        "itos": ("conv int", lambda c: format_k.itos_device(parsed("stoi"), c.validity)),
        "ltos": ("conv int", lambda c: format_k.itos_device(parsed("stol"), c.validity)),
        "ftos": ("conv float", lambda c: format_k.ftos_device(parsed("stof"), c.validity)),
        "dtos": ("conv float", lambda c: format_k.ftos_device(parsed("stod"), c.validity)),
        "int2ip": ("conv ip", lambda c: format_k.int2ip_device(parsed("ip2int"), c.validity)),
        "from_booleans": ("conv bool", lambda c: format_k.from_booleans_device(parsed("to_booleans"), "True",
                                                                               "False", c.validity)),
        "int2timestamp": ("conv ts", lambda c: format_k.int2timestamp_device(
            parsed("timestamp2int"), "s", datetime_k._compile(datetime_k.DEFAULT_FORMAT), c.validity,
            datetime_k._spec_len("f", "s"))),
        "url_encode": ("conv url", lambda c: urlencode.url_encode(c)),
        "url_decode(url_encode)": ("conv url encoded", lambda c: urlencode.url_decode(c)),
        "url_decode": ("conv url", lambda c: urlencode.url_decode(c)),
        "get_info": ("conv int", lambda c: stats.compute_statistics(c)),
    }
    def cat_of(key):  # a category of a category column, made once
        if f"category {key}" not in cols:
            cols[f"category {key}"] = (category.from_strings(made(key)) if key.startswith("cat ")
                                       else numeric.from_numbers(*corpora[key], device="cuda"))
        return cols[f"category {key}"]

    def cat_args(key):  # the key lists and indexes the category ops take, made once from the first category
        if key not in cols:
            keys = column.to_host_strings(cat_of("cat a").keys)
            K = len(keys)
            rng = np.random.default_rng(10)
            new = [k for k in corpora["cat b"][:20000] if k is not None][:2000]
            cols.update({"lookups": cs._category_lookups([k for k in keys if k is not None], rng),
                         "gidx": rng.integers(0, K, len(corpora["cat a"])).astype(np.int32),
                         "new keys": column.from_host_strings(new, "cuda"),
                         "gone keys": column.from_host_strings(keys[: K // 3], "cuda"),
                         "kept keys": column.from_host_strings(keys[K // 2:] + new, "cuda"),
                         "dropped rows": column.from_host_strings(keys[:20], "cuda")})
        return cols[key]

    category_ops = {
        "cat from_strings": ("cat a", lambda c: category.from_strings(c)),
        "cat from_strings(a, b)": ("cat a", lambda c: category.from_strings(c, made("cat b"))),
        "cat to_strings": ("cat a", lambda c: category.to_strings(cat_of("cat a"))),
        "cat value x100": ("cat a", lambda c: [category.value_of(cat_of("cat a"), k) for k in cat_args("lookups")]),
        "cat get_value_bounds x100": ("cat a", lambda c: [category.get_value_bounds(cat_of("cat a"), k)
                                                          for k in cat_args("lookups")]),
        "cat indexes_for_key x10": ("cat a", lambda c: [category.indexes_for_key(cat_of("cat a"), k)
                                                        for k in cat_args("lookups")[:10]]),
        "cat gather": ("cat a", lambda c: category.gather(cat_of("cat a"), cat_args("gidx"))),
        "cat gather_and_remap": ("cat a", lambda c: category.gather_and_remap(cat_of("cat a"),
                                                                               cat_args("gidx")[:4096])),
        "cat add_strings": ("cat a", lambda c: category.add_strings(cat_of("cat a"), made("cat b"))),
        "cat remove_strings": ("cat a", lambda c: category.remove_strings(cat_of("cat a"), cat_args("dropped rows"))),
        "cat add_keys": ("cat a", lambda c: category.add_keys(cat_of("cat a"), cat_args("new keys"))),
        "cat remove_keys": ("cat a", lambda c: category.remove_keys(cat_of("cat a"), cat_args("gone keys"))),
        "cat set_keys": ("cat a", lambda c: category.set_keys(cat_of("cat a"), cat_args("kept keys"))),
        "cat remove_unused_keys": ("cat a", lambda c: category.remove_unused_keys(
            category.gather(cat_of("cat a"), cat_args("gidx")[:4096]))),
        "cat merge_category": ("cat a", lambda c: category.merge_category(cat_of("cat a"), cat_of("cat b"))),
        "cat merge_and_remap": ("cat a", lambda c: category.merge_and_remap(cat_of("cat a"), cat_of("cat b"))),
        **{f"num from_numbers({dt})": ("cat a", lambda c, dt=dt: numeric.from_numbers(*corpora[f"num {dt}"], device="cuda"))
           for dt in cs.NUMERIC_DTYPES},
        **{f"num merge_and_remap({dt})": ("cat a", lambda c, dt=dt: numeric.merge_and_remap(
            cat_of(f"num {dt}"), cat_of(f"num {dt} b"))) for dt in cs.NUMERIC_DTYPES},
    }
    ops.update(text_ops)
    ops.update(clean_ops)
    ops.update(convert_ops)
    ops.update(category_ops)
    regex_ops = {
        "rx extract": ("tweets", lambda c: rx.extract(c, cs.REGEX_EMAIL)),
        "rx replace_with_backrefs": ("tweets", lambda c: rx.replace_with_backrefs(c, cs.REGEX_EMAIL, cs.REGEX_SWAP)),
        "rx replace_with_backrefs(\\0)": ("tweets", lambda c: rx.replace_with_backrefs(c, cs.REGEX_EMAIL,
                                                                                      cs.REGEX_WHOLE)),
        "rx replace_multi_re": ("tweets", lambda c: rx.replace_multi_re(c, list(cs.REGEX_MULTI[0]),
                                                                        list(cs.REGEX_MULTI[1]))),
        "rx count_re(url)": ("tweets", lambda c: rx.count_re(c, cs.REGEX_URL)),
        "rx findall_record(url)": ("tweets", lambda c: rx.findall_record(c, cs.REGEX_URL)),
        "rx replace_re(ip)": ("logs ip", lambda c: rx.replace_re(c, cs.REGEX_IP, "IP")),
        "rx extract(8 words)": ("tweets words", lambda c: rx.extract(c, cs.REGEX_WORDS)),
        "rx count_re(dfs)": ("tweets dfs", lambda c: rx.count_re(c, cs.REGEX_DFS)),
    }
    ops.update(regex_ops)
    if matchers:
        ops = {k: v for k, v in ops.items() if k == "contains_re" or k.endswith("(K2b)")}
    if only is not None:
        groups = {"text": text_ops, "clean": clean_ops, "convert": convert_ops, "category": category_ops,
                  "regex": regex_ops}
        only = [k for name in only for k in groups.get(name, [name])]
        unknown = set(only) - set(ops)
        if unknown:
            print(f"profile_slice: unknown ops {sorted(unknown)}; known: {sorted(ops)}", file=sys.stderr)
            return 2
        ops = {k: ops[k] for k in only}
    strs = cs.make_corpus(cs.ROWS, seed=0)
    corpora = {"tweets": strs}
    srcs = {src for src, _ in ops.values()}
    if srcs & {"logs", "logs_big", "logs ip"}:
        logs = cs.make_logs(cs.LOG_ROWS, seed=2)
        corpora.update({"logs": logs, "logs_big": logs[: cs.BIG_ROWS], "logs ip": logs[: cs.REGEX_IP_ROWS]})
    corpora.update({"tweets words": strs[: cs.REGEX_WORDS_ROWS], "tweets dfs": strs[: cs.REGEX_DFS_ROWS]})
    if "long" in srcs:
        corpora["long"] = cs.make_long_logs(cs.LONG_ROWS, seed=3)
    if srcs & {"text", "text head tokens", "vocabulary"}:
        text = cs.make_text_rows(strs)
        corpora.update({
            "text": text, "targets": cs.TEXT_TARGETS,
            "replace targets": [a for a, _ in cs.TEXT_REPLACE], "replacements": [b for _, b in cs.TEXT_REPLACE],
            "text head tokens": [t for x in text[: cs.NGRAM_ROWS] if x is not None
                                 for t in cs.ws_split(x, -1) if t],
            "vocabulary": sorted({t for x in text if x is not None for t in x.split(" ") if t}),
            "text THE": [None if x is None else x.replace("the", "THE") for x in text],
        })

    if "clean" in srcs:
        clean = cs.make_clean_rows(strs)
        _, idx = cs._clean_inputs(len(clean))
        corpora.update({
            "clean": clean, "clean stripped": [None if x is None else x.strip(" \n\t") for x in clean],
            "clean targets": list(cs.CLEAN_TARGETS), "clean head": clean[: len(idx)], "X": ["X"],
        })

    if any(src.startswith("conv ") for src in srcs):
        import urllib.parse

        table = cs.read_back_py(cs.make_convert_rows(cs.ROWS, seed=7))
        corpora.update({f"conv {k}": v for k, v in table.items()})
        corpora["conv url encoded"] = [None if x is None else urllib.parse.quote(x, safe="") for x in table["url"]]

    if "cat a" in srcs:
        cat_a, cat_b, _ = cs.make_category_rows(cs.ROWS, seed=8, b_rows=cs.ROWS // 4)
        corpora.update({"cat a": cat_a, "cat b": cat_b})
        for dt, (va, ma, vb, mb) in cs.make_numeric_columns(cs.ROWS, seed=9, b_rows=cs.ROWS // 4).items():
            corpora[f"num {dt}"] = (va, ~cs._bits_valid(ma, len(va)))
            corpora[f"num {dt} b"] = (vb, ~cs._bits_valid(mb, len(vb)))

    def fresh(src="tweets"):
        return column.from_host_strings(corpora[src], "cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").sum()
    for name, (src, fn) in ops.items():
        fn(fresh(src))  # warm-up: regex compile, tables, allocator
        c = fresh(src)
        _, cold = _timed(torch, lambda: fn(c))
        c = fresh(src)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            fn(c)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        cuda = torch.autograd.DeviceType.CUDA
        # the port's spans show on the device too, as user annotations
        # under their host names: left out of the device time
        host = {e.key for e in prof.key_averages() if e.device_type != cuda}
        ka = [e for e in prof.key_averages() if e.device_type != cuda or e.key not in host]
        dev_ms = sum(e.self_device_time_total for e in ka if e.device_type == cuda) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:12]
        print(json.dumps({
            "op": name, "wall_ms": cold, "wall_ms_profiled": wall, "device_ms": dev_ms,
            "peak_bytes_above_inputs": peak,
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top],
        }), flush=True)

    if only is not None:
        print(cs._nvidia_smi(), flush=True)
        return 0
    col = fresh()
    width = layout.max_row_bytes(col)
    na = torch.from_numpy(layout.row_nonascii_ids(col)).cuda()
    chars, nch = layout.char_matrix(col, width)
    print(json.dumps({
        "part": "contains_re",
        "char_matrix_stream_ms": cs._time_ms(
            torch, lambda: layout._char_matrix_hybrid(col, None, na, width, True)),
        "char_matrix_window_ms": cs._time_ms(
            torch, lambda: layout._char_matrix_hybrid(col, None, na, width, False)),
        **_kernel_ms(torch, rx._get_nfa(cs.PATTERN), chars, nch),
    }), flush=True)
    del col, chars, nch
    col = fresh("logs")
    lw = layout.max_row_bytes(col)
    na = torch.from_numpy(layout.row_nonascii_ids(col)).cuda()
    chars, nch = layout.char_matrix(col, lw)
    print(json.dumps({
        "part": "contains_re ERR (K2b)",
        "char_matrix_ms": cs._time_ms(torch, lambda: layout._char_matrix_hybrid(
            col, None, na, lw, layout._use_stream_view(col, lw))),
    }), flush=True)
    # K2b by program on the same rows: the log filters, and ERR without
    # its word boundaries (one closure variant)
    for pat in (cs.ERR, cs.ERR_NB, cs.ISO, cs.MONTH):
        nfa = rx._get_nfa(pat)
        print(json.dumps({
            "part": "K2b by program", "pattern": pat, "insts": nfa.I, "W32": nfa.W32, "U": nfa.U,
            **_kernel_ms(torch, nfa, chars, nch),
        }), flush=True)
    del col, chars, nch
    if matchers:
        print(cs._nvidia_smi(), flush=True)
        return 0

    # the slice's ops in sequence on each padded-view route (the K1 window
    # view, the package's route, and the streaming view forced), alternated
    # so drift shows, with the allocator already warm
    default_min = layout.STREAM_VIEW_MIN
    for route in ("stream", "window", "window", "stream"):
        layout.STREAM_VIEW_MIN = 0 if route == "stream" else default_min
        c = fresh()
        ms = {}
        _, ms["contains_re"] = _timed(torch, lambda: ops["contains_re"][1](c))
        r, ms["replace_literal"] = _timed(torch, lambda: ops["replace_literal"][1](c))
        _, ms["dictionary_encode"] = _timed(torch, lambda: ops["dictionary_encode"][1](r))
        print(json.dumps({"route": route, "ms": ms, "sum_ms": sum(ms.values())}), flush=True)
    layout.STREAM_VIEW_MIN = default_min
    all_spans_part(torch, strs)
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
