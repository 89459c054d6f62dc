"""Column-level regex ops: the boolean matchers and the span ops.

Port of `custrings_tpu/regex/ops.py`: `get_program`, `_matches`,
`contains_re`, `match_re`, `count_re`, `findall_spans`,
`findall_columns`, `findall_record`, `replace_re`, `extract`,
`extract_record`, `replace_multi_re` and `replace_with_backrefs`, on
every program the compiler accepts.  Patterns compile on the host once
per process; each length class of the column runs at its own width.
The kernels (K2, K2b, K5) read the full char tables, so an unbucketed
column is one call over all its rows; the torch engines (vector,
chunked, min-plus, ordered, DFS) run the packed-bit predicates on every
row of an ASCII-dominant column and re-run only its non-ASCII rows with
the 64K tables, as the JAX package does.

The boolean matchers route each length class as the JAX package does:
a width at or above the chunk threshold takes the chunked engine
(`DeviceProgram.nfa_matches_chunked`); otherwise a program of at most 32
instructions takes K2 (`nfa_bits`), one within K2b's instruction cap and
table budget takes K2b (`nfa_words`), and any other the vector engine
(`DeviceProgram.nfa_matches`).

The span ops take their spans from `DeviceProgram.all_spans` (K5 for a
certified program of <= 32 instructions, else the round loop of the torch
span engines).  The replacements that change sizes (`replace_multi_re`,
`replace_with_backrefs`) are written on the device by the routing
writers: the bytes between matches by a compaction (K4c) and an
expansion (K4e) into the output, the replacement bytes by
`route.stream_expand_spans`, with the prefix sums on K3.  The JAX
package's comparison routes (`CUSTRINGS_MULTI_HOST`, `CUSTRINGS_BREF_HOST`
and its host splicer) are not ported.
"""

from __future__ import annotations

import os
import re as _pyre
from functools import lru_cache

import numpy as np
import torch

from ..column import StringColumn, build_column, cumsum0, empty_column, row_ids_from_offsets
from ..config import bucket_bytes
from ..ops import layout, route, segments, shift_compact, substr
from ..ops.split import TokenColumn, _mask_column
from ..utils import tracing
from . import nfa_bits, nfa_words
from .compiler import compile_pattern
from .device import DeviceProgram


@lru_cache(maxsize=256)
def get_program(pattern: str) -> DeviceProgram:
    return DeviceProgram(compile_pattern(pattern))


@lru_cache(maxsize=256)
def _get_nfa(pattern: str):
    """The pattern's bit matcher: K2 (NFABits) for at most 32
    instructions, else K2b (NFAWords) where it takes the program, else
    None (the vector engine's programs)."""
    dp = get_program(pattern)
    if nfa_bits.pallas_supported(dp):
        return nfa_bits.NFABits(dp)
    if nfa_words.pallas_supported(dp):
        return nfa_words.NFAWords(dp)
    return None


def _chunk_size(width: int) -> int:
    """Chunk G ~ sqrt(width) rounded to a power of two (depth G + log C)."""
    g = 64
    while g * g < width:
        g *= 2
    return g


def _chunk_threshold() -> int:
    """Rows of at least this many chars take the chunked engine; the JAX
    package's CUSTRINGS_CHUNK_THRESHOLD moves it (the tests lower it on
    both sides)."""
    return int(os.environ.get("CUSTRINGS_CHUNK_THRESHOLD", "2048"))


def _matches(col: StringColumn, pattern: str, anchored: bool) -> torch.Tensor:
    """bool[rows]; null rows are False."""
    dp = get_program(pattern)
    nfa = _get_nfa(pattern)
    thresh = _chunk_threshold()

    def engine(chars, nch, ascii=False):
        width = int(chars.shape[1])
        with tracing.op("regex.engine"):
            if width >= thresh:
                return dp.nfa_matches_chunked(chars, nch, anchored, _chunk_size(width), ascii)
            if nfa is not None:
                return nfa.matches(chars, nch, anchored)
            return dp.nfa_matches(chars, nch, anchored, ascii)

    if col.size == 0:
        return torch.zeros(0, dtype=torch.bool, device=col.device)
    bks = layout.length_buckets(col)
    if bks is None:
        chars, nch = layout.char_matrix(col)
        if nfa is not None and int(chars.shape[1]) < thresh:
            return engine(chars, nch) & col.validity  # K2 / K2b: one launch
        na = layout.row_nonascii_ids(col)
        if len(na) * 8 <= max(col.size, 1):
            m = engine(chars, nch, ascii=True)
            if len(na):
                nad = torch.from_numpy(na).to(col.device)
                m[nad] = engine(chars[nad], nch[nad])
            return m & col.validity
        return engine(chars, nch) & col.validity
    out = torch.zeros(col.size + 1, dtype=torch.bool, device=col.device)
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        out[bk.idx_s] = engine(chars, nch) & bk.vmask
    return out[: col.size]


def contains_re(col: StringColumn, pattern: str) -> torch.Tensor:
    """bool[rows]: the pattern matches somewhere in the row."""
    return _matches(col, pattern, False)


def match_re(col: StringColumn, pattern: str) -> torch.Tensor:
    """bool[rows]: the pattern matches at position 0."""
    return _matches(col, pattern, True)


def _all_spans_device(col: StringColumn, pattern: str):
    """(counts int32[n], B int32[n, W], E int32[n, W]) device tensors for an
    unbucketed column.  On K5 the planes are [n, L + 2], or, when those
    would be large, as wide as a counts-only pass and one scalar sync
    find; the torch engines' round loop grows its planes a round at a
    time, so they are as wide as the most matches a row has.  The torch
    engines run every row of an ASCII-dominant column with the packed-bit
    predicates and re-run only its non-ASCII rows with the 64K tables;
    K5 reads the char tables, so it takes every row in one call."""
    dp = get_program(pattern)
    chars, nch = layout.char_matrix(col)
    if dp._span_bits() is not None:
        Rcap = int(chars.shape[1]) + 2
        if col.size * Rcap > (1 << 24):
            # [n, Rcap] planes would be GBs at the 1M tier: bound the round
            # count with a counts-only pass and one scalar sync first
            Rcap = max(int(count_re(col, pattern).max()), 1)
        return dp.all_spans(chars, nch, col.validity, Rcap)
    na = layout.row_nonascii_ids(col)
    if len(na) * 8 > max(col.size, 1):
        return dp.all_spans(chars, nch, col.validity, None)
    counts, B, E = dp.all_spans(chars, nch, col.validity, None, True)
    if len(na):
        nad = torch.from_numpy(na).to(col.device)
        c2, B2, E2 = dp.all_spans(chars[nad], nch[nad], col.validity[nad], None)
        W = max(B.shape[1], B2.shape[1])
        B, E, B2, E2 = (torch.nn.functional.pad(x, (0, W - x.shape[1]), value=-1) for x in (B, E, B2, E2))
        counts[nad], B[nad], E[nad] = c2, B2, E2
    return counts, B, E


def _all_spans_host(col: StringColumn, pattern: str):
    """(counts int32[n], B int64[n, rounds], E int64[n, rounds]) numpy.
    Each length class runs its own all_spans at its own width and round
    cap; the bucket results assemble on the host."""
    bks = layout.length_buckets(col)
    if bks is None:
        counts, B, E = (t.cpu().numpy() for t in _all_spans_device(col, pattern))
        return counts, B.astype(np.int64), E.astype(np.int64)
    dp = get_program(pattern)
    n = col.size
    fetched = []
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        fetched.append([t.cpu().numpy() for t in dp.all_spans(chars, nch, bk.vmask, bk.width + 2)])
    counts = np.zeros(n, np.int32)
    for bk, (c_b, _, _) in zip(bks, fetched):
        counts[bk.idx_np] = c_b[: bk.nv]
    rounds = max(int(counts.max(initial=0)), 1)
    B = np.full((n, rounds), -1, np.int64)
    E = np.full((n, rounds), -1, np.int64)
    for bk, (_, b_b, e_b) in zip(bks, fetched):
        r_b = min(rounds, b_b.shape[1])
        B[bk.idx_np, :r_b] = b_b[: bk.nv, :r_b]
        E[bk.idx_np, :r_b] = e_b[: bk.nv, :r_b]
    return counts, B, E


def _iter_spans(col: StringColumn, pattern: str):
    """Per round r: (hit, begin, end) numpy views of the r-th match of
    every row (non-overlapping leftmost matches, count.cu:178-190)."""
    if col.size == 0:
        return
    counts, B, E = _all_spans_host(col, pattern)
    for r in range(int(counts.max(initial=0))):
        yield r < counts, B[:, r], E[:, r]


def count_re(col: StringColumn, pattern: str) -> torch.Tensor:
    """int32[rows] match counts (count.cu:178-199); null rows count 0."""
    if col.size == 0:
        return torch.zeros(0, dtype=torch.int32, device=col.device)
    dp = get_program(pattern)
    bks = layout.length_buckets(col)
    if bks is None:
        chars, nch = layout.char_matrix(col)
        return dp.all_spans(chars, nch, col.validity, int(chars.shape[1]) + 2, counts_only=True)[0]
    out = torch.zeros(col.size + 1, dtype=torch.int32, device=col.device)
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        out[bk.idx_s] = dp.all_spans(chars, nch, bk.vmask, bk.width + 2, counts_only=True)[0]
    return out[: col.size]


def findall_spans(col: StringColumn, pattern: str):
    """list of per-round (hit, begin, end) numpy arrays."""
    return list(_iter_spans(col, pattern))


def findall_columns(col: StringColumn, pattern: str) -> list[StringColumn]:
    """Column-major findall (findall.cu:99): column i holds each row's
    i-th match, null where the row has fewer."""
    out = []
    for hit, b, e in findall_spans(col, pattern):
        sub = substr.slice_from(col, np.where(hit, b, 0), np.where(hit, np.maximum(e, 1), 0))
        sub = _mask_column(sub, torch.from_numpy(hit).to(col.device))
        # an empty match must stay "", not the slice's stop <= 0 whole row
        out.append(_fix_empty(sub, b, e, hit))
    return out


def _fix_empty(sub: StringColumn, b, e, hit) -> StringColumn:
    empty = hit & (e <= b)
    if not empty.any():
        return sub
    sizes = torch.where(torch.from_numpy(empty).to(sub.device), 0, sub.lengths())
    starts = sub.offsets[:-1]

    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(sub.data, bcast(starts) + k)

    return build_column(sizes, sub.validity, produce)


def findall_record(col: StringColumn, pattern: str):
    """Per-row list of matches (findall_record.cu:97) as a TokenColumn,
    assembled straight from the span matrix: a row's matches are a prefix
    of its rounds, so token k of row r is B[r, k - row_off[r]]."""
    n = col.size
    dev = col.device
    if n == 0:
        return TokenColumn(
            empty_column(0, dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev),
        )
    counts_np, B_np, E_np = _all_spans_host(col, pattern)
    counts = counts_np.astype(np.int64)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_off[1:])
    tok_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    li = np.arange(int(row_off[-1]), dtype=np.int64) - row_off[tok_rows]
    toks = _substr_tokens(col, tok_rows, B_np[tok_rows, li], E_np[tok_rows, li])
    return TokenColumn(toks, torch.from_numpy(row_off.astype(np.int32)).to(dev), col.validity)


def _char_to_byte_np(col: StringColumn):
    """(offsets int64 numpy, to_byte(rows, chars)): a translator from char
    positions (numpy) to byte positions (numpy), clipped into each row.
    The lookup runs where the char map lies, so only the queried positions
    cross between host and device, never the capacity-sized map."""
    cm = layout.char_map(col)
    offsets = col.offsets.cpu().numpy().astype(np.int64)
    dev = col.device
    char_pos = cm.char_pos if cm.char_pos.shape[0] else torch.zeros(1, dtype=torch.int32, device=dev)

    def to_byte(rows, chars):
        rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
        g = cm.char_offsets[rows_t].to(torch.int64) + torch.from_numpy(np.asarray(chars, np.int64)).to(dev)
        pos = torch.where(g >= cm.cs0[-1], col.offsets[-1], char_pos[g.clamp(max=char_pos.shape[0] - 1)])
        return np.clip(pos.cpu().numpy().astype(np.int64), offsets[rows], offsets[rows + 1])

    return offsets, to_byte


def _substr_tokens(col: StringColumn, tok_rows, b_chars, e_chars) -> StringColumn:
    """Char ranges (several per row allowed) copied into a new column."""
    _, to_byte = _char_to_byte_np(col)
    n = len(tok_rows)
    if n == 0:
        return empty_column(0, col.device)
    sb = to_byte(tok_rows, b_chars)
    eb = to_byte(tok_rows, e_chars)
    sizes = torch.from_numpy(np.maximum(eb - sb, 0).astype(np.int32)).to(col.device)
    sb_t = torch.from_numpy(sb.astype(np.int32)).to(col.device)

    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(sb_t) + k)

    return build_column(sizes, torch.ones(n, dtype=torch.bool, device=col.device), produce)


def replace_re(col: StringColumn, pattern: str, repl: str = "", n: int = -1) -> StringColumn:
    """Replace the first n (all when n < 0) non-overlapping matches in each
    row with `repl` (replace.cu replace_re:110)."""
    spans = []
    for i, span in enumerate(_iter_spans(col, pattern)):
        if 0 <= n <= i:
            break
        spans.append(span)
    return _splice(col, spans, repl)


def _splice(col: StringColumn, spans, repl) -> StringColumn:
    """Rebuild rows with each char-span match replaced by `repl`.

    Host piece model: every valid row becomes alternating keep / replace
    pieces and one tail piece; the output is one byte gather per piece
    byte on the device."""
    repl_b = repl.encode("utf-8") if isinstance(repl, str) else bytes(repl)
    n = col.size
    if not spans:
        return col
    H = np.stack([s[0] for s in spans]).astype(bool)
    Bm = np.stack([s[1] for s in spans]).astype(np.int64)
    Em = np.stack([s[2] for s in spans]).astype(np.int64)
    counts = H.sum(0).astype(np.int64)
    row_tok0 = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_tok0[1:])
    total_tok = int(row_tok0[-1])
    if total_tok == 0:
        return col
    # slot of hit (round i, row r) = row_tok0[r] + (hits of r before round i)
    slot = (row_tok0[None, :-1] + H.cumsum(0) - 1)[H]
    tb = np.zeros(total_tok, np.int64)
    te = np.zeros(total_tok, np.int64)
    tb[slot] = Bm[H]
    te[slot] = Em[H]

    offsets, to_byte = _char_to_byte_np(col)
    valid = col.validity.cpu().numpy()
    tok_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    sb = to_byte(tok_rows, tb)
    eb = to_byte(tok_rows, te)
    li = np.arange(total_tok, dtype=np.int64) - row_tok0[tok_rows]
    # bytes copied up to token k: the previous token's end, or the row start
    cur = np.where(li > 0, np.concatenate([[0], eb[:-1]]), offsets[tok_rows])
    cur = np.maximum(cur, offsets[tok_rows])

    row_p0 = np.zeros(n + 1, np.int64)
    np.cumsum(np.where(valid, 2 * counts + 1, 0), out=row_p0[1:])
    P = int(row_p0[-1])
    if P == 0:
        return col
    ps = np.zeros(P, np.int64)
    pe = np.zeros(P, np.int64)
    pr = np.zeros(P, np.bool_)
    tv = valid[tok_rows]
    keep_idx = (row_p0[tok_rows] + 2 * li)[tv]
    ps[keep_idx] = cur[tv]
    pe[keep_idx] = sb[tv]
    pe[keep_idx + 1] = len(repl_b)  # replace piece: repl bytes [0, len)
    pr[keep_idx + 1] = True
    vrows = np.nonzero(valid)[0]
    tail_idx = row_p0[vrows] + 2 * counts[vrows]
    last_eb = eb[np.maximum(row_tok0[vrows + 1] - 1, 0)]
    ps[tail_idx] = np.where(counts[vrows] > 0, np.maximum(last_eb, offsets[vrows]), offsets[vrows])
    pe[tail_idx] = offsets[vrows + 1]
    pb0 = np.zeros(P + 1, np.int64)
    np.cumsum(np.maximum(pe - ps, 0), out=pb0[1:])
    total = int(pb0[-1])

    dev = col.device
    bcap = bucket_bytes(total)
    j = torch.arange(bcap, dtype=torch.int32, device=dev)
    pb0_t = torch.from_numpy(pb0.astype(np.int32)).to(dev)
    pid = row_ids_from_offsets(pb0_t, bcap).to(torch.int64)
    src_pos = torch.from_numpy(ps.astype(np.int32)).to(dev)[pid] + (j - pb0_t[pid])
    rep_t = torch.from_numpy(np.frombuffer(repl_b or b"\0", np.uint8).copy()).to(dev)
    data = torch.where(
        torch.from_numpy(pr).to(dev)[pid],
        layout.gather_bytes(rep_t, src_pos),
        layout.gather_bytes(col.data, src_pos),
    )
    data = torch.where(j < total, data, torch.zeros((), dtype=torch.uint8, device=dev))
    out_offsets = torch.from_numpy(pb0[row_p0].astype(np.int32)).to(dev)
    return StringColumn(data, out_offsets, col.validity)


def extract(col: StringColumn, pattern: str) -> list[StringColumn]:
    """A column per capture group: each row's group span in its first
    match (extract.cu:69), null where the row has no match or the group
    takes no part; [] for a pattern without groups.  The first match
    comes from the router (spans_single); each group from spans_exec
    anchored at the match's begin, on the matched rows."""
    dp = get_program(pattern)
    if dp.groups_count == 0:
        return []
    chars, nch = layout.char_matrix(col)
    n = col.size
    dev = col.device
    m0, b0, _ = dp.spans_single(chars, nch, torch.zeros(n, dtype=torch.int32, device=dev))
    rows = torch.nonzero(m0)[:, 0]
    out = []
    for g in range(1, dp.groups_count + 1):
        bg = torch.full((n,), -1, dtype=torch.int32, device=dev)
        eg = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if rows.numel():
            bg[rows], eg[rows] = dp._anchored(chars, nch, rows, b0[rows], g)
        ok = m0 & (bg >= 0) & (eg >= bg) & col.validity
        sub = substr.slice_from(col, torch.where(ok, bg, 0), torch.where(ok, eg.clamp(min=1), 0))
        sub = _mask_column(sub, ok)
        # an empty group must stay "", not the slice's stop <= 0 whole row
        out.append(_fix_empty(sub, bg.cpu().numpy(), eg.cpu().numpy(), ok.cpu().numpy()))
    return out


def extract_record(col: StringColumn, pattern: str) -> list[StringColumn]:
    """Row-major extract (extract_record.cu:96): the same group columns as
    extract(); the facade turns them into one record per row."""
    return extract(col, pattern)


def _copy_column(col: StringColumn) -> StringColumn:
    return StringColumn(col.data, col.offsets, col.validity)


def _multi_spans(dps, chars, lengths, validity):
    """All non-overlapping matches of any of several programs: per round,
    every program's first match from the row's begin, the earliest begin
    winning and a tie going to the lowest program index
    (replace_multi.cu:110), then the reference's advance rule.  Returns
    (counts int32[N], B, E, ID int32[N, R]) with R the most matches a row
    has (at least 1), -1 past a row's count.  Each round adds a column to
    the planes, so no counts-only pass is needed to size them.

    A program's first match from a begin is also its first match from any
    later begin up to that match's start (no match of it starts between),
    and a program without a match from a begin has none from a later one;
    so each round runs a program only on the active rows whose last match
    of it now starts before the begin."""
    N = chars.shape[0]
    dev = chars.device
    P = len(dps)
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    begins = torch.zeros(N, dtype=torch.int32, device=dev)
    active = validity.to(torch.bool)
    lens = lengths.to(torch.int32)
    # each program's latest first match per row (-1: none found yet or
    # none left), and whether the row has none left
    mb = torch.full((P, N), -1, dtype=torch.int32, device=dev)
    me = torch.full((P, N), -1, dtype=torch.int32, device=dev)
    gone = torch.zeros((P, N), dtype=torch.bool, device=dev)
    cols = []
    while True:
        if not bool(active.any()):
            break
        best_b = torch.full((N,), 1 << 30, dtype=torch.int32, device=dev)
        best_e = torch.zeros_like(best_b)
        best_id = torch.full_like(best_b, -1)
        for k, dp in enumerate(dps):
            rows = torch.nonzero(active & ~gone[k] & (mb[k] < begins))[:, 0]
            if rows.numel():
                sub = chars if rows.numel() == N else chars[rows]
                m, b, e = dp.spans_single(sub, lens[rows], begins[rows])
                mb[k, rows] = torch.where(m, b, -1)
                me[k, rows] = torch.where(m, e, -1)
                gone[k, rows] = ~m
            better = active & ~gone[k] & (mb[k] < best_b)
            best_b = torch.where(better, mb[k], best_b)
            best_e = torch.where(better, me[k], best_e)
            best_id = torch.where(better, k, best_id)
        hit = best_id >= 0
        rows = torch.nonzero(hit)[:, 0]
        if rows.numel() == 0:
            break
        counts += hit.to(torch.int32)
        cols.append(torch.stack([torch.where(hit, best_b, -1), torch.where(hit, best_e, -1), best_id]))
        b, e = best_b[rows], best_e[rows]
        nb = torch.where(e > b, e, begins[rows] + 1)
        begins[rows] = nb
        active = torch.zeros(N, dtype=torch.bool, device=dev)
        active[rows] = nb <= lens[rows]
    planes = torch.stack(cols, 2) if cols else torch.full((3, N, 1), -1, dtype=torch.int32, device=dev)
    return counts, planes[0], planes[1], planes[2]


def replace_multi_re(col: StringColumn, patterns: list[str], repls) -> StringColumn:
    """Apply several regexes in one pass (replace_multi.cu:110): at each
    step the earliest match wins, a tie going to the lowest pattern index.
    `repls`: one replacement a pattern, or one for all (a str or a
    one-entry list)."""
    if isinstance(repls, (list, tuple)):
        rl = list(repls)
        if len(rl) == 1 and len(patterns) > 1:
            rl = rl * len(patterns)
    else:
        rl = [repls] * len(patterns)
    if len(rl) != len(patterns):
        raise ValueError("repls must have 1 or len(patterns) entries")
    if col.size == 0:
        return col
    return _replace_multi_device(col, tuple(patterns), rl)


def _replace_multi_device(col: StringColumn, patterns, rl) -> StringColumn:
    """replace_multi_re on the device: one pass records every round's
    (begin, end, pattern id), and the output is written by _replace_frame
    (the bytes between matches) and stream_expand_spans (the replacement
    bytes)."""
    chars, nch = layout.char_matrix(col)
    dps = [get_program(p) for p in patterns]
    counts, B, E, ID = _multi_spans(dps, chars, nch, col.validity)
    if int(counts.max()) == 0:
        return _copy_column(col)
    dev = col.device
    c2b = _c2b_fn(col, layout.char_map(col), nch)
    Bb, Eb = c2b(B), c2b(E)
    hitm = B >= 0
    repl_tab = [r.encode("utf-8") if isinstance(r, str) else bytes(r) for r in rl]
    lens_tab = torch.tensor([len(r) for r in repl_tab], dtype=torch.int32, device=dev)
    IDc = ID.clamp(0, len(repl_tab) - 1).to(torch.int64)
    rep_sz = lens_tab[IDc]
    out_off, bcap, rep_start, out_data = _replace_frame(col, Bb, Eb, hitm, rep_sz)
    Lmax = max((len(r) for r in repl_tab), default=0)
    if Lmax:
        # [P, Lmax] padded table; each match's bytes by a row gather
        T = np.zeros((len(repl_tab), Lmax), np.uint8)
        for i, r in enumerate(repl_tab):
            T[i, : len(r)] = np.frombuffer(r, np.uint8)
        vals = torch.from_numpy(T).to(dev)[IDc.reshape(-1)]
        bcol = torch.arange(Lmax, dtype=torch.int32, device=dev)[None, :]
        live = hitm.reshape(-1)[:, None] & (bcol < rep_sz.reshape(-1)[:, None])
        (stream,), k0s = shift_compact.compact_arrays(live.reshape(-1), [vals.reshape(-1)])
        out_data = out_data + route.stream_expand_spans(
            stream, k0s[-1], rep_start.reshape(-1), torch.where(hitm, rep_sz, 0).reshape(-1),
            hitm.reshape(-1), bcap,
        )
    return StringColumn(out_data, out_off, col.validity)


def _c2b_fn(col: StringColumn, cm, nch):
    """Char -> byte positions for [n, R] planes: -1 stays -1, a position
    at or past the row's char count maps to the row's end offset."""
    cap = col.capacity
    co = cm.char_offsets[:-1][:, None]
    char_pos = cm.char_pos
    top = min(cap, char_pos.shape[0]) - 1

    def c2b(P):
        b = char_pos[(co + P).clamp(0, max(top, 0)).to(torch.int64)] if top >= 0 else torch.zeros_like(P)
        b = torch.where(P >= nch[:, None], col.offsets[1:][:, None], b)
        return torch.where(P < 0, -1, b).to(torch.int32)

    return c2b


def _replace_frame(col: StringColumn, Bb, Eb, hitm, rep_sz):
    """The size calculus and the bytes between matches of a span
    replacement.  Given byte match planes [n, R] and each match's
    replacement size: the output offsets (K3; one scalar sync for the
    total), the output capacity, each match's replacement start, and the
    output plane holding every byte outside the matches at its place (a
    K4c compaction of the gap bytes with their inserted-bytes-before
    count, then one K4e expansion by it).  Ref: replace_backref.cu:180."""
    cap = col.capacity
    dev = col.device
    off0 = col.offsets[:-1][:, None]
    msz = torch.where(hitm, Eb - Bb, 0)
    rep_sz = torch.where(hitm, rep_sz, 0).to(torch.int32)
    lens = col.offsets[1:] - col.offsets[:-1]
    out_lens = (lens - msz.sum(1) + rep_sz.sum(1)).to(torch.int32)
    out_off = cumsum0(out_lens)
    total = int(out_off[-1])  # scalar sync
    bcap = bucket_bytes(max(total, 1))
    rem_bef = (msz.cumsum(1) - msz).to(torch.int32)
    ins_bef = (rep_sz.cumsum(1) - rep_sz).to(torch.int32)
    rep_start = out_off[:-1, None] + (Bb - off0) - rem_bef + ins_bef
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    keep_gap = (j < col.offsets[-1]) & ~route.cover_spans(Bb, Eb, hitm, cap)
    # inserted bytes before each byte: a match adds its size at its end
    ins = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    ins.index_add_(0, torch.where(hitm, Eb, cap).reshape(-1).to(torch.int64), rep_sz.reshape(-1))
    ins_plane = segments.cumsum(ins[:cap])
    (gdata, gins), k0g = shift_compact.compact_arrays(keep_gap, [col.data, ins_plane])
    (gap_plane,), _ = shift_compact.expand_to(j < k0g[-1], gins, [gdata], bcap, False)
    return out_off, bcap, rep_start, gap_plane


def replace_with_backrefs(col: StringColumn, pattern: str, repl: str) -> StringColumn:
    """Replace every non-overlapping match with the template `repl`, where
    \\N stands for group N's text in that match and \\0 for the whole match
    (replace_backref.cu:122; the template parse of backref.h:32-57).

    One all_spans call records each match's span and the spans of the
    template's groups.  The output is written on the device: the bytes
    between matches by _replace_frame, each group token's bytes by a
    cover mask, a compaction (K4c) and stream_expand_spans, the literals
    as a tiled constant expanded (K4e) in match-rank order.  The planes
    are as wide as the most matches a row has (on K5 a counts-only launch
    finds it; the torch engines' round loop grows them)."""
    tokens = _pyre.split(r"\\(\d+)", repl)
    lits = [t.encode("utf-8") for t in tokens[::2]]  # P + 1 literals
    gids = [int(t) for t in tokens[1::2]]  # P group refs between them
    dp = get_program(pattern)
    n = col.size
    if n == 0:
        return _copy_column(col)
    dev = col.device
    cap = col.capacity
    chars, nch = layout.char_matrix(col)
    exec_gids = tuple(sorted({g for g in gids if g != 0}))
    spans = dp.all_spans(chars, nch, col.validity, None, groups=exec_gids)
    if int(spans[0].max()) == 0:
        return _copy_column(col)
    B, E = spans[1], spans[2]
    gplane = dict(zip(exec_gids, spans[3])) if exec_gids else {}
    gplane[0] = (B, E)
    c2b = _c2b_fn(col, layout.char_map(col), nch)
    Bb, Eb = c2b(B), c2b(E)
    hitm = B >= 0
    gB, gE = {}, {}
    for g, (pb, pe) in gplane.items():
        bb, ee = c2b(pb), c2b(pe)
        ok = hitm & (bb >= 0) & (ee >= bb)
        gB[g], gE[g] = torch.where(ok, bb, 0), torch.where(ok, ee, 0)
    tok_sz = [gE[g] - gB[g] for g in gids]
    lit_total = sum(len(b) for b in lits)
    rep_sz = torch.full_like(Bb, lit_total)
    for sz in tok_sz:
        rep_sz = rep_sz + sz
    out_off, bcap, rep_start, out_data = _replace_frame(col, Bb, Eb, hitm, rep_sz)

    # piece starts inside a replacement: lit_0 g_0 lit_1 g_1 ... lit_P
    P = len(gids)
    lit_starts, tok_starts = [], []
    acc = rep_start
    for i in range(P + 1):
        lit_starts.append(acc)
        acc = acc + len(lits[i])
        if i < P:
            tok_starts.append(acc)
            acc = acc + tok_sz[i]

    # group tokens: compact the spans' bytes, expand them to their slots
    in_data = torch.arange(cap, dtype=torch.int32, device=dev) < col.offsets[-1]
    for ti, g in enumerate(gids):
        okt = hitm & (gE[g] > gB[g])
        inside = route.cover_spans(gB[g], gE[g], okt, cap) & in_data
        (tdata,), k0t = shift_compact.compact_arrays(inside, [col.data])
        out_data = out_data + route.stream_expand_spans(
            tdata, k0t[-1], tok_starts[ti].reshape(-1), tok_sz[ti].reshape(-1), okt.reshape(-1), bcap
        )

    # literals: a tiled constant expanded to each match's pieces, in match
    # rank order so every live lane precedes every dead one (lane (m, k)
    # holds byte k of the literal block of the m-th match)
    if lit_total:
        nR = hitm.numel()
        lit_cat = torch.from_numpy(np.frombuffer(b"".join(lits), np.uint8).copy()).to(dev)
        pmap = torch.tensor([i for i, lb in enumerate(lits) for _ in lb], dtype=torch.int64, device=dev)
        omap = torch.tensor([k for lb in lits for k in range(len(lb))], dtype=torch.int32, device=dev)
        hitf = hitm.reshape(-1)
        vps = torch.zeros((nR, P + 1), dtype=torch.int32, device=dev)
        vps[: int(hitf.sum())] = torch.stack(lit_starts, 2).reshape(nR, P + 1)[hitf]
        nv = hitf.sum()
        iv = torch.arange(nR, dtype=torch.int32, device=dev)[:, None]
        out_pos = vps[:, pmap] + omap[None, :]
        fi = iv * lit_total + torch.arange(lit_total, dtype=torch.int32, device=dev)[None, :]
        live = (iv < nv).expand(nR, lit_total)
        dist = torch.where(live, out_pos - fi, 0).reshape(-1)
        (lplane,), _ = shift_compact.expand_to(live.reshape(-1), dist, [lit_cat.repeat(nR)], bcap, False)
        out_data = out_data + lplane
    return StringColumn(out_data, out_off, col.validity)
