"""Column-level regex ops: the boolean matchers and the span ops.

Port of `custrings_tpu/regex/ops.py`: `get_program`, `_matches`,
`contains_re`, `match_re` (on every program and row width), and
`count_re`, `findall_spans`, `findall_columns`, `findall_record` and
`replace_re` with their helpers (on `DeviceProgram.all_spans` and the
span passes K5).  Patterns compile on the host once per process; each
length class of the column runs at its own width.  The kernels (K2, K2b,
K5) read the full char tables, so an unbucketed column is one call over
all its rows; the torch engines (vector, chunked) run the packed-bit
predicates on every row of an ASCII-dominant column and re-run only its
non-ASCII rows with the 64K tables, as the JAX package does.

The boolean matchers route each length class as the JAX package does:
a width at or above the chunk threshold takes the chunked engine
(`DeviceProgram.nfa_matches_chunked`); otherwise a program of at most 32
instructions takes K2 (`nfa_bits`), one within K2b's instruction cap and
table budget takes K2b (`nfa_words`), and any other the vector engine
(`DeviceProgram.nfa_matches`).

Not ported yet: span programs that are not certified (`longest_safe` or
`end_unique`) or over 32 instructions (the min-plus, ordered and DFS span
engines, ROADMAP queue 1, item 2); `extract`, `replace_multi_re` and
`replace_with_backrefs`.  These raise NotImplementedError.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..column import StringColumn, build_column, empty_column, row_ids_from_offsets
from ..config import bucket_bytes
from ..ops import layout, substr
from ..ops.split import TokenColumn, _mask_column
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


def _span_program(pattern: str) -> DeviceProgram:
    """The pattern's program, or NotImplementedError when the span passes
    (K5) cannot run it."""
    dp = get_program(pattern)
    try:
        dp._span_bits_or_raise()
    except NotImplementedError as e:
        raise NotImplementedError(f"pattern {pattern!r}: {e}") from None
    return dp


def _all_spans_device(col: StringColumn, pattern: str):
    """(counts int32[n], B int32[n, Rcap], E int32[n, Rcap]) device tensors
    for an unbucketed column.  ASCII-dominant columns take the packed-bit
    predicates and re-run only the non-ASCII rows with the 64K tables."""
    dp = _span_program(pattern)
    chars, nch = layout.char_matrix(col)
    Rcap = int(chars.shape[1]) + 2
    if col.size * Rcap > (1 << 24):
        # [n, Rcap] planes would be GBs at the 1M tier: bound the round
        # count with a counts-only pass and one scalar sync first
        Rcap = max(int(count_re(col, pattern).max()), 1)
    na = layout.row_nonascii_ids(col)
    if len(na) * 8 <= max(col.size, 1):
        counts, B, E = dp.all_spans(chars, nch, col.validity, Rcap, True)
        if len(na):
            nad = torch.from_numpy(na).to(col.device)
            c2, B2, E2 = dp.all_spans(chars[nad], nch[nad], col.validity[nad], Rcap)
            counts[nad], B[nad], E[nad] = c2, B2, E2
        return counts, B, E
    return dp.all_spans(chars, nch, col.validity, Rcap)


def _all_spans_host(col: StringColumn, pattern: str):
    """(counts int32[n], B int64[n, rounds], E int64[n, rounds]) numpy.
    Each length class runs its own all_spans at its own width and round
    cap; the bucket results assemble on the host."""
    bks = layout.length_buckets(col)
    if bks is None:
        counts, B, E = (t.cpu().numpy() for t in _all_spans_device(col, pattern))
        return counts, B.astype(np.int64), E.astype(np.int64)
    dp = _span_program(pattern)
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
    dp = _span_program(pattern)
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
