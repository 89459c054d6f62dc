"""Split family: split / rsplit (record and column forms), partition and
rpartition, the ragged token split, and the token column type.

Port of `custrings_tpu/ops/split.py`.  Pandas semantics (split.cu:89-123,
whitespace :225-260): splitting "" on a delimiter gives one empty token, a
null row gives no tokens, and with a limit n the unused delimiters stay
inside the last token (the first, splitting from the right).  The
whitespace split collapses runs of whitespace, where whitespace is any
code point <= 0x20 (not Python's `str.isspace`); a row without a word
gives one empty token, and with a limit the last token keeps the rest of
the row verbatim (`' a b '.split(None, 1)` -> ['a', 'b ']).

A delimiter split is two monotone moves: the output bytes are the stable
compaction of the kept (non-delimiter) bytes (K4c), and the token end
offsets are the kept-byte counts at each delimiter, compacted to the
delimiter domain (K4c) and expanded into token slots (K4e).  The ragged
split (`run_ragged`, the whitespace split and nvtext's tokenizers) takes
token extents from a body; its bodies emit disjoint spans in source order,
so the token bytes are the compaction of the bytes the spans cover (K4c).
No capacity-sized gather.  The JAX ragged phases (`_ragged_counts`,
`_ragged_extents`, `_ragged_write`, the fused `_ragged_full` and the
count-first `_ragged_extents_write`) are `_ragged_counts`,
`_ragged_extents` (both routes: they differ only in how the token slots
are sized) and `_ragged_write` here, and `_tokens_from_extents` is
`_token_bytes`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, cumsum0, empty_column
from ..config import bucket_bytes
from ..utils import tracing
from . import layout, segments, shift_compact
from .array import _gather_impl
from .find import _find_impl, _match_mask, _pat_array
from .modify import _fit, _greedy_select, _has_border
from .route import cover_spans
from .scan import cummax0_i32
from .substr import _span_column

_INF = 1 << 28


@dataclasses.dataclass(frozen=True)
class TokenColumn:
    """Ragged split result: flattened tokens + per-input-row token ranges
    (an Arrow list-of-strings column)."""

    tokens: StringColumn
    row_offsets: torch.Tensor  # int32[rows+1]
    row_validity: torch.Tensor  # bool[rows]

    @property
    def nrows(self) -> int:
        return self.row_offsets.shape[0] - 1

    def counts(self) -> torch.Tensor:
        return self.row_offsets[1:] - self.row_offsets[:-1]


def _empty_tokens(col: StringColumn) -> TokenColumn:
    return TokenColumn(
        empty_column(0, col.device),
        torch.zeros(1, dtype=torch.int32, device=col.device),
        torch.zeros(0, dtype=torch.bool, device=col.device),
    )


def _ragged_counts(col: StringColumn, body_fn, static_args, *args) -> int:
    """Total tokens of a split body's counts phase (one sync)."""
    with tracing.op("split.ragged_counts"):
        return int(body_fn(col, None, *static_args, *args).sum())


def _ragged_extents(col: StringColumn, body_fn, static_args, *args):
    """(counts int32[rows], starts int32[tcap], ends int32[tcap], bcap):
    the token extents of a body and a bound on their bytes.  Tokens are
    at most bytes + rows and their bytes at most the input's: under
    BOUND_SYNC_THRESHOLD the token slots are allocated at that bound
    without a sync (the fused route); over it the body's counts phase
    syncs the exact token count first (the count-first route)."""
    with tracing.op("split.ragged_extents"):
        tok_bound = col.capacity + col.size
        if tok_bound * 8 <= BOUND_SYNC_THRESHOLD and col.capacity <= BOUND_SYNC_THRESHOLD:
            tcap, bcap = bucket_bytes(tok_bound), col.capacity
        else:
            tcap = bucket_bytes(_ragged_counts(col, body_fn, static_args, *args))
            bcap = bucket_bytes(col.capacity)
        return (*body_fn(col, tcap, *static_args, *args), bcap)


def _ragged_write(col: StringColumn, starts, byte_off, bcap: int) -> torch.Tensor:
    """uint8[bcap]: the token bytes.  The spans are disjoint and in source
    order and byte_off is the prefix of their sizes, so the output is the
    stable compaction of the covered source bytes (K4c), at every size."""
    with tracing.op("split.ragged_write"):
        sizes = byte_off[1:] - byte_off[:-1]
        keep = cover_spans(starts, starts + sizes, sizes > 0, col.capacity)
        (data,), _ = shift_compact.compact_arrays(keep, [col.data], want_k0=False)
        return _fit(data, bcap)


def _token_bytes(col: StringColumn, starts, ends, total_tokens: int, bcap: int | None = None) -> StringColumn:
    """The flattened tokens of the extents [starts, ends) of the first
    total_tokens slots (all valid); without bcap the token bytes are
    synced to size the buffer."""
    tvalid = torch.arange(starts.shape[0], device=col.device) < total_tokens
    byte_off = cumsum0(torch.where(tvalid, ends - starts, 0))
    if bcap is None:
        bcap = bucket_bytes(int(byte_off[-1]))
    return StringColumn(
        _ragged_write(col, starts, byte_off, bcap),
        byte_off[: total_tokens + 1],
        torch.ones(total_tokens, dtype=torch.bool, device=col.device),
    )


def run_ragged(body_fn, col: StringColumn, *args, static_args=()) -> TokenColumn:
    """The TokenColumn of a split body.  body_fn(col, tcap, *static_args,
    *args) returns the counts int32[rows] when tcap is None, else (counts,
    starts int32[tcap], ends int32[tcap]) with each valid row's tokens in
    slots tok_off[r] .. tok_off[r+1]-1, disjoint and in source order."""
    if col.size == 0:
        return _empty_tokens(col)
    counts, starts, ends, bcap = _ragged_extents(col, body_fn, static_args, *args)
    tok_off = cumsum0(counts)
    return TokenColumn(_token_bytes(col, starts, ends, int(tok_off[-1]), bcap), tok_off, col.validity)


def _row_fenced_match(col: StringColumn, p, m: int, tail):
    """Delimiter-match mask fenced inside valid rows (null rows may own
    bytes; their delimiters must not count).  One u8 compare off the tail
    plane for m <= 255."""
    if m <= 255:
        if tail is None:
            tail = layout.tail_plane(col)
        return _match_mask(col.data, p) & (tail >= m)
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    row_end = segments.row_end_positions(col.offsets, cap)
    vb = segments.broadcast_rows_to_bytes(col.validity.to(torch.int32), col.offsets, cap) == 1
    return _match_mask(col.data, p) & (j + m <= row_end) & layout.valid_byte_mask(col) & vb


def _mirror(x: torch.Tensor, m: int) -> torch.Tensor:
    """x reversed and shifted so that an m-byte match starting at j starts
    at capacity - m - j (its own inverse on match masks)."""
    return torch.roll(x.flip(0), 1 - m)


def _picked(col: StringColumn, delim: str, tail, from_right: bool = False):
    """(delimiter byte length, picked bool[capacity]): the delimiters taken
    greedily left to right (right to left with `from_right`), inside valid
    rows.  Only a bordered delimiter's occurrences can overlap, and only
    then does the direction change which are taken: the right-to-left pick
    is the left-to-right pick of the mirrored buffer."""
    pat_b = delim.encode("utf-8")
    m = len(pat_b)
    match = _row_fenced_match(col, _pat_array(pat_b, col.device), m, tail)
    bordered = _has_border(pat_b)
    if from_right and bordered:
        return m, _mirror(_greedy_select(_mirror(match, m), m, True), m)
    return m, _greedy_select(match, m, bordered)


def _counts(col: StringColumn, dpr, maxsplit: int):
    """(delimiters used, tokens) per row from the delimiters per row."""
    used = dpr.clamp(max=maxsplit if maxsplit > 0 else _INF)
    return used, torch.where(col.validity, used + 1, 0)


def _set_row_ends(col: StringColumn, starts, ends, tok_off, tcap: int):
    """Each valid row's first token starts at its row start and its last
    token ends at its row end (slot tcap is a dump for null rows)."""
    first = torch.where(col.validity, tok_off[:-1], tcap).to(torch.int64)
    last = torch.where(col.validity, tok_off[1:] - 1, tcap).to(torch.int64)
    starts[first] = col.offsets[:-1]
    ends[last] = col.offsets[1:]


def _delim_body(col: StringColumn, tcap, delim: str, maxsplit: int, tail=None,
                from_right: bool = False):
    """Byte-domain token extents: counts int32[rows] (tcap None), or
    (counts, starts int32[tcap], ends int32[tcap]) byte extents by scatter."""
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    m, picked = _picked(col, delim, tail, from_right)
    pk0 = cumsum0(picked)
    dpr = segments.per_row_of_prefix(pk0, col.offsets)
    used, counts = _counts(col, dpr, maxsplit)
    if tcap is None:
        return counts

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    rank = pk0[:cap] - bcast(pk0[col.offsets[:-1].to(torch.int64)])
    if from_right:  # the quota takes each row's last delimiters
        rank = rank - bcast(dpr - used)
    dused = picked & (rank >= 0) & (rank < bcast(used)) if maxsplit > 0 or from_right else picked
    tok_off = cumsum0(counts)
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    ends = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    tbase = bcast(tok_off[:-1])
    starts[torch.where(dused, tbase + rank + 1, tcap).to(torch.int64)] = j + m
    ends[torch.where(dused, tbase + rank, tcap).to(torch.int64)] = j
    _set_row_ends(col, starts, ends, tok_off, tcap)
    return counts, starts[:tcap], ends[:tcap]


def _delim_extents_stream(col: StringColumn, tcap, delim: str, maxsplit: int, tail=None,
                          from_right: bool = False):
    """_delim_body's contract with no capacity-sized int32 plane past the
    delimiter compaction: the picked positions compact into the delimiter
    domain (K4c), and all slot arithmetic runs on [tcap] arrays, where the
    slot maps are monotone: compactions and expansions (K4e), not
    scatters.  The counts phase needs only the picked prefix."""
    cap = col.capacity
    dev = col.device
    m, picked = _picked(col, delim, tail, from_right)
    k0d = cumsum0(picked)
    o = col.offsets.to(torch.int64)
    dpr = k0d[o[1:]] - k0d[o[:-1]]
    used, counts = _counts(col, dpr, maxsplit)
    if tcap is None:
        return counts
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    (dpos,), _ = shift_compact.compact_arrays(picked, [j], want_k0=False)
    dpos = _fit(dpos, tcap)
    tok_off = cumsum0(counts)
    dof = cumsum0(dpr)
    q = torch.arange(tcap, dtype=torch.int32, device=dev)

    def dbcast(v):  # row values over the delimiter domain
        return segments.broadcast_rows_to_bytes(v, dof, tcap)

    u_rank = q - dbcast(dof[:-1])
    if from_right:  # the quota takes each row's last delimiters
        u_rank = u_rank - dbcast(dpr - used)
    live = (q < dof[-1]) & (u_rank >= 0) & (u_rank < dbcast(used))
    t_end = dbcast(tok_off[:-1]) + u_rank  # slot whose token ends here
    # compact the used delimiters first: with a quota the dropped ones make
    # t_end - q non-monotone; over consecutive used ranks it is monotone
    (cd, ct), k0l = shift_compact.compact_arrays(live, [dpos, t_end])
    live2 = q < k0l[-1]
    dist = torch.where(live2, ct - q, 0)
    (ends, starts0), _ = shift_compact.expand_to(live2, dist, [cd, cd + m], tcap + 1, False)
    # starts0 holds the value for slot t_end; the token after the
    # delimiter is slot t_end + 1
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=dev)
    starts[1:] = starts0[:tcap]
    _set_row_ends(col, starts, ends, tok_off, tcap)
    return counts, starts[:tcap], ends[:tcap]


def _token_ends(col: StringColumn, dvals, ddist, ndel, k0, tok_off, tcap: int):
    """byte_off int32[tcap+1]: token t ends at T[t]; the delimiter values
    dvals (kept-byte counts, compacted to the delimiter domain) move to
    their token slots by ddist (K4e), each valid row's last token ends at
    its kept count, and empty slots take the running max."""
    q = torch.arange(tcap, dtype=torch.int32, device=col.device)
    (T0,), _ = shift_compact.expand_arrays(q < ndel, ddist, [dvals], False)
    T = torch.cat([T0, torch.zeros(1, dtype=torch.int32, device=col.device)])
    last = torch.where(col.validity, tok_off[1:] - 1, tcap).to(torch.int64)
    T[last] = k0[col.offsets[1:].to(torch.int64)]
    return cummax0_i32(T[:tcap])


def _delim_full_fast(col: StringColumn, tcap: int, bcap: int, m: int, picked, tail):
    """No-quota split: the delimiters per row come from the keep
    compaction's own prefix (each delimiter drops m bytes of a valid row),
    and the delimiter-to-token move carries one int32 payload, its slot
    distance being a row constant over the delimiter domain."""
    cap = col.capacity
    if tail is None:
        tail = layout.tail_plane(col)
    if m == 1:
        inside = picked
    else:
        j = torch.arange(cap, dtype=torch.int32, device=col.device)
        last_d = segments.cummax(torch.where(picked, j, -1))
        inside = (last_d >= 0) & (j - last_d < m)
    (data,), k0 = shift_compact.compact_arrays((tail > 0) & ~inside, [col.data])
    o = col.offsets.to(torch.int64)
    kept_r = k0[o[1:]] - k0[o[:-1]]
    dpr = torch.where(col.validity, torch.div(col.lengths() - kept_r, m, rounding_mode="floor"), 0)
    counts = torch.where(col.validity, dpr + 1, 0)
    tok_off = cumsum0(counts)
    # kept-prefix value at each delimiter = where its token ends in the output
    (dk,), d0 = shift_compact.compact_arrays(picked, [k0[:cap]])
    dof = cumsum0(dpr)
    ddist = segments.broadcast_rows_to_bytes(tok_off[:-1] - dof[:-1], dof, tcap)
    byte_off = _token_ends(col, _fit(dk, tcap), ddist, d0[-1], k0, tok_off, tcap)
    return _fit(data, bcap), tok_off, byte_off


def _delim_full_bd(col: StringColumn, tcap: int, bcap: int, delim: str, maxsplit: int, tail=None,
                   from_right: bool = False):
    """The split in one pass over the byte domain: (data, tok_off,
    byte_off), with no capacity-sized scatter or gather."""
    m, picked = _picked(col, delim, tail, from_right)
    if maxsplit <= 0 and not from_right and m <= 255:
        return _delim_full_fast(col, tcap, bcap, m, picked, tail)
    cap = col.capacity
    pk0 = cumsum0(picked)
    dpr = segments.per_row_of_prefix(pk0, col.offsets)
    used, counts = _counts(col, dpr, maxsplit)
    tok_off = cumsum0(counts)

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    if maxsplit > 0 or from_right:
        rank = pk0[:cap] - bcast(pk0[col.offsets[:-1].to(torch.int64)])
        if from_right:  # the quota takes each row's last delimiters
            rank = rank - bcast(dpr - used)
        dused = picked & (rank >= 0) & (rank < bcast(used))
    else:
        dused = picked  # no quota: every picked delimiter is used
    vb = bcast(col.validity.to(torch.int32)) == 1
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    if m == 1:
        inside = dused
    else:
        last_d = segments.cummax(torch.where(dused, j, -1))
        inside = (last_d >= 0) & (j - last_d < m)
    keep = layout.valid_byte_mask(col) & ~inside & vb
    (data,), k0 = shift_compact.compact_arrays(keep, [col.data])
    # the q-th used delimiter ends token slot q + (tok_off - base) of its row
    base = cumsum0(torch.where(col.validity, used, 0))
    pre_dist = bcast(tok_off[:-1] - base[:-1])
    (dvals, ddist), u0 = shift_compact.compact_arrays(dused & vb, [k0[:cap], pre_dist])
    byte_off = _token_ends(col, _fit(dvals, tcap), _fit(ddist, tcap), u0[-1], k0, tok_off, tcap)
    return _fit(data, bcap), tok_off, byte_off


def _delim_split(col: StringColumn, delim: str, maxsplit: int, from_right: bool = False) -> TokenColumn:
    if len(delim) == 0:
        raise ValueError("empty delimiter")
    if col.size == 0:
        return _empty_tokens(col)
    m = len(delim.encode("utf-8"))
    tail = layout.tail_plane(col) if m <= 255 else None
    # each delimiter consumes m bytes: tokens <= bytes / m + rows
    tok_bound = col.capacity // m + col.size
    if tok_bound <= BOUND_SYNC_THRESHOLD and col.capacity <= BOUND_SYNC_THRESHOLD:
        tcap, bcap = bucket_bytes(tok_bound), col.capacity
    else:
        # over the threshold: sync the exact token count first (the
        # counts phase is one prefix, no move)
        total = _ragged_counts(col, _delim_extents_stream, (delim, maxsplit), tail, from_right)
        tcap, bcap = bucket_bytes(max(total, 1)), bucket_bytes(col.capacity)
    data, tok_off, byte_off = _delim_full_bd(col, tcap, bcap, delim, maxsplit, tail, from_right)
    total_tokens = int(tok_off[-1])
    tokens = StringColumn(
        data,
        byte_off[: total_tokens + 1],
        torch.ones(total_tokens, dtype=torch.bool, device=col.device),
    )
    return TokenColumn(tokens, tok_off, col.validity)


def _is_ws(cps: torch.Tensor) -> torch.Tensor:
    """The whitespace split's separators: every code point <= 0x20."""
    return cps <= 0x20


def _row_first_chars(cm, ncap: int) -> torch.Tensor:
    """bool[ncap]: the chars that begin a row."""
    first = torch.zeros(ncap, dtype=torch.bool, device=cm.char_offsets.device)
    first[cm.char_offsets[:-1].clamp(max=ncap - 1).to(torch.int64)] = True
    return first


def _word_marks(col: StringColumn, is_sep):
    """(char map, wstart, wend): bool[capacity] marks of the first and the
    last char of each word, a word being a run of chars inside one row for
    which is_sep(codepoint) is false."""
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    c = torch.arange(ncap, dtype=torch.int32, device=col.device)
    word = ~is_sep(cps) & (c < cm.cs0[-1])
    row_first = _row_first_chars(cm, ncap)
    no, yes = word.new_zeros(1), word.new_ones(1)
    prev_word = torch.cat([no, word[:-1]])
    next_word = torch.cat([word[1:], no])
    next_row_first = torch.cat([row_first[1:], yes])
    return cm, word & (row_first | ~prev_word), word & (next_row_first | ~next_word)


def _in_row_rank(marks, char_offsets):
    """(rank of each char among its row's marked chars, marks per row)."""
    ncap = marks.shape[0]
    m0 = cumsum0(marks)
    first = m0[char_offsets[:-1].to(torch.int64)]
    rank = m0[:ncap] - segments.broadcast_rows_to_bytes(first, char_offsets, ncap)
    return rank, segments.per_row_of_prefix(m0, char_offsets)


def _char_ends(col: StringColumn, cm) -> torch.Tensor:
    """int32[capacity]: the byte just past each char of the column."""
    cpos = cm.char_pos
    lead = col.data[cpos.clamp(0, col.capacity - 1).to(torch.int64)]
    return cpos + layout.char_width_from_lead(lead)


def _ws_body(col: StringColumn, tcap, maxsplit: int, from_right: bool):
    """The whitespace split's token extents (run_ragged's body contract):
    the words of each row, at most maxsplit + 1 tokens (all when
    maxsplit <= 0); at the limit the last token (from the right: the
    first) runs to the row's end (start); a row without a word has one
    empty token at its start."""
    cm, wstart, wend = _word_marks(col, _is_ws)
    co = cm.char_offsets
    ws_rank, words = _in_row_rank(wstart, co)
    T = maxsplit + 1 if maxsplit > 0 else _INF
    counts = torch.where(col.validity, words.clamp(min=1).clamp(max=T), 0)
    if tcap is None:
        return counts
    ncap = wstart.shape[0]
    over = col.validity & (words >= T)
    we_rank, _ = _in_row_rank(wend, co)
    cpos, cend = cm.char_pos, _char_ends(col, cm)

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, co, ncap)

    tok_off = cumsum0(counts)
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    ends = torch.zeros_like(starts)

    def put(dst, sel, slot, val):  # slot tcap takes the unselected lanes
        dst[torch.where(sel, slot, tcap).to(torch.int64)] = val

    tbase, counts_b, over_b = bcast(tok_off[:-1]), bcast(counts), bcast(over) == 1
    if not from_right:
        put(starts, wstart & (ws_rank < counts_b), tbase + ws_rank, cpos)
        last = (we_rank == counts_b - 1) & ~over_b
        put(ends, wend & ((we_rank < counts_b - 1) | last), tbase + we_rank, cend)
        put(ends, over, tok_off[1:] - 1, col.offsets[1:])
    else:
        shift = bcast(words) - counts_b
        ti_s, ti_e = ws_rank - shift, we_rank - shift
        put(starts, wstart & (ti_s >= over_b.to(torch.int32)) & (ti_s < counts_b), tbase + ti_s, cpos)
        put(ends, wend & (ti_e >= 0) & (ti_e < counts_b), tbase + ti_e, cend)
        put(starts, over, tok_off[:-1], col.offsets[:-1])
    empty = col.validity & (words == 0)
    put(starts, empty, tok_off[:-1], col.offsets[:-1])
    put(ends, empty, tok_off[:-1], col.offsets[:-1])
    return counts, starts[:tcap], ends[:tcap]


def split_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    """Each row split on `delimiter` (whitespace runs when None), at most
    n times (all when n <= 0)."""
    if delimiter is None:
        return run_ragged(_ws_body, col, static_args=(n, False))
    return _delim_split(col, delimiter, n)


def rsplit_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    """split_record with the limit applied from the right."""
    if delimiter is None:
        return run_ragged(_ws_body, col, static_args=(n, True))
    return _delim_split(col, delimiter, n, True)


def token_column_to_columns(tc: TokenColumn) -> list[StringColumn]:
    """Column-major view: result[i] holds token i of each row, null where a
    row has fewer tokens (split.cu column split:734)."""
    counts = tc.counts()
    ncols = int(counts.max()) if tc.nrows else 0
    lens = tc.tokens.lengths()
    out = []
    for i in range(ncols):
        idx = (tc.row_offsets[:-1] + i).clamp(max=max(tc.tokens.size - 1, 0)).to(torch.int64)
        colm = _gather_impl(tc.tokens, idx, bucket_bytes(int(lens[idx].sum())))
        out.append(_mask_column(colm, tc.row_validity & (i < counts)))
    return out


def _mask_column(col: StringColumn, valid: torch.Tensor) -> StringColumn:
    """Null out rows where ~valid (their bytes become empty)."""
    sizes = torch.where(valid, col.lengths(), 0)
    return _span_column(col.data, col.offsets[:-1], sizes, col.validity & valid)


def split_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    return token_column_to_columns(split_record(col, delimiter, n))


def rsplit_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    return token_column_to_columns(rsplit_record(col, delimiter, n))


def partition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    """Three columns [before, delimiter, after] split at the FIRST
    occurrence; a row without it gives [row, "", ""]; null rows stay null
    (split.cu partition:1165)."""
    return _partition(col, delimiter, False)


def rpartition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    """As partition at the LAST occurrence; a row without it gives
    ["", "", row]."""
    return _partition(col, delimiter, True)


def _partition(col: StringColumn, delimiter: str, from_right: bool) -> list[StringColumn]:
    d = delimiter.encode("utf-8")
    m, n, dev = len(d), col.size, col.device
    pat = _pat_array(d, dev)
    pos = _find_impl(col, pat, torch.zeros(n, dtype=torch.int32, device=dev),
                     torch.full((n,), -1, dtype=torch.int32, device=dev), from_right)
    found = pos >= 0
    # the match's char position -> its byte position
    cm = layout.char_map(col)
    dstart = layout.char_byte_pos(col, cm.char_offsets[:-1] + torch.where(found, pos, 0))
    lo, hi = col.offsets[:-1], col.offsets[1:]
    miss = lo if from_right else hi  # where a row without the delimiter splits
    pre_e = torch.where(found, dstart, miss)
    post_s = torch.where(found, dstart + m, miss)
    val = col.validity
    src = torch.cat([col.data, pat])  # the delimiter's bytes follow the column's
    return [
        _span_column(col.data, lo, torch.where(val, pre_e - lo, 0), val),
        _span_column(src, torch.full_like(lo, col.capacity), torch.where(val & found, m, 0), val),
        _span_column(col.data, post_s, torch.where(val, hi - post_s, 0), val),
    ]
