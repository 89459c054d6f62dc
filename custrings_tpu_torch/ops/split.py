"""Delimiter split (record and column forms) and the token column type.

Port of `custrings_tpu/ops/split.py`: `TokenColumn`, `_ragged_counts`,
`_row_fenced_match`, `_delim_body`, `_delim_extents_stream`,
`_delim_full_fast`, `_delim_full_bd`, `_delim_split`, `split_record`,
`token_column_to_columns`, `_mask_column` and `split_columns`, with a
delimiter, splitting from the left.  Pandas semantics (split.cu:89-123):
splitting "" gives one empty token, a null row gives no tokens, and with a
limit n the unused delimiters stay inside the last token.

A split is two monotone moves: the output bytes are the stable compaction
of the kept (non-delimiter) bytes (K4c), and the token end offsets are the
kept-byte counts at each delimiter, compacted to the delimiter domain (K4c)
and expanded into token slots (K4e).  No capacity-sized scatter or gather.

Not ported yet (ROADMAP queue 1, item 5): the whitespace split
(`delimiter=None`, `_ws_body`), `rsplit_*` (the right-to-left quota and
mirrored greedy select of the same bodies), `partition` and `rpartition`;
they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, build_column, cumsum0, empty_column
from ..config import bucket_bytes
from . import layout, segments, shift_compact
from .array import _gather_impl
from .find import _match_mask, _pat_array
from .modify import _fit, _greedy_select, _has_border
from .scan import cummax0_i32

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


def _ragged_counts(col: StringColumn, body_fn, static_args, *args) -> int:
    """Total tokens of a split body's counts phase (one sync)."""
    return int(body_fn(col, None, *static_args, *args).sum())


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


def _picked(col: StringColumn, delim: str, tail):
    """(delimiter byte length, picked bool[capacity]): the delimiters taken
    greedily left to right, inside valid rows."""
    pat_b = delim.encode("utf-8")
    m = len(pat_b)
    match = _row_fenced_match(col, _pat_array(pat_b, col.device), m, tail)
    return m, _greedy_select(match, m, _has_border(pat_b))


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


def _delim_body(col: StringColumn, tcap, delim: str, maxsplit: int, tail=None):
    """Byte-domain token extents: counts int32[rows] (tcap None), or
    (counts, starts int32[tcap], ends int32[tcap]) byte extents by scatter."""
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    m, picked = _picked(col, delim, tail)
    pk0 = cumsum0(picked)
    used, counts = _counts(col, segments.per_row_of_prefix(pk0, col.offsets), maxsplit)
    if tcap is None:
        return counts

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    rank = pk0[:cap] - bcast(pk0[col.offsets[:-1].to(torch.int64)])
    dused = picked & (rank < bcast(used)) if maxsplit > 0 else picked
    tok_off = cumsum0(counts)
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    ends = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    tbase = bcast(tok_off[:-1])
    starts[torch.where(dused, tbase + rank + 1, tcap).to(torch.int64)] = j + m
    ends[torch.where(dused, tbase + rank, tcap).to(torch.int64)] = j
    _set_row_ends(col, starts, ends, tok_off, tcap)
    return counts, starts[:tcap], ends[:tcap]


def _delim_extents_stream(col: StringColumn, tcap, delim: str, maxsplit: int, tail=None):
    """_delim_body's contract with no capacity-sized int32 plane past the
    delimiter compaction: the picked positions compact into the delimiter
    domain (K4c), and all slot arithmetic runs on [tcap] arrays, where the
    slot maps are monotone: compactions and expansions (K4e), not
    scatters.  The counts phase needs only the picked prefix."""
    cap = col.capacity
    dev = col.device
    m, picked = _picked(col, delim, tail)
    k0d = cumsum0(picked)
    o = col.offsets.to(torch.int64)
    dpr = k0d[o[1:]] - k0d[o[:-1]]
    used, counts = _counts(col, dpr, maxsplit)
    if tcap is None:
        return counts
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    (dpos,), _ = shift_compact.compact_arrays(picked, [j])
    dpos = _fit(dpos, tcap)
    tok_off = cumsum0(counts)
    dof = cumsum0(dpr)
    q = torch.arange(tcap, dtype=torch.int32, device=dev)

    def dbcast(v):  # row values over the delimiter domain
        return segments.broadcast_rows_to_bytes(v, dof, tcap)

    u_rank = q - dbcast(dof[:-1])
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


def _delim_full_bd(col: StringColumn, tcap: int, bcap: int, delim: str, maxsplit: int, tail=None):
    """The split in one pass over the byte domain: (data, tok_off,
    byte_off), with no capacity-sized scatter or gather."""
    m, picked = _picked(col, delim, tail)
    if maxsplit <= 0 and m <= 255:
        return _delim_full_fast(col, tcap, bcap, m, picked, tail)
    cap = col.capacity
    pk0 = cumsum0(picked)
    used, counts = _counts(col, segments.per_row_of_prefix(pk0, col.offsets), maxsplit)
    tok_off = cumsum0(counts)

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    if maxsplit > 0:
        rank = pk0[:cap] - bcast(pk0[col.offsets[:-1].to(torch.int64)])
        dused = picked & (rank < bcast(used))
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


def _delim_split(col: StringColumn, delim: str, maxsplit: int) -> TokenColumn:
    if len(delim) == 0:
        raise ValueError("empty delimiter")
    if col.size == 0:
        return TokenColumn(
            empty_column(0, col.device),
            torch.zeros(1, dtype=torch.int32, device=col.device),
            torch.zeros(0, dtype=torch.bool, device=col.device),
        )
    m = len(delim.encode("utf-8"))
    tail = layout.tail_plane(col) if m <= 255 else None
    # each delimiter consumes m bytes: tokens <= bytes / m + rows
    tok_bound = col.capacity // m + col.size
    if tok_bound <= BOUND_SYNC_THRESHOLD and col.capacity <= BOUND_SYNC_THRESHOLD:
        tcap, bcap = bucket_bytes(tok_bound), col.capacity
    else:
        # over the threshold: sync the exact token count first (the
        # counts phase is one prefix, no move)
        total = _ragged_counts(col, _delim_extents_stream, (delim, maxsplit), tail)
        tcap, bcap = bucket_bytes(max(total, 1)), bucket_bytes(col.capacity)
    data, tok_off, byte_off = _delim_full_bd(col, tcap, bcap, delim, maxsplit, tail)
    total_tokens = int(tok_off[-1])
    tokens = StringColumn(
        data,
        byte_off[: total_tokens + 1],
        torch.ones(total_tokens, dtype=torch.bool, device=col.device),
    )
    return TokenColumn(tokens, tok_off, col.validity)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item 5)")


def split_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    """Each row split on `delimiter`, at most n times (all when n <= 0)."""
    if delimiter is None:
        raise _not_ported("the whitespace split (delimiter=None, _ws_body)")
    return _delim_split(col, delimiter, n)


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
    starts = col.offsets[:-1]

    def produce(rows, k, vmask, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k)

    return build_column(sizes, col.validity & valid, produce)


def split_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    return token_column_to_columns(split_record(col, delimiter, n))


def rsplit_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    raise _not_ported("rsplit_record (the right-to-left split)")


def rsplit_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    raise _not_ported("rsplit_columns (the right-to-left split)")


def partition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    raise _not_ported("partition")


def rpartition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    raise _not_ported("rpartition")
