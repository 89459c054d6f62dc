"""Tokenizer and token ops (nvtext).

Port of `custrings_tpu/text/token.py` (tokens.cu).  A token is a run of
chars that are not delimiters (runs of delimiters are one separator, and
there are no empty tokens); the default delimiter set is every code point
<= 0x20, and an explicit delimiter string is a SET of characters
(tokens.cu:41-76).  The token extents come from the ragged split
(`split._word_marks` marks each token's first and last char, as the JAX
`token_extents` does, and `_tokenize_body` scatters their byte extents by
row and rank); the token bytes are its cover compaction (K4c).  The ops
that compare tokens (`tokens_counts`, `replace_tokens`) gather key words
at the token extents (K1b) without writing the tokens out, and the ops
that rebuild rows (`normalize_spaces`, `replace_tokens`) write them from
pieces (`combine.concat_pieces`).
"""

from __future__ import annotations

import torch

from ..column import StringColumn, cumsum0, row_ids_from_offsets, to_host_strings
from ..ops import array, segments, split
from ..ops.combine import concat_pieces
from ..ops.find import _match_mask, _pat_array, contains, count_literal
from ..ops.unique import unique_strings
from ..ops.window import ragged_gather_words


def _is_delim(cps: torch.Tensor, delimiter: str | None) -> torch.Tensor:
    if not delimiter:
        return split._is_ws(cps)
    m = torch.zeros_like(cps, dtype=torch.bool)
    for ch in set(delimiter):
        m |= cps == ord(ch)
    return m


def _tokenize_body(col: StringColumn, tcap, delimiter: str | None):
    """Token extents in run_ragged's body contract."""
    cm, tstart, tend = split._word_marks(col, lambda cps: _is_delim(cps, delimiter))
    co = cm.char_offsets
    ts_rank, counts = split._in_row_rank(tstart, co)
    counts = torch.where(col.validity, counts, 0)
    if tcap is None:
        return counts
    te_rank, _ = split._in_row_rank(tend, co)
    tbase = segments.broadcast_rows_to_bytes(cumsum0(counts)[:-1], co, tstart.shape[0])
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=col.device)
    ends = torch.zeros_like(starts)
    starts[torch.where(tstart, tbase + ts_rank, tcap).to(torch.int64)] = cm.char_pos
    ends[torch.where(tend, tbase + te_rank, tcap).to(torch.int64)] = split._char_ends(col, cm)
    return counts, starts[:tcap], ends[:tcap]


def tokenize_record(col: StringColumn, delimiter: str | None = None) -> split.TokenColumn:
    """All tokens per row as a ragged TokenColumn."""
    return split.run_ragged(_tokenize_body, col, static_args=(delimiter,))


def tokenize(col: StringColumn, delimiter: str | None = None) -> StringColumn:
    """The flattened token list (NVText::tokenize, tokens.cu:123)."""
    return tokenize_record(col, delimiter).tokens


def _token_spans(col: StringColumn, delimiter: str | None):
    """(tok_off int32[rows+1], starts int32[T], ends int32[T]): the byte
    extents of the column's T tokens, row by row (one sync for T)."""
    if col.size == 0:
        z = torch.zeros(0, dtype=torch.int32, device=col.device)
        return torch.zeros(1, dtype=torch.int32, device=col.device), z, z
    counts, starts, ends, _ = split._ragged_extents(col, _tokenize_body, (delimiter,))
    tok_off = cumsum0(counts)
    total = int(tok_off[-1])
    return tok_off, starts[:total], ends[:total]


def tokenize_strings(col: StringColumn, delims: StringColumn) -> StringColumn:
    """Tokenize on a list of delimiter STRINGS (NVText::tokenize(strs,
    delims), tokens.cu:158): scanning each row, the first listed delimiter
    matching at a position is taken and its bytes skipped; empty tokens
    are dropped from the flattened result."""
    dstrs = [d for d in to_host_strings(delims) if d]
    if not dstrs:
        return tokenize(col)
    cap, dev = col.capacity, col.device
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    row_end = segments.row_end_positions(col.offsets, cap)
    valid_byte = j < col.offsets[-1]
    first_id = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    dlen = torch.zeros(cap, dtype=torch.int32, device=dev)
    for i, d in enumerate(dstrs):
        db = d.encode("utf-8")
        hit = _match_mask(col.data, _pat_array(db, dev)) & (j + len(db) <= row_end) & valid_byte
        hit &= first_id < 0
        first_id = torch.where(hit, i, first_id)
        dlen = torch.where(hit, len(db), dlen)
    # the sequential skip with delimiters of several lengths: a scan of the
    # cover state (bytes of a taken delimiter still to skip)
    maxd = max(len(d.encode("utf-8")) for d in dstrs)
    if maxd == 1:
        picked = first_id >= 0
    else:
        dom = torch.arange(maxd, dtype=torch.int64, device=dev)
        T = torch.where((dom[None, :] == 0) & (first_id >= 0)[:, None],
                        (dlen.to(torch.int64) - 1).clamp(min=0)[:, None], (dom - 1).clamp(min=0)[None, :])
        comp = segments.compose_scan(T)
        s_in = torch.cat([comp.new_zeros(1), comp[:-1, 0]])
        picked = (first_id >= 0) & (s_in == 0)
    pk0 = cumsum0(picked)
    counts = torch.where(col.validity, segments.per_row_of_prefix(pk0, col.offsets) + 1, 0)
    tok_off = cumsum0(counts)
    tcap = int(tok_off[-1])
    rank = pk0[:cap] - segments.broadcast_rows_to_bytes(pk0[col.offsets[:-1].to(torch.int64)], col.offsets, cap)
    tbase = segments.broadcast_rows_to_bytes(tok_off[:-1], col.offsets, cap)
    starts = torch.zeros(tcap + 1, dtype=torch.int32, device=dev)
    ends = torch.zeros_like(starts)
    split._set_row_ends(col, starts, ends, tok_off, tcap)
    starts[torch.where(picked, tbase + rank + 1, tcap).to(torch.int64)] = j + dlen
    ends[torch.where(picked, tbase + rank, tcap).to(torch.int64)] = j
    # tokens.cu drops the empty tokens (remove_if w.second == 0)
    keep = ends[:tcap] > starts[:tcap]
    s, e = starts[:tcap][keep], ends[:tcap][keep]
    return split._token_bytes(col, s, e, s.shape[0])


def token_count(col: StringColumn, delimiter: str | None = " ") -> torch.Tensor:
    """int32[rows]: tokens per row (tokens.cu token_count:337); 0 for nulls."""
    if col.size == 0:
        return torch.zeros(0, dtype=torch.int32, device=col.device)
    return _tokenize_body(col, None, delimiter)


def unique_tokens(col: StringColumn, delimiter: str | None = " ") -> StringColumn:
    """The sorted unique tokens (tokens.cu unique_tokens:262)."""
    return unique_strings(tokenize(col, delimiter))


def _target_words(data, starts, lens, targets: StringColumn):
    """(token key words, target key words, target lengths) at the longest
    target's width (K1b): a longer token equals no target."""
    w = 4 * max(-(-int(targets.lengths().max()) // 4), 1) if targets.size else 4
    tw = array._mask_word_tails(ragged_gather_words(data, starts, w), lens)
    return tw, array._key_words(targets, w), targets.lengths()


def _first_equal(tw, lens, gw, glens) -> torch.Tensor:
    """int32[rows]: for each row of key words `tw` (lengths `lens`), the
    index of the first target (key words `gw`, lengths `glens`) equal to
    it, or -1."""
    ids = torch.full_like(lens, -1)
    for g in range(gw.shape[0] - 1, -1, -1):
        eq = (tw == gw[g]).all(dim=1) & (lens == glens[g])
        ids = torch.where(eq, g, ids)
    return ids


def _equal_ids(data, starts, lens, targets: StringColumn) -> torch.Tensor:
    """int32[T]: for each token extent, the index of the first target
    equal to it, or -1."""
    if targets.size == 0:
        return torch.full_like(lens, -1)
    tw, gw, glens = _target_words(data, starts, lens, targets)
    return _first_equal(tw, lens, gw, glens)


def tokens_counts(col: StringColumn, targets: StringColumn, delimiter: str | None = " ") -> torch.Tensor:
    """int32[rows, n_targets]: tokens equal to each target, per row
    (tokens.cu tokens_counts:440)."""
    tok_off, starts, ends = _token_spans(col, delimiter)
    n, k, T = col.size, targets.size, starts.shape[0]
    if T == 0 or k == 0:
        return torch.zeros((n, k), dtype=torch.int32, device=col.device)
    lens = ends - starts
    tw, gw, glens = _target_words(col.data, starts, lens, targets)
    ids = _first_equal(tw, lens, gw, glens)
    trow = row_ids_from_offsets(tok_off, T).to(torch.int64)
    counts = torch.bincount(trow * (k + 1) + torch.where(ids >= 0, ids, k), minlength=n * (k + 1))
    # a token counts for every target equal to it: a repeated target
    # takes the column of its first occurrence
    first = _first_equal(gw, glens, gw, glens).to(torch.int64)
    return counts.view(n, k + 1)[:, first].to(torch.int32)


def normalize_spaces(col: StringColumn) -> StringColumn:
    """Whitespace runs collapsed to one space, the ends trimmed
    (tokens.cu normalize_spaces:679): each row's tokens joined by " "."""
    tok_off, starts, ends = _token_spans(col, None)
    T, cap = starts.shape[0], col.capacity
    # pieces: a space, then a token; the space is empty before a row's first token
    first = torch.zeros(T + 1, dtype=torch.bool, device=col.device)
    first[torch.where(tok_off[1:] > tok_off[:-1], tok_off[:-1], T).to(torch.int64)] = True
    space = torch.where(first[:T], 0, 1).to(torch.int32)
    pstart = torch.stack([torch.full_like(starts, cap), starts], 1).flatten()
    psize = torch.stack([space, ends - starts], 1).flatten()
    src = torch.cat([col.data, _pat_array(" ", col.device)])
    return concat_pieces(src, pstart, psize, 2 * tok_off, col.validity)


def replace_tokens(col: StringColumn, targets: StringColumn, repls: StringColumn,
                   delimiter: str | None = None) -> StringColumn:
    """Tokens equal to targets[i] replaced by repls[i] (one repl serves
    every target), the text between tokens kept (tokens.cu
    replace_tokens:565)."""
    tok_off, starts, ends = _token_spans(col, delimiter)
    T, n, cap, dev = starts.shape[0], col.size, col.capacity, col.device
    lens = ends - starts
    tid = _equal_ids(col.data, starts, lens, targets)
    rid = tid.clamp(0, max(repls.size - 1, 0)).to(torch.int64)
    hit = tid >= 0
    trow = row_ids_from_offsets(tok_off, max(T, 1))[:T].to(torch.int64)
    lo, hi = col.offsets[:-1], col.offsets[1:]
    # pieces of row r: gap 0, token 0, gap 1, ..., token t-1, the last gap;
    # a gap runs from the previous token's end (the row start) to the
    # next token's start (the row end)
    t = torch.arange(T, device=dev)
    first = t == tok_off[trow]
    gap_s = torch.where(first, lo[trow], torch.cat([ends.new_zeros(1), ends[:-1]]))
    last_end = ends[(tok_off[1:] - 1).clamp(min=0).to(torch.int64)] if T else lo
    last_s = torch.where(tok_off[1:] > tok_off[:-1], last_end, lo)
    P = 2 * T + n
    pstart = torch.zeros(P, dtype=torch.int32, device=dev)
    psize = torch.zeros_like(pstart)
    g = 2 * t + trow
    pstart[g], psize[g] = gap_s, starts - gap_s
    pstart[g + 1] = torch.where(hit, cap + repls.offsets[:-1][rid], starts)
    psize[g + 1] = torch.where(hit, repls.lengths()[rid], lens)
    lg = (2 * tok_off[1:] + torch.arange(n, device=dev)).to(torch.int64)
    pstart[lg], psize[lg] = last_s, torch.where(col.validity, hi - last_s, 0)
    src = torch.cat([col.data, repls.data])
    rows = 2 * tok_off + torch.arange(n + 1, device=dev)
    return concat_pieces(src, pstart, psize, rows, col.validity)


def contains_strings(col: StringColumn, targets: StringColumn) -> torch.Tensor:
    """bool[rows, n_targets]: does each row contain each target
    (NVText.cu:32-68)."""
    return torch.stack([contains(col, t or "") for t in to_host_strings(targets)], dim=1)


def strings_counts(col: StringColumn, targets: StringColumn) -> torch.Tensor:
    """int32[rows, n_targets]: occurrences of each target in each row
    (NVText.cu:77-123)."""
    return torch.stack([count_literal(col, t or "") for t in to_host_strings(targets)], dim=1)


def scatter_count(col: StringColumn, counts) -> StringColumn:
    """Row i repeated counts[i] times (NVText.cu scatter_count:126)."""
    counts = torch.as_tensor(counts, dtype=torch.int64).to(col.device).clamp(min=0)
    return array.gather(col, torch.repeat_interleave(torch.arange(col.size, device=col.device), counts))
