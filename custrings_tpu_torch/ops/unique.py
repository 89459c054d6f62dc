"""Dictionary encode: sorted unique keys and each row's key rank.

Port of `custrings_tpu/ops/unique.py`: `dictionary_encode` with its two
routes and the width escalation loop.

  sorted route (`_encode_sorted`, below HASHED_MIN rows): order every row
  by its packed key words, mark neighbours that differ, rank by a scan.

  hashed route (`_encode_hashed`, from HASHED_MIN rows): group rows by a
  32-bit hash of the key prefix (one stable single-key sort + exact
  neighbour compares; a hash collision can only split a group, never
  merge two keys), then run the full lexicographic order on the group
  representatives only.

Keys start as a 64-byte prefix.  A truncated tie between rows that are
longer than the prefix is checked exactly on the tails (K1b); only tails
that really differ make the column ambiguous, and then the prefix grows
64 -> 256 -> full width and the encode runs again.  Hash words are uint32
arithmetic carried in int64 and masked to 32 bits.
"""

from __future__ import annotations

import torch

from ..column import BOUND_SYNC_THRESHOLD, StringColumn, empty_column
from . import array, layout, segments
from .array import _mask_word_tails, lsd_order, u32_key
from .shift_compact import compact_arrays
from .window import ragged_gather_words

#: rows at or above this take the hash-grouped encode
HASHED_MIN = 1 << 18

_U32 = 0xFFFFFFFF


def _row_neq(sw, slen, sval):
    """(neq bool[n-1] of sorted neighbours, words_eq, both_null)."""
    words_eq = ~(sw[1:] != sw[:-1]).any(dim=1)
    both_null = (~sval[1:]) & (~sval[:-1])
    row_neq = ~words_eq | (slen[1:] != slen[:-1]) | (sval[1:] != sval[:-1])
    return row_neq & ~both_null, words_eq, both_null


def _tail_diff_vs(col: StringColumn, starts, slen, other_idx, width: int, tail_w: int):
    """bool[n]: does row i differ from row other_idx[i] in bytes
    [width, width + tail_w), over bytes live in both rows (K1b)?"""
    tw = -(-tail_w // 4) * 4
    tails = ragged_gather_words(col.data, starts + width, tw)
    rem = (slen - width).clamp(min=0)
    m = _mask_word_tails(torch.full_like(tails, -1), rem)
    mj = m & m[other_idx]
    return ((tails & mj) != (tails[other_idx] & mj)).any(dim=1)


def _encode_sorted(col: StringColumn, width: int, full_width: int):
    n = col.size
    dev = col.device
    ord_ = array._order_impl(col, width)
    words = array._key_words(col, width)
    sw = words[ord_]
    slen = col.lengths()[ord_]
    sval = col.validity[ord_]
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    ambiguous = torch.zeros((), dtype=torch.bool, device=dev)
    if n > 1:
        row_neq, words_eq, both_null = _row_neq(sw, slen, sval)
        neq[1:] = row_neq
        if width < full_width:
            # a truncated-word tie between rows longer than the prefix was
            # ordered by length; that is right iff the tails agree
            overflow = (slen[1:] > width) | (slen[:-1] > width)
            tied = words_eq & overflow & ~both_null
            starts_s = col.offsets[:-1][ord_]
            prev = torch.arange(-1, n - 1, device=dev).clamp(min=0)
            diff = _tail_diff_vs(col, starts_s, slen, prev, width, full_width - width)
            ambiguous = (tied & diff[1:]).any()
    ranks = segments.cumsum(neq)
    values = torch.zeros(n, dtype=torch.int32, device=dev)
    values[ord_] = ranks
    first = neq.clone()
    first[0] = True
    return ord_, ranks, values, first, ambiguous


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_rows(words, lens, validity):
    """int64[n] FNV-1a over the key words and the length, then fmix32;
    0 for null rows."""
    n = words.shape[0]
    h = torch.full((n,), 0x811C9DC5, dtype=torch.int64, device=words.device)
    for i in range(words.shape[1]):
        h = _mul32(h ^ u32_key(words[:, i]), 0x01000193)
    h = _mul32(h ^ lens.to(torch.int64), 0x01000193)
    h = _fmix32(h)
    return torch.where(validity, h, 0)


def _hash_group_phase(col: StringColumn, width: int, full_width: int):
    """Group rows by hash + exact compare.  Returns (values_g int32[n]
    group id per row, rep_full int64[n] group representatives compacted
    to the front, u groups, words, amb_a: truncation ambiguity inside a
    group)."""
    n = col.size
    dev = col.device
    words = array._key_words(col, width)
    lens = col.lengths()
    val = col.validity
    h = _hash_rows(words, lens, val)
    perm = torch.sort(h, stable=True).indices
    sw = words[perm]
    slen = lens[perm]
    sval = val[perm]
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    if n > 1:
        neq[1:] = _row_neq(sw, slen, sval)[0]
    gid_h = segments.cumsum(neq)
    values_g = torch.zeros(n, dtype=torch.int32, device=dev)
    values_g[perm] = gid_h
    first = neq.clone()
    first[0] = True
    (rep_full,), k0 = compact_arrays(first, [perm])
    u = k0[-1]
    amb_a = torch.zeros((), dtype=torch.bool, device=dev)
    if width < full_width and n > 1:
        # a member whose tail differs from its representative's was merged
        # only by the truncation (members share length and validity)
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        repp = segments.cummax(torch.where(first, pos, 0)).to(torch.int64)
        tied_m = (~first) & sval & (slen > width)
        starts_h = col.offsets[:-1][perm]
        diff = _tail_diff_vs(col, starts_h, slen, repp, width, full_width - width)
        amb_a = (tied_m & diff).any()
    return values_g, rep_full, u, words, amb_a


def _rep_rank_phase(col, words, values_g, rep_full, u, ucap: int, width: int, full_width: int):
    """Lexicographic ranks over the u group representatives.  Returns
    (values int32[n], key_rows int64[ucap] unique source rows in key
    order, nkeys, amb_b)."""
    dev = col.device
    lens = col.lengths()
    val = col.validity
    if rep_full.shape[0] < ucap:
        rep_full = torch.nn.functional.pad(rep_full, (0, ucap - rep_full.shape[0]))
    rep = rep_full[:ucap]
    iv = torch.arange(ucap, dtype=torch.int64, device=dev)
    live = iv < u
    rwords = words[rep]
    rlen = torch.where(live, lens[rep], 0)
    rval = torch.where(live, val[rep], False)
    # keys: dead slots last, then null first, then the words, then length
    keys = [(~live).to(torch.int64), rval.to(torch.int64)]
    keys += [torch.where(live, u32_key(rwords[:, i]), 0) for i in range(rwords.shape[1])]
    keys.append(rlen.to(torch.int64))
    rperm = lsd_order(keys)
    ssw = rwords[rperm]
    sslen = rlen[rperm]
    ssval = rval[rperm]
    sslive = live[rperm]
    rneq = torch.zeros(ucap, dtype=torch.bool, device=dev)
    if ucap > 1:
        # dead slots sort last and never start a key
        row_neq, words_eq, _ = _row_neq(ssw, sslen, ssval)
        rneq[1:] = row_neq & sslive[1:]
    dedup = segments.cumsum(rneq)
    table = torch.zeros(ucap, dtype=torch.int32, device=dev)
    table[rperm] = dedup
    values = table[values_g.clamp(max=ucap - 1).to(torch.int64)]
    first_r = rneq.clone()
    first_r[0] = True
    first_r &= sslive
    (key_rows,), kk0 = compact_arrays(first_r, [rep[rperm]])
    nkeys = kk0[-1]
    amb_b = torch.zeros((), dtype=torch.bool, device=dev)
    if width < full_width and ucap > 1:
        overflow = (sslen[1:] > width) | (sslen[:-1] > width)
        tied = words_eq & overflow & sslive[1:] & sslive[:-1] & ssval[1:] & ssval[:-1]
        rstarts = torch.where(live, col.offsets[:-1][rep], 0)[rperm]
        prev = (iv - 1).clamp(min=0)
        diff = _tail_diff_vs(col, rstarts, sslen, prev, width, full_width - width)
        amb_b = (tied & diff[1:]).any()
    return values, key_rows, nkeys, amb_b


def _encode_hashed(col: StringColumn, width: int, full_width: int):
    """Full hash-grouped encode.  Returns (values, key_rows, nkeys,
    ambiguous, u, ucap); syncs the group count once to size ucap."""
    values_g, rep_full, u, words, amb_a = _hash_group_phase(col, width, full_width)
    ucap = max(8, 1 << max(int(u) - 1, 1).bit_length())
    ucap = min(ucap, max(col.size, 8))
    values, key_rows, nkeys, amb_b = _rep_rank_phase(
        col, words, values_g, rep_full, u, ucap, width, full_width
    )
    return values, key_rows, nkeys, amb_a | amb_b, u, ucap


def dictionary_encode(col: StringColumn):
    """(keys: StringColumn of the sorted unique rows, values: int32[rows])
    with values[i] the rank of row i's key; null sorts first and is its own
    key.  Host syncs: the ambiguity flag per width, and the key count."""
    n = col.size
    if n == 0:
        return empty_column(0, col.device), torch.zeros(0, dtype=torch.int32, device=col.device)
    full_width = -(-layout.max_row_bytes(col) // 4) * 4
    width = min(full_width, 64)
    if n >= HASHED_MIN:
        while True:
            values, key_rows, nkeys, ambiguous, _, _ = _encode_hashed(col, width, full_width)
            if width >= full_width or not bool(ambiguous):
                break
            width = min(width * 4, full_width)
        key_idx = key_rows[: int(nkeys)]
    else:
        while True:
            ord_, _, values, first, ambiguous = _encode_sorted(col, width, full_width)
            if width >= full_width or not bool(ambiguous):
                break
            width = min(width * 4, full_width)
        key_idx = ord_[first]
    if col.capacity <= BOUND_SYNC_THRESHOLD:
        # the unique rows' bytes are bounded by the source capacity
        keys = array._gather_impl(col, key_idx, col.capacity)
    else:
        keys = array.gather(col, key_idx.cpu().numpy())
    return keys, values
