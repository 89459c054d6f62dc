"""Row-sharded string ops and the collective dictionary merge.

Port of `custrings_tpu/parallel/dist.py` on torch.distributed.  A column
is split into S row shards (`shard_column`), one a rank, and the ops run
on each rank's shard with the single-device ops of this package, on its
kernels.  The dictionary build is a collective key merge:

    local encode (ops.unique.dictionary_encode: K1b, K3, K4c)
      -> the sorted unique keys as a key matrix [u, 2 + W/4]
         (valid, big-endian words by K1b, length)
      -> PSRS merge: regular samples, splitters, an all_to_all of the
         keys at exact uneven splits, the owner's sort and dedup, the
         global rank base from the owned counts, the ranks sent back
      -> local values remapped to global ranks

The values are the dense ranks in the globally sorted keyset (null
first), as a single-device encode of the whole column gives them.  The
JAX package fixes a per-pair exchange capacity to keep its shapes static
and escalates, then gathers, when a skewed keyset overflows it; here
every all_to_all is sized by an exchange of the exact counts first, so
no capacity can overflow and no fallback merge exists.

Every function takes this rank's shard and a DeviceMesh with the axis
the rows are sharded over; rank r of the axis's group owns shard r.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..column import StringColumn
from ..ops import array, modify, segments
from ..ops.array import lsd_order, u32_key
from ..ops.unique import dictionary_encode
from ..utils import tracing

#: column 0 of a key matrix row that stands for no key (sorts last)
_SENTINEL = -1  # 0xFFFFFFFF as int32 bits

#: all_gather into one tensor (renamed all_gather_single in later torch)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _group(mesh, axis: str):
    """(process group, its size S, this rank's index in it)."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


# ---------------- the host-side split ----------------


def _shard_bounds(offsets: np.ndarray, n: int, S: int):
    """(rows per shard, row bounds int[S+1], common byte capacity)."""
    rows_per = -(-n // S)
    bounds = np.minimum(np.arange(S + 1) * rows_per, n)
    nbytes = offsets[bounds[1:]].astype(np.int64) - offsets[bounds[:-1]]
    cap = -(-max(int(nbytes.max()), 1) // 128) * 128
    return rows_per, bounds, cap


def _host_shard(data, offsets, validity, S: int, s: int):
    """Shard s of S as host arrays (data[cap], offsets[R+1], validity[R],
    alive[R]): R = ceil(n/S) rows, trailing dead rows (null, empty) after
    the real ones, bytes zero past the shard's."""
    n = len(validity)
    rows_per, bounds, cap = _shard_bounds(offsets, n, S)
    d = np.zeros(cap, np.uint8)
    o = np.zeros(rows_per + 1, np.int32)
    v = np.zeros(rows_per, np.bool_)
    a = np.zeros(rows_per, np.bool_)
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    if hi > lo:
        nb = int(offsets[hi] - offsets[lo])
        d[:nb] = data[offsets[lo] : offsets[hi]]
        o[: hi - lo + 1] = offsets[lo : hi + 1] - offsets[lo]
        o[hi - lo + 1 :] = nb
        v[: hi - lo] = validity[lo:hi]
        a[: hi - lo] = True
    return d, o, v, a


def _rank_shard(data, offsets, validity, mesh, axis: str, device):
    """This rank's shard of host arrays, as tensors on `device`."""
    _, S, me = _group(mesh, axis)
    return tuple(torch.from_numpy(x).to(device) for x in _host_shard(data, offsets, validity, S, me))


def shard_column(col: StringColumn, n_shards: int):
    """Host-side split of a column into n_shards equal row shards at one
    byte capacity: stacked CPU tensors (data uint8[S, cap], offsets
    int32[S, R+1], validity bool[S, R], alive bool[S, R]), R = ceil(n/S).
    Rows pad with trailing dead (null, empty) rows, bytes with zeros; a
    shard past the rows is all padding."""
    data, offsets, validity = (t.cpu().numpy() for t in (col.data, col.offsets, col.validity))
    parts = [_host_shard(data, offsets, validity, n_shards, s) for s in range(n_shards)]
    return tuple(torch.from_numpy(np.stack(x)) for x in zip(*parts))


def _alive_rows(data, offsets, validity, alive) -> StringColumn:
    """The shard's alive rows as a column (a view: they come first)."""
    n, lead = torch.stack([alive.sum(), alive.to(torch.int32).cumprod(0).sum()]).tolist()
    if n != lead:
        raise ValueError("the alive rows of a shard must come first (shard_column's layout)")
    return StringColumn(data, offsets[: n + 1], validity[:n])


# ---------------- collectives ----------------


def _all_gather(x: torch.Tensor, group, S: int) -> torch.Tensor:
    """Every rank's x (equal shapes) stacked along dim 0, in rank order."""
    out = x.new_empty((S * x.shape[0], *x.shape[1:]))
    with tracing.op("parallel.all_gather"):
        _all_gather_single(out, x.contiguous(), group=group)
    return out


def _all_reduce(value, op, group, device) -> int:
    t = torch.as_tensor(value, dtype=torch.int64).to(device).reshape(1)
    with tracing.op("parallel.all_reduce"):
        dist.all_reduce(t, op=op, group=group)
        return int(t)


def _exchange(x: torch.Tensor, send: list[int], recv: list[int], group) -> torch.Tensor:
    """all_to_all of x's rows: send[i] rows (in order) to rank i, recv[i]
    rows from rank i."""
    out = x.new_empty((sum(recv), *x.shape[1:]))
    with tracing.op("parallel.exchange"):
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv, input_split_sizes=send,
                               group=group)
    return out


def _all_gather_rows(x: torch.Tensor, group, S: int) -> torch.Tensor:
    """Every rank's x (any row count) concatenated in rank order."""
    sizes = _all_gather(torch.tensor([x.shape[0]], device=x.device), group, S).tolist()
    top = max(sizes)
    padded = x.new_zeros((top, *x.shape[1:]))
    padded[: x.shape[0]] = x
    out = _all_gather(padded, group, S).view(S, top, *x.shape[1:])
    return torch.cat([out[i, : sizes[i]] for i in range(S)])


# ---------------- the encode and the merge ----------------


def _key_matrix(keys: StringColumn, width: int) -> torch.Tensor:
    """int32[u, 2 + width/4] (uint32 bits): valid (0 null, 1 valid), the
    big-endian words of the key's first `width` bytes (K1b), the length;
    the null key all zero past column 0.  Its row order is the encode's."""
    valid = keys.validity
    lens = torch.where(valid, keys.lengths(), 0)
    if keys.size == 0:
        words = torch.zeros((0, width // 4), dtype=torch.int32, device=keys.device)
    else:
        words = torch.where(valid[:, None], array._key_words(keys, width), 0)
    return torch.cat([valid.to(torch.int32)[:, None], words, lens.to(torch.int32)[:, None]], dim=1)


def _lex_order(K: torch.Tensor) -> torch.Tensor:
    """Row order of a key matrix, columns compared as unsigned words."""
    return lsd_order([u32_key(K[:, j]) for j in range(K.shape[1])])


def _lex_less(K: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """bool[u]: is each key matrix row below `row` (unsigned, lexicographic)?"""
    neq = K != row
    first = neq.to(torch.int8).argmax(dim=1, keepdim=True)
    return neq.any(dim=1) & (u32_key(K.gather(1, first)[:, 0]) < u32_key(row[first[:, 0]]))


def _psrs_merge(K: torch.Tensor, group, S: int, me: int):
    """Global ranks of this rank's sorted unique keys (key matrix K), and
    the job's key count, by a regular-sampling sample sort:

      1. S regular samples a rank (spos = (i+1)*u // (S+1)), all-gathered;
      2. the S*S samples sorted, splitters at (i+1)*S;
      3. part = the number of splitters <= key; the keys go to their
         owners by an all_to_all at the exact counts (exchanged first);
      4. each owner sorts and dedups its key range; the global base is the
         owned counts of the ranks before it;
      5. the ranks return by the reverse all_to_all.

    The ranges are ordered, so the ranks are those of the globally sorted
    keyset.  A rank without keys samples the sentinel row, which sorts
    after every key."""
    u, C = K.shape
    dev = K.device
    if u:
        spos = ((torch.arange(S, device=dev) + 1) * u // (S + 1)).clamp(max=u - 1)
        samples = K[spos]
    else:
        samples = torch.zeros((S, C), dtype=K.dtype, device=dev)
        samples[:, 0] = _SENTINEL
    gs = _all_gather(samples, group, S)
    splitters = gs[_lex_order(gs)][(torch.arange(S - 1, device=dev) + 1) * S]
    part = torch.zeros(u, dtype=torch.int64, device=dev)
    for i in range(S - 1):
        part += ~_lex_less(K, splitters[i])
    send_t = torch.bincount(part, minlength=S)
    recv_t = torch.empty_like(send_t)
    with tracing.op("parallel.psrs_exchange"):
        dist.all_to_all_single(recv_t, send_t, group=group)
        send, recv = send_t.tolist(), recv_t.tolist()
    got = _exchange(K, send, recv, group)
    n = got.shape[0]
    ranks = torch.zeros(n, dtype=torch.int32, device=dev)
    owned = torch.zeros(1, dtype=torch.int64, device=dev)
    if n:
        order = _lex_order(got)
        srt = got[order]
        isnew = torch.ones(n, dtype=torch.bool, device=dev)
        isnew[1:] = (srt[1:] != srt[:-1]).any(dim=1)
        dense = segments.cumsum(isnew)  # K3
        ranks[order] = dense - 1
        owned = dense[-1:].to(torch.int64)
    gowned = _all_gather(owned, group, S)
    base = gowned[:me].sum().to(torch.int32)
    back = _exchange(ranks + base, recv, send, group)
    return back, int(gowned.sum())


def _encode_merge(col: StringColumn, group, S: int, me: int):
    """(int32[rows] global key ranks of a column's rows, the job's key
    count): the local encode, then the PSRS merge; one rank keeps its
    local encode."""
    keys, local = dictionary_encode(col)
    if S == 1:
        return local, keys.size
    longest = int(keys.lengths().max()) if keys.size else 0
    width = _all_reduce(longest, dist.ReduceOp.MAX, group, col.device)
    width = max(-(-width // 4) * 4, 4)
    global_rank, n = _psrs_merge(_key_matrix(keys, width), group, S, me)
    return global_rank[local.to(torch.int64)], n


def distributed_categorize(data, offsets, validity, alive, mesh, axis: str = "data"):
    """Collective dictionary build over row shards.

    Takes this rank's shard (shard_column's row); returns (values
    int32[R], each alive row's global key rank and -1 on the dead rows;
    the job's key count, the same on every rank)."""
    group, S, me = _group(mesh, axis)
    col = _alive_rows(data, offsets, validity, alive)
    ranks, n = _encode_merge(col, group, S, me)
    values = torch.full((alive.shape[0],), -1, dtype=torch.int32, device=data.device)
    values[: col.size] = ranks
    return values, n


def _token_ids(tokens: StringColumn, group, S: int, me: int):
    """(int32[T] global key ranks of the tokens, -1 past this rank's
    count, where T is the job's largest token count; the unique count)."""
    ranks, n = _encode_merge(tokens, group, S, me)
    T = _all_reduce(tokens.size, dist.ReduceOp.MAX, group, tokens.device)
    ids = torch.full((T,), -1, dtype=torch.int32, device=tokens.device)
    ids[: tokens.size] = ranks
    return ids, n


def distributed_unique_tokens(col: StringColumn, mesh, delimiter=None, axis: str = "data"):
    """Distributed nvtext.unique_tokens over a column every rank holds
    whole: each rank tokenizes its row shard (rows r*R .. (r+1)*R) with
    text.token.tokenize, then the collective key merge.  Returns (this
    rank's token ids int32[T], -1 past its token count; n_unique)."""
    from ..text.token import tokenize

    group, S, me = _group(mesh, axis)
    rows_per = -(-col.size // S)
    lo, hi = min(me * rows_per, col.size), min((me + 1) * rows_per, col.size)
    shard = array.gather(col, torch.arange(lo, hi, device=col.device))
    return _token_ids(tokenize(shard, delimiter), group, S, me)


def distributed_unique_tokens_device(data, offsets, validity, alive, mesh, axis: str = "data",
                                     delimiter=None):
    """Distributed unique_tokens over this rank's shard: the ragged
    tokenizer (K3, K4c) sized by the tokens it counts, then the encode
    and the merge.  Returns (token ids int32[T], -1 past this rank's token
    count; n_unique).  The delimiter (None: whitespace) is a character set."""
    from ..text.token import tokenize

    group, S, me = _group(mesh, axis)
    col = _alive_rows(data, offsets, validity, alive)
    return _token_ids(tokenize(col, delimiter), group, S, me)


def distributed_replace(data, offsets, validity, mesh, pat: str, repl: str, axis: str = "data"):
    """Row-sharded literal replace, shrinking replacements only (the JAX
    package's contract; `ShardedStringColumn.replace` also grows).
    Shard-local: returns this rank's (data, offsets)."""
    if len(repl.encode()) > len(pat.encode()):
        raise ValueError("distributed_replace requires len(repl) <= len(pat)")
    out = modify.replace_literal(StringColumn(data, offsets, validity), pat, repl)
    return out.data, out.offsets


def _match_chars(chars, lens, pattern: str) -> torch.Tensor:
    """bool[rows]: unanchored matches of a char matrix, on K2 (or K2b)
    where the pattern fits it, else the vector engine."""
    from ..regex import ops as rops

    nfa = rops._get_nfa(pattern)
    if nfa is not None:
        return nfa.matches(chars, lens, False)
    return rops.get_program(pattern).nfa_matches(chars, lens, False)


def distributed_contains(chars, lens, pattern: str, mesh, axis: str = "data"):
    """Row-sharded regex contains on this rank's char matrix (int32[R, L]
    codepoints, lengths int32[R]): (mask bool[R], the job's match count)."""
    group, _, _ = _group(mesh, axis)
    m = _match_chars(chars, lens, pattern)
    return m, _all_reduce(m.sum(), dist.ReduceOp.SUM, group, m.device)
