"""Per-column byte planes, padded views and the char matrix.

Port of the main-path part of `custrings_tpu/ops/layout.py`: the
memoized planes (`tail_plane`, `row_bounds_planes`), the ASCII facts
(`is_ascii`, `row_nonascii_ids`), `max_row_bytes`, `padded_view`, `char_planes`,
`char_matrix` / `char_matrix_rows`, `length_buckets` (decided from a few
scalars read back: the row statistics stay on the device), the
column-wide char index (`char_map`, `char_counts`, `codepoints`),
`utf8_width`, `encode_codepoints` and `gather_bytes`.

A padded view is built by the window gather (K1, `ops/window.py`),
which masks at each row's length in the kernel, at every size.  The
streaming view of the JAX package's TPU route, which moves every byte of
the flat buffer to its slot of the [rows, width] grid with one monotone
expansion (K4e, `ops/route.py`) after a compaction (K4c) that drops the
bytes past `width` when the width does not cover every row, stays
reachable through `STREAM_VIEW_MIN`: it existed for the TPU's per-row
DMA cost, and on the H100 it is slower than K1 at every width measured.

The char matrix is always the hybrid build (`_char_matrix_hybrid` in the
JAX package): ASCII rows take the gathered bytes as codepoints and the
non-ASCII rows are decoded row-wise and patched in.  For any mix of rows
that is the same matrix the JAX general route (char map + codepoint
gather) builds whenever the width covers the rows, which is how every
caller here uses it.  The char map itself serves the ops that turn char
positions into byte positions (span ops, `substr.slice_from`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..column import StringColumn, cumsum0
from ..config import bucket_bytes
from ..utils import tracing
from . import segments
from .route import expand_stream
from .shift_compact import compact_arrays
from .window import ragged_gather, ragged_gather_i32

#: capacity (bytes) above which the int32 row-bound planes are not
#: memoized on the column, and twice which a char matrix is not either
PLANE_CACHE_BUDGET = 1 << 29


def planes_cacheable(col: StringColumn) -> bool:
    return col.capacity <= PLANE_CACHE_BUDGET


def valid_byte_mask(col: StringColumn) -> torch.Tensor:
    """bool[capacity]: True for real (non-padding) byte positions."""
    j = torch.arange(col.capacity, dtype=torch.int32, device=col.device)
    return j < col.offsets[-1]


def gather_bytes(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[idx] with the indices clamped into the buffer."""
    return data[idx.clamp(0, data.shape[0] - 1).to(torch.int64)]


def is_ascii(col: StringColumn) -> bool:
    """True if every byte is < 0x80 (one cached reduce + host sync)."""
    c = col.cache
    if "is_ascii" not in c:
        c["is_ascii"] = bool(col.data.max() < 0x80) if col.capacity else True
    return c["is_ascii"]


def row_bounds_planes(col: StringColumn):
    """(row_start, row_end) int32[capacity] planes, memoized under the
    plane-cache budget."""
    if not planes_cacheable(col):
        return (
            segments.row_start_positions(col.offsets, col.capacity),
            segments.row_end_positions(col.offsets, col.capacity),
        )
    c = col.cache
    if "row_bounds" not in c:
        c["row_bounds"] = (
            segments.row_start_positions(col.offsets, col.capacity),
            segments.row_end_positions(col.offsets, col.capacity),
        )
    return c["row_bounds"]


def tail_plane(col: StringColumn) -> torch.Tensor:
    """uint8[capacity]: bytes remaining in the byte's VALID row from this
    position (clipped at 255); 0 for padding bytes and null-row bytes.
    One byte per capacity byte, so it is memoized at any capacity."""
    c = col.cache
    if "tail" not in c:
        cap = col.capacity
        j = torch.arange(cap, dtype=torch.int32, device=col.device)
        row_end = segments.row_end_positions(col.offsets, cap)
        vb = segments.broadcast_rows_to_bytes(col.validity, col.offsets, cap) == 1
        rem = (row_end - j).clamp(0, 255)
        live = vb & (j < col.offsets[-1])
        c["tail"] = torch.where(live, rem, 0).to(torch.uint8)
    return c["tail"]


def max_row_bytes(col: StringColumn) -> int:
    """Max row byte-length, bucketed (syncs once per column)."""
    c = col.cache
    if "max_row_bytes" not in c:
        m = int(col.lengths().max()) if col.size else 0
        c["max_row_bytes"] = max(bucket_bytes(m), 8)
    return c["max_row_bytes"]


#: padded views of at least this many elements take the streaming route;
#: None: none does (the K1 window view is faster at every size)
STREAM_VIEW_MIN: int | None = None


def _use_stream_view(col: StringColumn, width: int) -> bool:
    return STREAM_VIEW_MIN is not None and col.size * width >= STREAM_VIEW_MIN


def _expand_to_grid(data, offsets, width: int, cap: int) -> torch.Tensor:
    """uint8[rows, width]: byte j of row r (rows packed back to back in
    `data` at `offsets`, each at most `width` long) moved to flat slot
    r*width + (j - offsets[r]), one monotone expansion (K4e)."""
    nrows = offsets.shape[0] - 1
    vr = torch.arange(nrows, dtype=torch.int32, device=data.device) * width - offsets[:-1]
    dist = segments.broadcast_rows_to_bytes(vr, offsets, cap)
    live = torch.arange(cap, dtype=torch.int32, device=data.device) < offsets[-1]
    (flat,), _ = expand_stream(live, dist, [data], out_cap=nrows * width, want_placed=False)
    return flat.view(nrows, width)


def _padded_view_stream(col: StringColumn, width: int) -> torch.Tensor:
    """Streaming padded view for a width that covers every row."""
    return _expand_to_grid(col.data, col.offsets, width, col.capacity)


def _padded_view_stream_trunc(col: StringColumn, width: int) -> torch.Tensor:
    """Streaming padded view for a width below the longest row: drop each
    row's bytes past `width` (a stable compaction, K4c), then expand the
    truncated rows onto the grid (K4e)."""
    cap = col.capacity
    j = torch.arange(cap, dtype=torch.int32, device=col.device)
    row_start = segments.row_start_positions(col.offsets, cap)
    keep = ((j - row_start) < width) & (j < col.offsets[-1])
    (cdata,), _ = compact_arrays(keep, [col.data], want_k0=False)
    toff = cumsum0(col.lengths().clamp(max=width))
    return _expand_to_grid(cdata, toff, width, cap)


def _stream_view_any(col: StringColumn, width: int) -> torch.Tensor:
    if width >= max_row_bytes(col):
        return _padded_view_stream(col, width)
    return _padded_view_stream_trunc(col, width)


def _window_view(col: StringColumn, width: int) -> torch.Tensor:
    """The padded view by the window gather (K1), masked at the lengths."""
    return ragged_gather(col.data, col.offsets[:-1], width, col.lengths())


def padded_view(col: StringColumn, width: int | None = None) -> torch.Tensor:
    """uint8[rows, width] zero-padded row-major view, cached per width."""
    if width is None:
        width = max_row_bytes(col)
    c = col.cache
    key = ("padded", width)
    if key not in c:
        if col.size == 0 or width == 0:
            c[key] = torch.zeros((col.size, width), dtype=torch.uint8, device=col.device)
        elif _use_stream_view(col, width):
            c[key] = _stream_view_any(col, width)
        else:
            c[key] = _window_view(col, width)
    return c[key]


def char_planes(col: StringColumn):
    """(int32[w, rows] byte planes, zero past each row's length, int32[rows]
    lengths), w the longest row's bytes (at least 1): the padded view
    transposed, so each byte position is one contiguous plane."""
    lens = col.lengths()
    w = max(int(lens.max()) if col.size else 0, 1)
    return padded_view(col, w).t().contiguous().to(torch.int32), lens


#: how the row statistics engaged, and what they copied to the host:
#: length_buckets decisions answered None by the width ladder alone, None
#: by the cost test, or bucketed; row_nonascii_ids lookups that found no
#: row against those that fetched row ids; the bytes all of these read
#: back (`_read_back`).  Host counts of host-known sizes: counting reads
#: nothing back.
ROW_STATS = {"ladder_none": 0, "cost_none": 0, "bucketed": 0,
             "nonascii_none": 0, "nonascii_fetched": 0, "host_bytes": 0}
tracing.COUNTERS["layout.ROW_STATS"] = ROW_STATS


def _read_back(t: torch.Tensor) -> np.ndarray:
    """A copy of a device tensor on the host, its bytes counted in
    ROW_STATS."""
    ROW_STATS["host_bytes"] += t.numel() * t.element_size()
    return t.to("cpu", copy=True).numpy()


def _row_facts(col: StringColumn) -> tuple[bool, int]:
    """(is_ascii, max_row_bytes), cached where those two cache them; when
    neither is cached yet, both come from one read-back of two scalars
    (the largest byte, the longest row)."""
    c = col.cache
    if "is_ascii" not in c and "max_row_bytes" not in c:
        zero = torch.zeros((), dtype=torch.int64, device=col.device)
        top = col.data.max().to(torch.int64) if col.capacity else zero
        longest = col.lengths().max().to(torch.int64) if col.size else zero
        top, longest = _read_back(torch.stack([top, longest])).tolist()
        c["is_ascii"] = top < 0x80
        c["max_row_bytes"] = max(bucket_bytes(longest), 8)
    return is_ascii(col), max_row_bytes(col)


def row_nonascii_ids(col: StringColumn) -> np.ndarray:
    """Host int64[k], ascending: ids of rows holding any non-ASCII byte,
    cached.  The per-row flags stay on the device: an ASCII column
    (`_row_facts`) answers empty with no further work; otherwise the flagged
    rows' ids are compacted on the device (K3, K4c), their count is read
    back, then the k ids."""
    return _nonascii_rows(col)[0]


def _nonascii_rows(col: StringColumn):
    """(host int64[k], device int64[k]) non-ASCII row ids, cached."""
    c = col.cache
    if "nonascii_rows" not in c:
        with tracing.op("layout.row_nonascii_ids"):
            ids = torch.zeros(0, dtype=torch.int64, device=col.device)
            if col.size and not _row_facts(col)[0]:
                hi0 = cumsum0(col.data >= 0x80)
                flagged = segments.per_row_of_prefix(hi0, col.offsets) > 0
                rows = torch.arange(col.size, dtype=torch.int32, device=col.device)
                (got,), _ = compact_arrays(flagged, [rows], want_k0=False)
                (k,) = _read_back(flagged.sum().reshape(1)).tolist()
                ids = got[:k].to(torch.int64)
            if ids.shape[0]:
                ROW_STATS["nonascii_fetched"] += 1
                c["nonascii_rows"] = (_read_back(ids), ids)
            else:
                ROW_STATS["nonascii_none"] += 1
                c["nonascii_rows"] = (np.zeros(0, np.int64), ids)
    return c["nonascii_rows"]


def _row_nchars(col: StringColumn):
    """(int32[N] device char counts, the widest class: the longest count,
    bucketed).  A row's char count is its count of non-continuation
    bytes: its byte length in an ASCII column, whose widest class is
    `max_row_bytes`; otherwise one K3 scan of the continuation bytes and
    one scalar read-back."""
    lens = col.lengths()
    ascii, w_bytes = _row_facts(col)
    if ascii:
        return lens, w_bytes
    cont = ((col.data & 0xC0) == 0x80) & valid_byte_mask(col)
    nch = lens - segments.per_row_of_prefix(cumsum0(cont), col.offsets)
    (longest,) = _read_back(nch.max().reshape(1)).tolist()
    return nch, max(bucket_bytes(longest), 8)


def _host_row_stats(col: StringColumn):
    """(ladder, per-class row counts, int64[N] device class of each row),
    the last two None when the ladder has one width.  The statistics stay
    on the device: the host reads back the longest row's char count (for
    an ASCII column, `max_row_bytes`) and then, only for a ladder of two
    or more widths, the class counts, at most MAX_BUCKETS ints.  A row's
    class is the smallest ladder width >= its char count."""
    nch, w_full = _row_nchars(col)
    ladder = [w_full]
    while len(ladder) < MAX_BUCKETS and ladder[-1] > 32:
        ladder.append(max(bucket_bytes(ladder[-1] // 4), 8))
    ladder = sorted(set(ladder))
    if len(ladder) == 1:
        return ladder, None, None
    asn = torch.searchsorted(torch.tensor(ladder, dtype=nch.dtype, device=col.device), nch)
    return ladder, _read_back(torch.bincount(asn, minlength=len(ladder))).tolist(), asn


@dataclasses.dataclass(frozen=True)
class LengthBucket:
    """One length class of a column's rows.

    idx_c   int32[capR] device — row ids to GATHER (padding slots repeat 0)
    idx_s   int64[capR] device — row ids to SCATTER (padding slots = nrows)
    vmask   bool[capR]  device — validity of the slot's row & real slot
    width   int                — char width of this bucket's matrix
    nv      int                — number of real rows in the bucket
    idx_np  int64[nv]   host   — the real row ids, ascending, fetched at
                                 the first read
    """

    idx_c: torch.Tensor
    idx_s: torch.Tensor
    vmask: torch.Tensor
    width: int
    nv: int

    @functools.cached_property
    def idx_np(self) -> np.ndarray:
        return _read_back(self.idx_s[: self.nv])


def _bucket_rows(n: int) -> int:
    """Row-count capacity bucket with an 8-row floor."""
    n = int(n)
    if n <= 8:
        return 8
    step = 1 << max((n - 1).bit_length() - 3, 0)
    return -(-n // step) * step


#: length_buckets' defaults in the JAX package: at most this many buckets,
#: taken only when they cut the padded work below GAIN of one width, and
#: only for columns of at least MIN_ROWS rows
MAX_BUCKETS = 4
GAIN = 0.6
MIN_ROWS = 256


def length_buckets(col: StringColumn) -> list[LengthBucket] | None:
    """Partition rows by char length so one long outlier stops taxing every
    row.  Widths follow a powers-of-4 ladder below the global max; tiny
    buckets merge upward.  None when bucketing would not cut the padded
    work below GAIN of one width.  The rows' statistics stay on the
    device (`_host_row_stats`): the decision is made from at most two
    small read-backs, and a bucket's row ids are compacted on the device.
    The same buckets as the JAX package's host numpy."""
    c = col.cache
    if "length_buckets" not in c:
        with tracing.op("layout.length_buckets"):
            c["length_buckets"] = _length_buckets(col)
    return c["length_buckets"]


def _length_buckets(col: StringColumn) -> list[LengthBucket] | None:
    n = col.size
    if n < MIN_ROWS:
        return None
    with tracing.op("layout.host_row_stats"):
        ladder, counts, asn = _host_row_stats(col)
    if asn is None:
        ROW_STATS["ladder_none"] += 1
        return None
    # merge tiny classes upward (into the next wider class); dest maps a
    # row's class to the class it ends in
    dest = list(range(len(ladder)))
    for b in range(len(ladder) - 1):
        if 0 < counts[b] < max(MIN_ROWS // 2, 64):
            dest = [b + 1 if d == b else d for d in dest]
            counts[b + 1] += counts[b]
            counts[b] = 0
    cost_flat = n * ladder[-1]
    cost_bk = sum(_bucket_rows(counts[b]) * ladder[b] for b in range(len(ladder)) if counts[b])
    if not (counts[-1] < n and cost_bk < GAIN * cost_flat):
        ROW_STATS["cost_none"] += 1
        return None
    ROW_STATS["bucketed"] += 1
    dev = col.device
    cls = torch.tensor(dest, dtype=torch.int32, device=dev)[asn]
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for b, nv in enumerate(counts):
        if not nv:
            continue
        (got,), _ = compact_arrays(cls == b, [rows], want_k0=False)
        ids = got[:nv]
        cap = _bucket_rows(nv)
        idx_c = torch.zeros(cap, dtype=torch.int32, device=dev)
        idx_c[:nv] = ids
        idx_s = torch.full((cap,), n, dtype=torch.int64, device=dev)
        idx_s[:nv] = ids
        vmask = torch.zeros(cap, dtype=torch.bool, device=dev)
        vmask[:nv] = col.validity[ids.to(torch.int64)]
        out.append(LengthBucket(idx_c, idx_s, vmask, int(ladder[b]), nv))
    return out


def char_width_from_lead(b: torch.Tensor) -> torch.Tensor:
    """UTF-8 sequence length from its first byte (1..4), int32."""
    b = b.to(torch.int32)
    return 1 + (b >= 0xC0).to(torch.int32) + (b >= 0xE0).to(torch.int32) + (
        b >= 0xF0
    ).to(torch.int32)


def _char_matrix_rowwise(P: torch.Tensor, nbytes: torch.Tensor, width: int):
    """Char matrix of a small [rows, width] padded BYTE matrix: decode the
    codepoint at every position by shifts along the row, then compact the
    char starts within each row."""
    n = P.shape[0]
    k = torch.arange(width, dtype=torch.int32, device=P.device)[None, :]
    inrow = k < nbytes[:, None]

    def sh(x, t):
        return torch.nn.functional.pad(x[:, t:], (0, t)) if t else x

    Pi = P.to(torch.int32)
    b0 = Pi
    b1 = sh(Pi, 1) & 0x3F
    b2 = sh(Pi, 2) & 0x3F
    b3 = sh(Pi, 3) & 0x3F
    w = char_width_from_lead(b0)
    cp = torch.where(
        w == 1,
        b0,
        torch.where(
            w == 2,
            ((b0 & 0x1F) << 6) | b1,
            torch.where(
                w == 3,
                ((b0 & 0x0F) << 12) | (b1 << 6) | b2,
                ((b0 & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
            ),
        ),
    )
    starts = ((Pi & 0xC0) != 0x80) & inrow
    rank = torch.cumsum(starts.to(torch.int32), dim=1) - 1
    tgt = torch.where(starts, rank, width).to(torch.int64)
    out = torch.zeros((n, width + 1), dtype=torch.int32, device=P.device)
    out.scatter_(1, tgt, torch.where(starts, cp, 0))
    return out[:, :width], starts.sum(dim=1).to(torch.int32)


def _decode_rows(col: StringColumn, rows: torch.Tensor, width: int):
    """(int32[k, width] codepoints, int32[k] nchars) of the given rows,
    decoded from a byte window wide enough to cover every row."""
    wb = max(width, max_row_bytes(col))
    starts = col.offsets[:-1][rows]
    lens = col.lengths()[rows]
    P = ragged_gather(col.data, starts, wb, lens)
    mat, nch = _char_matrix_rowwise(P, lens, wb)
    return mat[:, :width], nch


def _char_matrix_hybrid(col: StringColumn, rows, na_pos, width: int, stream: bool = False):
    """Char matrix of `rows` (all rows when None): the padded byte view is
    the matrix of every ASCII row; rows at positions `na_pos` are decoded
    row-wise and overwrite theirs.  The byte view is the K1 window, or
    with `stream` (all rows, a width covering every row) the streaming
    view."""
    lens = col.lengths() if rows is None else col.lengths()[rows]
    if stream:
        mat = _padded_view_stream(col, width).to(torch.int32)
    else:
        starts = col.offsets[:-1] if rows is None else col.offsets[:-1][rows]
        mat = ragged_gather_i32(col.data, starts, width, lens)
    nch = lens.clone()
    if na_pos.shape[0]:
        na_rows = na_pos if rows is None else rows[na_pos]
        mat_na, nch_na = _decode_rows(col, na_rows, width)
        mat[na_pos] = mat_na
        nch[na_pos] = nch_na
    return mat, nch


def char_matrix(col: StringColumn, width: int | None = None):
    """(int32[rows, width] codepoint matrix 0-padded, int32[rows] nchars),
    cached per column and width under the plane-cache budget."""
    if width is None:
        width = max_row_bytes(col)
    c = col.cache
    key = ("char_matrix", width)
    if key in c:
        return c[key]
    with tracing.op("layout.char_matrix"):
        na = _nonascii_rows(col)[1]
        stream = _use_stream_view(col, width) and width >= max_row_bytes(col)
        res = _char_matrix_hybrid(col, None, na, width, stream)
    if col.size * width * 4 <= 2 * PLANE_CACHE_BUDGET:
        c[key] = res
    return res


def char_matrix_rows(col: StringColumn, bucket: LengthBucket):
    """char_matrix() restricted to one LengthBucket's rows at its width."""
    c = col.cache
    key = ("char_matrix_rows", bucket.width, bucket.nv)
    if key not in c:
        with tracing.op("layout.char_matrix_rows"):
            na_pos = na_all = _nonascii_rows(col)[1]
            if na_all.shape[0]:
                na_pos = torch.isin(bucket.idx_c, na_all.to(torch.int32)).nonzero()[:, 0]
            c[key] = _char_matrix_hybrid(col, bucket.idx_c, na_pos, bucket.width)
    return c[key]


@dataclasses.dataclass(frozen=True)
class CharMap:
    """Column-wide character index structures.

    cs0          int32[capacity+1]  chars in bytes [0, j)
    char_offsets int32[rows+1]      char index of each row start
    char_pos     int32[capacity]    byte position of the c-th char (0 for
                                    c >= total chars)
    """

    cs0: torch.Tensor
    char_offsets: torch.Tensor
    char_pos: torch.Tensor

    def nchars(self) -> torch.Tensor:
        """Characters per row, int32[rows]."""
        return self.char_offsets[1:] - self.char_offsets[:-1]


def char_map(col: StringColumn) -> CharMap:
    """The column's CharMap, cached.  ASCII columns: chars are bytes, so
    every structure is affine.  Otherwise the char starts (non-continuation
    bytes) are counted by one K3 scan and their byte positions are a
    stable compaction of the positions by the start mask (K4c)."""
    c = col.cache
    if "char_map" not in c:
        cap = col.capacity
        if is_ascii(col):
            j = torch.arange(cap + 1, dtype=torch.int32, device=col.device)
            cm = CharMap(torch.minimum(j, col.offsets[-1]), col.offsets, j[:cap])
        else:
            starts = ((col.data & 0xC0) != 0x80) & valid_byte_mask(col)
            j = torch.arange(cap, dtype=torch.int32, device=col.device)
            (char_pos,), cs0 = compact_arrays(starts, [j])
            cm = CharMap(cs0, cs0[col.offsets.to(torch.int64)], char_pos)
        c["char_map"] = cm
    return c["char_map"]


def char_counts(col: StringColumn) -> torch.Tensor:
    """Characters per row, int32[rows] (before null masking)."""
    return char_map(col).nchars()


def char_byte_pos(col: StringColumn, g: torch.Tensor) -> torch.Tensor:
    """int32[rows]: byte position of the column's g-th char (g per row; at
    or past the column's last char it is the end of the bytes), clamped
    into the row."""
    cm = char_map(col)
    pos = cm.char_pos[g.clamp(max=col.capacity - 1).to(torch.int64)]
    pos = torch.where(g >= cm.cs0[-1], col.offsets[-1], pos)
    return torch.minimum(torch.maximum(pos, col.offsets[:-1]), col.offsets[1:])


def _codepoints_at_bytes(data: torch.Tensor) -> torch.Tensor:
    """int32[capacity]: the codepoint whose UTF-8 sequence starts at byte
    j (garbage at continuation bytes), by shifts along the buffer."""
    def sh(t):
        return torch.nn.functional.pad(data[t:], (0, t)).to(torch.int32) & 0x3F

    b0 = data.to(torch.int32)
    b1, b2, b3 = sh(1), sh(2), sh(3)
    w = char_width_from_lead(b0)
    return torch.where(
        w == 1,
        b0,
        torch.where(
            w == 2,
            ((b0 & 0x1F) << 6) | b1,
            torch.where(
                w == 3,
                ((b0 & 0x0F) << 12) | (b1 << 6) | b2,
                ((b0 & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
            ),
        ),
    )


def codepoints(col: StringColumn) -> torch.Tensor:
    """int32[capacity]: codepoint of the c-th character of the column; only
    c < total chars is meaningful (cached)."""
    c = col.cache
    if "codepoints" not in c:
        if is_ascii(col):
            c["codepoints"] = col.data.to(torch.int32)
        else:
            pos = char_map(col).char_pos.to(torch.int64)
            c["codepoints"] = _codepoints_at_bytes(col.data)[pos]
    return c["codepoints"]


def utf8_width(cp: torch.Tensor) -> torch.Tensor:
    """int32: the bytes of each codepoint's UTF-8 encoding (1..4)."""
    return 1 + (cp >= 0x80).to(torch.int32) + (cp >= 0x800).to(torch.int32) + (
        cp >= 0x10000
    ).to(torch.int32)


def encode_codepoints(cp: torch.Tensor):
    """Codepoints to UTF-8: (uint8[n, 4] bytes, of which the first width
    are the char's; int32[n] widths 1..4)."""
    cp = cp.to(torch.int32)
    w = utf8_width(cp)
    lead = torch.where(
        w == 1, cp,
        torch.where(w == 2, 0xC0 | (cp >> 6), torch.where(w == 3, 0xE0 | (cp >> 12), 0xF0 | (cp >> 18))),
    )
    byte1 = torch.where(
        w == 2, 0x80 | (cp & 0x3F),
        torch.where(w == 3, 0x80 | ((cp >> 6) & 0x3F), 0x80 | ((cp >> 12) & 0x3F)),
    )
    byte2 = torch.where(w == 3, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    byte3 = 0x80 | (cp & 0x3F)
    return torch.stack([lead, byte1, byte2, byte3], dim=-1).to(torch.uint8), w
