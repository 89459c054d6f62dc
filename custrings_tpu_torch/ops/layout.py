"""Per-column byte planes, padded views and the char matrix.

Port of the main-path part of `custrings_tpu/ops/layout.py`: the
memoized planes (`tail_plane`, `row_bounds_planes`), the ASCII facts
(`is_ascii`, `row_nonascii_ids`), `max_row_bytes`, `padded_view`,
`char_matrix` / `char_matrix_rows`, the host-side `length_buckets`, the
column-wide char index (`char_map`, `codepoints`) and `gather_bytes`.

A padded view is built one of two ways, chosen by size as in the JAX
package: below `STREAM_VIEW_MIN` output elements by the window gather
(K1, `ops/window.py`) plus a length mask; from it by the streaming view,
which moves every byte of the flat buffer to its slot of the
[rows, width] grid with one monotone expansion (K4e, `ops/route.py`),
after a compaction (K4c) that drops the bytes past `width` when the
width does not cover every row.

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

import numpy as np
import torch

from ..column import StringColumn, cumsum0
from ..config import bucket_bytes
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


#: padded views of at least this many elements take the streaming route
STREAM_VIEW_MIN = 1 << 22


def _use_stream_view(col: StringColumn, width: int) -> bool:
    return col.size * width >= STREAM_VIEW_MIN


def _expand_to_grid(data, offsets, width: int, cap: int) -> torch.Tensor:
    """uint8[rows, width]: byte j of row r (rows packed back to back in
    `data` at `offsets`, each at most `width` long) moved to flat slot
    r*width + (j - offsets[r]), one monotone expansion (K4e)."""
    nrows = offsets.shape[0] - 1
    vr = torch.arange(nrows, dtype=torch.int32, device=data.device) * width - offsets[:-1]
    dist = segments.broadcast_rows_to_bytes(vr, offsets, cap)
    live = torch.arange(cap, dtype=torch.int32, device=data.device) < offsets[-1]
    (flat,), _ = expand_stream(live, dist, [data], out_cap=nrows * width)
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
    (cdata,), _ = compact_arrays(keep, [col.data])
    toff = cumsum0(col.lengths().clamp(max=width))
    return _expand_to_grid(cdata, toff, width, cap)


def _stream_view_any(col: StringColumn, width: int) -> torch.Tensor:
    if width >= max_row_bytes(col):
        return _padded_view_stream(col, width)
    return _padded_view_stream_trunc(col, width)


def _window_view(col: StringColumn, width: int) -> torch.Tensor:
    """The padded view by the window gather (K1) and a length mask."""
    k = torch.arange(width, dtype=torch.int32, device=col.device)[None, :]
    raw = ragged_gather(col.data, col.offsets[:-1], width)
    return torch.where(k < col.lengths()[:, None], raw, 0).to(torch.uint8)


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


def row_nonascii_ids(col: StringColumn) -> np.ndarray:
    """Host int64[k]: ids of rows holding any non-ASCII byte (one K3 scan
    over the bytes + one host fetch, cached)."""
    c = col.cache
    if "nonascii_rows" not in c:
        hi0 = cumsum0(col.data >= 0x80)
        mask = segments.per_row_of_prefix(hi0, col.offsets) > 0
        c["nonascii_rows"] = np.nonzero(mask.cpu().numpy())[0]
    return c["nonascii_rows"]


def _host_row_stats(col: StringColumn):
    """(nchars int64[N], validity bool[N]) on the host, cached.  A row's
    char count is its count of non-continuation bytes."""
    c = col.cache
    if "host_nchars" not in c:
        cont = ((col.data & 0xC0) == 0x80) & valid_byte_mask(col)
        cont0 = cumsum0(cont)
        nch = col.lengths() - segments.per_row_of_prefix(cont0, col.offsets)
        c["host_nchars"] = nch.cpu().numpy().astype(np.int64)
        c["host_validity"] = col.validity.cpu().numpy()
    return c["host_nchars"], c["host_validity"]


@dataclasses.dataclass(frozen=True)
class LengthBucket:
    """One length class of a column's rows.

    idx_c   int32[capR] device — row ids to GATHER (padding slots repeat 0)
    idx_s   int64[capR] device — row ids to SCATTER (padding slots = nrows)
    idx_np  int64[nv]   host   — the real row ids
    vmask   bool[capR]  device — validity of the slot's row & real slot
    width   int                — char width of this bucket's matrix
    nv      int                — number of real rows in the bucket
    """

    idx_c: torch.Tensor
    idx_s: torch.Tensor
    idx_np: np.ndarray
    vmask: torch.Tensor
    width: int
    nv: int


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
    row (host numpy, as in the JAX package).  Widths follow a powers-of-4
    ladder below the global max; tiny buckets merge upward.  None when
    bucketing would not cut the padded work below GAIN of one width."""
    c = col.cache
    key = "length_buckets"
    if key in c:
        return c[key]
    res = None
    n = col.size
    if n >= MIN_ROWS:
        nch, val = _host_row_stats(col)
        w_full = max(bucket_bytes(int(nch.max(initial=0))), 8)
        ladder = [w_full]
        while len(ladder) < MAX_BUCKETS and ladder[-1] > 32:
            ladder.append(max(bucket_bytes(ladder[-1] // 4), 8))
        ladder = sorted(set(ladder))
        asn = np.searchsorted(np.asarray(ladder), nch, side="left")
        counts = np.bincount(asn, minlength=len(ladder))
        for b in range(len(ladder) - 1):
            if 0 < counts[b] < max(MIN_ROWS // 2, 64):
                asn[asn == b] = b + 1
                counts[b + 1] += counts[b]
                counts[b] = 0
        cost_flat = n * w_full
        cost_bk = sum(
            _bucket_rows(int(counts[b])) * ladder[b]
            for b in range(len(ladder))
            if counts[b]
        )
        if len(ladder) > 1 and counts[-1] < n and cost_bk < GAIN * cost_flat:
            dev = col.device
            out = []
            for b in range(len(ladder)):
                if not counts[b]:
                    continue
                idx = np.nonzero(asn == b)[0]
                nv = len(idx)
                cap = _bucket_rows(nv)
                idx_c = np.zeros(cap, np.int32)
                idx_c[:nv] = idx
                idx_s = np.full(cap, n, np.int64)
                idx_s[:nv] = idx
                vmask = np.zeros(cap, np.bool_)
                vmask[:nv] = val[idx]
                out.append(
                    LengthBucket(
                        torch.from_numpy(idx_c).to(dev),
                        torch.from_numpy(idx_s).to(dev),
                        idx,
                        torch.from_numpy(vmask).to(dev),
                        int(ladder[b]),
                        nv,
                    )
                )
            res = out
    c[key] = res
    return res


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
    k = torch.arange(wb, dtype=torch.int32, device=col.device)[None, :]
    P = torch.where(k < lens[:, None], ragged_gather(col.data, starts, wb), 0)
    mat, nch = _char_matrix_rowwise(P.to(torch.uint8), lens, wb)
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
        kk = torch.arange(width, dtype=torch.int32, device=col.device)[None, :]
        mat = torch.where(kk < lens[:, None], ragged_gather_i32(col.data, starts, width), 0)
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
    na = torch.from_numpy(row_nonascii_ids(col)).to(col.device)
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
        na_all = row_nonascii_ids(col)
        na_pos = np.nonzero(np.isin(bucket.idx_c.cpu().numpy(), na_all))[0]
        c[key] = _char_matrix_hybrid(
            col, bucket.idx_c, torch.from_numpy(na_pos).to(col.device), bucket.width
        )
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
