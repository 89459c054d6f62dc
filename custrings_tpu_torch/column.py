"""Columnar string representation on torch tensors.

Port of `custrings_tpu/column.py`.  A column is the Arrow layout the JAX
package uses, as three tensors on one device:

    data     : uint8[capacity]  flat UTF-8 bytes, padded to a bucketed
                                capacity (config.bucket_bytes); only the
                                first offsets[-1] bytes are meaningful
    offsets  : int32[rows + 1]  byte offset of each row start
    validity : bool[rows]       True = valid; null rows have zero length

The device is always named by the caller: `from_host_strings(strs,
"cuda")` raises where CUDA is missing instead of quietly using the CPU.
Columns are treated as immutable; `cache` holds the per-column planes and
host statistics that `ops.layout` memoizes (the JAX package's
`layout._cache`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import bucket_bytes
from .utils import tracing


@dataclasses.dataclass(eq=False)
class StringColumn:
    data: torch.Tensor  # uint8[capacity]
    offsets: torch.Tensor  # int32[rows + 1]
    validity: torch.Tensor  # bool[rows]
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        """Number of rows."""
        return self.offsets.shape[0] - 1

    @property
    def capacity(self) -> int:
        """Padded byte capacity."""
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def nbytes(self) -> int:
        """True total byte count (device sync)."""
        return int(self.offsets[-1])

    def memsize(self) -> int:
        """Bytes held on the device: the byte buffer at its capacity, the
        offsets and the validity mask."""
        return sum(t.numel() * t.element_size() for t in (self.data, self.offsets, self.validity))

    def lengths(self) -> torch.Tensor:
        """Byte length of each row, int32[rows] (0 for nulls)."""
        return self.offsets[1:] - self.offsets[:-1]

    def __len__(self) -> int:
        return self.size


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def from_numpy(data, offsets, validity, device) -> StringColumn:
    """Column from host arrays taken as they are, capacity padding included
    (for example a JAX column's three arrays)."""
    dev = _device(device)
    with tracing.op("column.host_copies"):  # private: the column never aliases caller memory
        host = [np.array(a, dtype=t, order="C")
                for a, t in ((data, np.uint8), (offsets, np.int32), (validity, np.bool_))]
    with tracing.op("column.upload"):
        return StringColumn(*(torch.from_numpy(a).to(dev) for a in host))


def _device_column(data_np, offsets_np, validity_np, device) -> StringColumn:
    cap = bucket_bytes(len(data_np))
    padded = np.zeros(cap, dtype=np.uint8)
    padded[: len(data_np)] = data_np
    return from_numpy(padded, offsets_np, validity_np, device)


def _flatten(strs):
    """(bytes uint8, offsets int32[n+1], validity bool[n]) on the host."""
    from .native import load as _load_native

    native = _load_native()
    if native is not None:
        if not isinstance(strs, list):
            strs = list(strs)
        data_b, offs_b, valid_b = native.flatten(strs)
        return (
            np.frombuffer(data_b, dtype=np.uint8),
            np.frombuffer(offs_b, dtype=np.int32),
            np.frombuffer(valid_b, dtype=np.uint8).astype(np.bool_),
        )
    enc = [b"" if s is None else s.encode("utf-8") for s in strs]
    lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc))
    offsets = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(enc), dtype=np.uint8)
    validity = np.fromiter((s is not None for s in strs), dtype=np.bool_, count=len(strs))
    return data, offsets, validity


def from_host_strings(strs, device) -> StringColumn:
    """Column from a list of Python str / None on `device`.

    Mirrors custrings_tpu.column.from_host_strings: the host flatten runs
    through the C helper (pure numpy without a compiler) and offsets +
    bytes upload once."""
    data, offsets, validity = _flatten(strs)
    return _device_column(data, offsets, validity, device)


def from_offsets_np(sbuf, obuf, scount, nbuf=None, *, device) -> StringColumn:
    """Column from Arrow-style host buffers (bytes, scount+1 int32 offsets,
    optional little-endian null bitmask with bit set = valid)."""
    with tracing.op("column.from_offsets_np"):
        sbuf = np.asarray(sbuf).view(np.uint8).ravel()
        obuf = np.asarray(obuf).view(np.int32).ravel()[: scount + 1]
        total = int(obuf[-1]) if len(obuf) else 0
        if nbuf is not None:
            bits = np.unpackbits(np.asarray(nbuf).view(np.uint8).ravel(), bitorder="little")
            validity = bits[:scount].astype(np.bool_)
        else:
            validity = np.ones(scount, dtype=np.bool_)
        return _device_column(sbuf[:total], obuf, validity, device)


def _host_arrays(col: StringColumn):
    return col.data.cpu().numpy(), col.offsets.cpu().numpy(), col.validity.cpu().numpy()


def to_host_strings(col: StringColumn):
    """Python list of str / None (null rows -> None, empty rows -> "")."""
    data, offsets, validity = _host_arrays(col)
    from .native import load as _load_native

    native = _load_native()
    if native is not None:
        return native.unflatten(
            data.tobytes(),
            np.ascontiguousarray(offsets, np.int32).tobytes(),
            validity.astype(np.uint8).tobytes(),
            col.size,
        )
    buf = data.tobytes()
    return [
        buf[offsets[i] : offsets[i + 1]].decode("utf-8") if validity[i] else None
        for i in range(col.size)
    ]


def to_offsets_np(col: StringColumn):
    """(bytes, offsets, Arrow little-endian null bitmask) host arrays."""
    data, offsets, validity = _host_arrays(col)
    total = int(offsets[-1])
    nbuf = np.packbits(validity.astype(np.uint8), bitorder="little")
    return data[:total].copy(), offsets.copy(), nbuf


def null_count(col: StringColumn, emptyisnull: bool = False) -> int:
    nulls = ~col.validity
    if emptyisnull:
        nulls = nulls | (col.lengths() == 0)
    return int(nulls.sum())


def empty_column(nrows: int, device, all_null: bool = False) -> StringColumn:
    dev = _device(device)
    return StringColumn(
        data=torch.zeros(bucket_bytes(0), dtype=torch.uint8, device=dev),
        offsets=torch.zeros(nrows + 1, dtype=torch.int32, device=dev),
        validity=torch.full((nrows,), not all_null, dtype=torch.bool, device=dev),
    )


def i32_bits(x):
    """A value in [0, 2^32) as the int32 value with the same 32 bits: for a
    Python int, or elementwise for an int64 numpy array or torch tensor
    (which the caller then narrows)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def cumsum0(sizes: torch.Tensor) -> torch.Tensor:
    """Exclusive scan with the total appended: int32[n] -> int32[n+1] (K3,
    one launch writing the result in place)."""
    from .ops.scan import cumsum0_i32

    return cumsum0_i32(sizes)


def row_ids_from_offsets(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """For each byte position j < capacity, the row that owns it; padding
    past offsets[-1] clamps to the last row.  One rows-sized scatter-add
    of row-start marks and one capacity-sized scan (K3), whose store
    subtracts the 1 and clamps."""
    from .ops.scan import cumsum_row_ids

    nrows = offsets.shape[0] - 1
    marks = torch.zeros(capacity + 1, dtype=torch.int32, device=offsets.device)
    marks.index_add_(
        0, offsets[:-1].to(torch.int64), torch.ones(nrows, dtype=torch.int32, device=offsets.device)
    )
    return cumsum_row_ids(marks[:capacity], nrows)


def materialize_bytes(out_offsets: torch.Tensor, capacity: int, produce) -> torch.Tensor:
    """Flat byte buffer of a new column: `produce(rows, k, valid, bcast)`
    returns the k-th output byte of `rows` at every flat position."""
    from .ops.segments import broadcast_rows_to_bytes

    j = torch.arange(capacity, dtype=torch.int32, device=out_offsets.device)
    rows = row_ids_from_offsets(out_offsets, capacity)
    k = j - broadcast_rows_to_bytes(out_offsets[:-1], out_offsets, capacity)
    valid = j < out_offsets[-1]
    vals = produce(
        rows, k, valid,
        lambda v: broadcast_rows_to_bytes(v, out_offsets, capacity),
    )
    return torch.where(valid, vals, torch.zeros((), dtype=torch.uint8, device=vals.device))


def build_column(sizes: torch.Tensor, validity: torch.Tensor, produce, capacity: int | None = None):
    """A new column from per-row byte sizes and a byte producer (see
    materialize_bytes); without a capacity, syncs once for the total."""
    if sizes.shape[0] == 0:
        return empty_column(0, sizes.device)
    out_offsets = cumsum0(sizes)
    if capacity is None:
        capacity = bucket_bytes(int(out_offsets[-1]))
    return StringColumn(materialize_bytes(out_offsets, capacity, produce), out_offsets, validity)


#: materializing ops allocate their static output bound directly (no size
#: sync) when the bound is below this many bytes
BOUND_SYNC_THRESHOLD = 1 << 28
