"""ShardedStringColumn: a string column row-sharded over a mesh axis.

Port of `custrings_tpu/parallel/sharded.py`.  Each rank holds its own
shard and calls the same methods (SPMD):

    mesh = runtime.global_mesh()
    sc = ShardedStringColumn.from_column(col, mesh)
    sc2 = sc.replace("the", "THEIR")          # growing replacements too
    mask, total = sc.contains_re(r"#\\w+")
    values, n_keys = sc.categorize()
    ids, n_unique = sc.unique_tokens()

The per-row work is this package's single-device ops on the rank's
shard (their kernels on the card); the cross-rank steps are collectives
over the axis's process group: an all-reduce for the match count, the
PSRS key merge for the dictionaries (`dist`), an all-gather for
`to_column`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..column import StringColumn, cumsum0
from ..config import bucket_bytes
from ..ops import modify
from ..regex import ops as rops
from . import dist as pdist


class ShardedStringColumn:
    """This rank's shard of a row-sharded column.

    The shard is a StringColumn's three tensors (data uint8[cap], offsets
    int32[R+1], validity bool[R]) and alive bool[R], True on the real
    rows, which come first; the dead rows after them are null and empty.
    Every shard has R = ceil(nrows / S) rows; rank r of the axis's group
    holds rows r*R .. r*R + R - 1 of the column."""

    def __init__(self, data, offsets, validity, alive, mesh, axis: str = "data",
                 nrows: int | None = None):
        self.data = data
        self.offsets = offsets
        self.validity = validity
        self.alive = alive
        self.mesh = mesh
        self.axis = axis
        self._group, self.S, self.rank = pdist._group(mesh, axis)
        self.R = int(offsets.shape[0]) - 1
        self._col = StringColumn(data, offsets, validity)
        if nrows is None:
            nrows = pdist._all_reduce(alive.sum(), dist.ReduceOp.SUM, self._group, data.device)
        self.nrows = int(nrows)

    # ---------------- construction / egress ----------------

    @classmethod
    def from_column(cls, col: StringColumn, mesh, axis: str = "data") -> "ShardedStringColumn":
        """This rank's shard of a column every rank holds whole, on the
        column's device."""
        host = (t.cpu().numpy() for t in (col.data, col.offsets, col.validity))
        return cls(*pdist._rank_shard(*host, mesh, axis, col.device), mesh, axis, nrows=col.size)

    def to_column(self) -> StringColumn:
        """The whole column, rows in order, on every rank (on this rank's
        device): the shards' alive rows all-gathered."""
        col = pdist._alive_rows(self.data, self.offsets, self.validity, self.alive)
        g, S = self._group, self.S
        nbytes = int(col.offsets[-1])
        data = pdist._all_gather_rows(col.data[:nbytes], g, S)
        lens = pdist._all_gather_rows(col.lengths(), g, S)
        valid = pdist._all_gather_rows(col.validity.to(torch.uint8), g, S).to(torch.bool)
        cap = bucket_bytes(data.shape[0])
        return StringColumn(torch.nn.functional.pad(data, (0, cap - data.shape[0])), cumsum0(lens), valid)

    def size(self) -> int:
        return self.nrows

    # ---------------- ops ----------------

    def contains_re(self, pattern: str):
        """(mask bool[R] of this shard, False on dead rows; the job's
        match count).  The regex runs on the shard's char matrix by the
        single-device routes (K1, then K2 for `#\\w+`)."""
        m = rops.contains_re(self._col, pattern) & self.validity & self.alive
        return m, pdist._all_reduce(m.sum(), dist.ReduceOp.SUM, self._group, m.device)

    def replace(self, pat: str, repl: str) -> "ShardedStringColumn":
        """Literal replace of every occurrence, on each shard; growing
        replacements size their output from the shard's match count."""
        if not pat:
            return self
        out = modify.replace_literal(self._col, pat, repl)
        return ShardedStringColumn(out.data, out.offsets, self.validity, self.alive,
                                   self.mesh, self.axis, nrows=self.nrows)

    def categorize(self):
        """Collective dictionary build: (values int32[R] global key ids,
        -1 on dead rows; the job's key count)."""
        return pdist.distributed_categorize(self.data, self.offsets, self.validity, self.alive,
                                            self.mesh, self.axis)

    def unique_tokens(self, delimiter: str | None = None):
        """Tokenize the shard and merge the token keys: (token ids
        int32[T], -1 past this rank's token count; n_unique)."""
        return pdist.distributed_unique_tokens_device(self.data, self.offsets, self.validity,
                                                      self.alive, self.mesh, self.axis, delimiter)
