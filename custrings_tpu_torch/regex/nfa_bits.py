"""K2: the bit-parallel boolean NFA matcher (programs of <= 32 insts).

Port of `custrings_tpu/regex/pallas_nfa.py`: `pallas_supported`, the bit
tables of `PallasNFA.__init__` and `_matches_bits`.  The CUDA kernel is
`csrc/nfa_bits.cu` (one thread per row, one uint32 state); the plain
version below runs the same step over all rows at once, one Python
iteration per position, and is what a CPU tensor takes.

The TPU kernel reads per-position planes built in front of it
(`custrings_tpu/regex/pallas_nfa.py:255`: the class bits of every char
and the closure variant of every position).  Here each position's
predicate and closure variant are functions of the chars at p - 1 and p,
which the kernel reads anyway, so it computes them from the program's
char tables (`nfa_chars.CharTables`: `char_table`, `memb_bmp`, shared
with the span passes K5) and reads only the char matrix, the lengths and
the tables.
State words are carried as int32/int64 tensors and handled with bitwise
ops only, which are bit-identical to uint32.
"""

from __future__ import annotations

from functools import cached_property

import torch

from .. import kernels
from ..column import i32_bits
from .nfa_chars import CharTables

MAX_BITS_INSTS = 32


def pallas_supported(dp) -> bool:
    """Can this program run on the bit matcher (one 32-bit state)?"""
    return dp.I <= MAX_BITS_INSTS


class NFABits(CharTables):
    """Bit tables of one DeviceProgram, and its matcher."""

    def __init__(self, dp):
        if not pallas_supported(dp):
            raise ValueError(
                f"program has {dp.I} instructions; the bit matcher takes at "
                f"most {MAX_BITS_INSTS}"
            )
        super().__init__(dp, 1)
        I = self.I = dp.I
        cu = dp.closure_unique.numpy()
        self.U = cu.shape[0]
        self.crows = [
            [sum(1 << j for j in range(I) if cu[u, i, j]) for i in range(I)]
            for u in range(self.U)
        ]
        nm = dp.next_mat.numpy()
        self.nrows = [sum(1 << j for j in range(I) if nm[i, j]) for i in range(I)]
        sv = dp.start_vec.numpy()
        self.start_bits = sum(1 << i for i in range(I) if sv[i])
        ie = dp.is_end.numpy()
        self.end_bits = sum(1 << i for i in range(I) if ie[i])
        self.any_bits, self.anynl_bits = self.any_w[0], self.anynl_w[0]
        # the kernels' program table (csrc/nfa_chars.cuh); an ASCII char's
        # predicate is char_table's pred_a, so only the CHAR pairs of chars
        # >= 128 go in
        pairs = [(i, a) for i, a in self.char_pairs if a >= 128]
        table = [
            self.U, I, self.start_bits, self.end_bits, self.any_bits,
            self.anynl_bits, len(pairs),
        ]
        table += [r for row in self.crows for r in row] + self.nrows
        table += [v for pair in pairs for v in pair]
        self.table = torch.tensor([i32_bits(v) for v in table], dtype=torch.int32)

    @cached_property
    def crows_i64(self) -> torch.Tensor:
        """int64[U, I] closure rows (the plain versions' table)."""
        return torch.tensor(self.crows, dtype=torch.int64)

    def matches(self, chars, lengths, anchored: bool):
        """bool[N]: does the program match row r (anchored: at 0)?

        chars int32[N, L] codepoints 0-padded; lengths int32[N].  The
        kernel reads the full char tables, so it is exact on every char
        and needs no ASCII pass."""
        N, L = chars.shape
        if N == 0:
            return torch.zeros(0, dtype=torch.bool, device=chars.device)
        return self._matches_bits(chars, lengths, anchored)

    def _matches_bits(self, chars, lengths, anchored: bool):
        if not chars.is_cuda:
            return self._matches_plain(chars, lengths, anchored)
        N, L = chars.shape
        if L == 0:
            raise ValueError("nfa_bits: the char matrix has no columns")
        # the kernel reads the row-major char matrix in place (nfa_bits.cu)
        chars = chars.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        if lens.shape != (N,):
            raise ValueError("nfa_bits: lengths do not fit the char matrix")
        dev = chars.device
        table, ctab, bmp = (self.on(k, dev) for k in ("table", "char_table", "memb_bmp"))
        for t in (chars, lens, table, ctab, bmp):
            kernels.require_cuda(t, "nfa_bits")
        out = torch.empty(N, dtype=torch.uint8, device=dev)
        with kernels.launched("nfa_bits"):
            err = kernels.lib().cs_nfa_bits(
                chars.data_ptr(), lens.data_ptr(), table.data_ptr(), table.shape[0],
                ctab.data_ptr(), ctab.shape[0], bmp.data_ptr(), N, L,
                1 if anchored else 0, out.data_ptr(), kernels.stream_ptr(chars),
            )
            kernels.check(err, "nfa_bits")
        return out.bool()

    def _matches_plain(self, chars, lengths, anchored: bool):
        """The kernel's step over all rows at once (int64 states, 32 bits
        used), one iteration per position p = 0..L, the predicates and
        closure variants read from the char tables."""
        N, L = chars.shape
        dev = chars.device
        lens = lengths.to(torch.int64)
        uid = self._uid_plane(chars, lens)
        state = torch.zeros(N, dtype=torch.int64, device=dev)
        matched = torch.zeros(N, dtype=torch.bool, device=dev)
        for p in range(L + 1):
            pc = min(p, L - 1)
            cur = torch.where(p < lens, chars[:, pc].to(torch.int64), 0)
            if anchored:
                inj = ~matched if p == 0 else torch.zeros_like(matched)
            else:
                inj = ~matched & (p <= lens)
            state = torch.where(inj, state | self.start_bits, state)
            closed = self._or_rows(state, self._closure_rows(uid, p, N, dev))
            matched |= (closed & self.end_bits) != 0
            state = self._or_rows(closed & self._pred_plain(cur)[:, 0], self.nrows)
        return matched

    def _closure_rows(self, uid, p: int, N: int, device):
        """int64[N, I]: each row's closure table at position p."""
        crows = self.on("crows_i64", device)
        return crows[uid[:, p]] if self.U > 1 else crows[0].expand(N, self.I)

    def _or_rows(self, bits, rows):
        """OR of rows[..., i] over the set bits i of `bits` (int64[N]);
        rows is int64[N, I] or a list of I ints."""
        out = torch.zeros_like(bits)
        for i in range(self.I):
            r = rows[i] if isinstance(rows, list) else rows[:, i]
            out |= torch.where(((bits >> i) & 1) > 0, r, 0)
        return out
