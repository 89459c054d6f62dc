"""K2: the bit-parallel boolean NFA matcher (programs of <= 32 insts).

Port of `custrings_tpu/regex/pallas_nfa.py`: `pallas_supported`, the bit
tables of `PallasNFA.__init__`, `_pos_tables` and `_matches_bits`.  The
CUDA kernel is `csrc/nfa_bits.cu` (one thread per row, one uint32 state);
the plain version below runs the same step over all rows at once, one
Python iteration per position, and is what a CPU tensor takes.

The per-position tables stay in torch, as on the TPU: `membw` (the
class-membership bit plane of each char) and `uid` (the closure-variant id
of each position, EOS sentinel included).  State words are carried as
int32/int64 tensors and handled with bitwise ops only, which are
bit-identical to uint32.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..column import i32_bits
from .compiler import ANY, ANYNL, CCLASS, CHAR, NCCLASS
from .device import CTX_BOS, CTX_CUR_NL, CTX_EOS, CTX_PREV_NL, CTX_WB

MAX_BITS_INSTS = 32


def pallas_supported(dp) -> bool:
    """Can this program run on the bit matcher (one 32-bit state)?"""
    return dp.I <= MAX_BITS_INSTS


class NFABits:
    """Bit tables of one DeviceProgram, and its matcher."""

    def __init__(self, dp):
        if not pallas_supported(dp):
            raise ValueError(
                f"program has {dp.I} instructions; the bit matcher takes at "
                f"most {MAX_BITS_INSTS}"
            )
        self.dp = dp
        prog = dp.prog
        I = self.I = dp.I
        cu = dp.closure_unique.numpy()
        self.U = cu.shape[0]
        # class membership packed into one 32-bit plane: bit i is inst i's
        # predicate, membw = B ^ OR_c(in_class_c ? M[c] : 0), where M[c] holds
        # the bits of the insts testing class c and B those of the negated
        # ones (the TPU's affine form B + sum in_class_c * A[c] mod 2^32
        # computes the same bits, since no two insts share a bit)
        n_cls = max(len(prog.classes), 1)
        M = [0] * n_cls
        B = 0
        for i in range(I):
            t = prog.types[i]
            if t in (CCLASS, NCCLASS):
                M[int(prog.args[i])] |= 1 << i
                if t == NCCLASS:
                    B |= 1 << i
        self.memb_M = [i32_bits(m) for m in M]
        self.memb_B = i32_bits(B)
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
        self.char_pairs = [
            (i, int(prog.args[i])) for i in range(I) if prog.types[i] == CHAR
        ]
        self.any_bits = sum(1 << i for i in range(I) if prog.types[i] == ANY)
        self.anynl_bits = sum(1 << i for i in range(I) if prog.types[i] == ANYNL)
        table = [
            self.U, I, self.start_bits, self.end_bits, self.any_bits,
            self.anynl_bits, len(self.char_pairs),
        ]
        table += [r for row in self.crows for r in row] + self.nrows
        table += [v for pair in self.char_pairs for v in pair]
        self.table = torch.tensor([i32_bits(v) for v in table], dtype=torch.int32)
        self._on = {}

    def _table_on(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = self.table.to(device)
        return self._on[key]

    def _crows_on(self, device):
        """int64[U, I] closure rows on `device` (the plain versions' table)."""
        key = ("crows", str(device))
        if key not in self._on:
            self._on[key] = torch.tensor(self.crows, dtype=torch.int64, device=device)
        return self._on[key]

    def matches(self, chars, lengths, anchored: bool, ascii: bool = False):
        """bool[N]: does the program match row r (anchored: at 0)?

        chars int32[N, L] codepoints 0-padded; lengths int32[N]; ascii=True
        promises every codepoint < 128 (packed-bit predicates)."""
        N, L = chars.shape
        if N == 0:
            return torch.zeros(0, dtype=torch.bool, device=chars.device)
        membw, uid = self._pos_tables(chars, lengths, ascii)
        return self._matches_bits(chars, lengths, membw, uid, anchored)

    def _pos_tables(self, chars, lengths, ascii: bool):
        """(membw int32[N, L], uid int32[N, L+1] or None) per-position
        tables, in int32: the class bit plane of each char, and the closure
        variant of each position (EOS sentinel included) from its context
        bits.  A program with one closure variant (no anchors or word
        boundaries) always takes variant 0: uid is None then."""
        dp = self.dp
        N, L = chars.shape
        dev = chars.device
        chars = chars.to(torch.int32)
        in_class = dp._class_membership(chars, ascii)  # [N, L, n_cls]
        membw = torch.full((N, L), self.memb_B, dtype=torch.int32, device=dev)
        for c, m in enumerate(self.memb_M):
            if m:
                membw ^= in_class[..., c].to(torch.int32) * m
        if self.U == 1:
            return membw, None
        alnum = dp._alnum(chars, ascii).to(torch.int32)
        pos = torch.arange(L + 1, dtype=torch.int32, device=dev)[None, :]
        lensE = lengths.to(torch.int32)[:, None]
        cur_ok = pos < lensE
        prev_ok = (pos > 0) & (pos - 1 < lensE)
        F = torch.nn.functional
        curc = torch.where(cur_ok, F.pad(chars, (0, 1)), 0)
        prevc = torch.where(prev_ok, F.pad(chars, (1, 0))[:, : L + 1], 0)
        al_cur = torch.where(cur_ok, F.pad(alnum, (0, 1)), 0)
        al_prev = torch.where(prev_ok, F.pad(alnum, (1, 0))[:, : L + 1], 0)
        i32 = torch.int32
        ctx = (
            (pos == 0).to(i32) * CTX_BOS
            | (prevc == 10).to(i32) * CTX_PREV_NL
            | (curc == 0).to(i32) * CTX_EOS
            | (curc == 10).to(i32) * CTX_CUR_NL
            | (al_cur != al_prev).to(i32) * CTX_WB
        )
        uid = dp.on("ctx_map", dev)[ctx]
        return membw, uid

    def _matches_bits(self, chars, lengths, membw, uid, anchored: bool):
        if not chars.is_cuda:
            return self._matches_plain(chars, lengths, membw, uid, anchored)
        N, L = chars.shape
        if L == 0:
            raise ValueError("nfa_bits: the char matrix has no columns")
        # the kernel reads the row-major planes in place (see nfa_bits.cu)
        chars = chars.to(torch.int32).contiguous()
        membw = membw.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        if membw.shape != (N, L) or lens.shape != (N,):
            raise ValueError("nfa_bits: membw or lengths do not fit the char matrix")
        table = self._table_on(chars.device)
        planes = [chars, membw, lens, table]
        if self.U > 1:  # the kernel reads uid only with several variants
            uid = uid.to(torch.int32).contiguous()
            if uid.shape != (N, L + 1):
                raise ValueError("nfa_bits: uid does not fit the char matrix")
            planes.append(uid)
        for t in planes:
            kernels.require_cuda(t, "nfa_bits")
        out = torch.empty(N, dtype=torch.uint8, device=chars.device)
        uid_ptr = uid.data_ptr() if self.U > 1 else 0
        err = kernels.lib().cs_nfa_bits(
            chars.data_ptr(), membw.data_ptr(), L, 1, uid_ptr, L + 1, 1,
            lens.data_ptr(), table.data_ptr(), table.shape[0], N, L,
            1 if anchored else 0, out.data_ptr(), kernels.stream_ptr(chars),
        )
        kernels.check(err, "nfa_bits")
        kernels.LAUNCHES["nfa_bits"] += 1
        return out.bool()

    def _matches_plain(self, chars, lengths, membw, uid, anchored: bool):
        """The kernel's step over all rows at once (int64 states, 32 bits
        used), one iteration per position p = 0..L."""
        N, L = chars.shape
        dev = chars.device
        lens = lengths.to(torch.int64)
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
            state = self._or_rows(closed & self._pred_plain(cur, membw[:, pc]), self.nrows)
        return matched

    def _closure_rows(self, uid, p: int, N: int, device):
        """int64[N, I]: each row's closure table at position p."""
        crows = self._crows_on(device)
        return crows[uid[:, p]] if self.U > 1 else crows[0].expand(N, self.I)

    def _or_rows(self, bits, rows):
        """OR of rows[..., i] over the set bits i of `bits` (int64[N]);
        rows is int64[N, I] or a list of I ints."""
        out = torch.zeros_like(bits)
        for i in range(self.I):
            r = rows[i] if isinstance(rows, list) else rows[:, i]
            out |= torch.where(((bits >> i) & 1) > 0, r, 0)
        return out

    def _pred_plain(self, cur, memb):
        """int64[N] consume predicate bits of chars `cur` (int64[N], 0 past
        the row) with class bits `memb` (int32[N])."""
        pred = memb.to(torch.int64) & 0xFFFFFFFF
        for i, a in self.char_pairs:
            pred |= (cur == a).to(torch.int64) << i
        if self.any_bits:
            pred |= torch.where((cur != 10) & (cur != 0), self.any_bits, 0)
        if self.anynl_bits:
            pred |= torch.where(cur != 0, self.anynl_bits, 0)
        return torch.where(cur != 0, pred, 0)
