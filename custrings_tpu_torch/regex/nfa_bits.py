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

from functools import cached_property

import numpy as np
import torch

from .. import kernels
from ..column import i32_bits
from ..unicode.tables import FLAG_ALPHANUM, host_tables
from .compiler import ANY, ANYNL, CCLASS, CHAR, NCCLASS

MAX_BITS_INSTS = 32
#: offsets in `NFABits.char_table`, as csrc/spans.cu reads it: the ASCII
#: alnum set, ctx_map, then the class part [memb_B, n_cls, rmax, ...]
CT_ALNUM, CT_CTX, CT_CLS = 128, 132, 164
#: chars below this read `NFABits.memb_bmp`; above it only the ranges
BMP = 65536


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

    def on(self, name: str, device) -> torch.Tensor:
        """Cached copy of table `name` on `device` (as DeviceProgram.on)."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    @cached_property
    def crows_i64(self) -> torch.Tensor:
        """int64[U, I] closure rows (the plain versions' table)."""
        return torch.tensor(self.crows, dtype=torch.int64)

    # -- the span kernel's char tables (csrc/spans.cu), built on first use

    @cached_property
    def memb_bmp(self) -> torch.Tensor:
        """int32[65536 + 2048]: the class bit word of each BMP char (memb_B
        ^ memb_M[k] of each class k holding it), then the 64K table's alnum
        flag as bits (bit c & 31 of word c >> 5)."""
        tab = self.dp.class_tab.numpy()
        memb = np.full(BMP, self.memb_B & 0xFFFFFFFF, np.int64)
        for k, m in enumerate(self.memb_M):
            if m:
                memb ^= tab[k].astype(np.int64) * (m & 0xFFFFFFFF)
        flags, _ = host_tables()
        alnum = ((flags.astype(np.int64) & FLAG_ALPHANUM) > 0).reshape(BMP // 32, 32)
        words = (alnum.astype(np.int64) << np.arange(32, dtype=np.int64)).sum(axis=1)
        return torch.from_numpy(i32_bits(np.concatenate([memb, words])).astype(np.int32))

    @cached_property
    def char_table(self) -> torch.Tensor:
        """int32: [memb of chars 0..127, the ASCII alnum set (4 words),
        ctx_map (32), memb_B, n_cls, rmax, memb_M[n_cls], the classes'
        explicit ranges lo[n_cls, rmax] and hi[n_cls, rmax]] (the ranges
        decide chars above the BMP; builtins never match there)."""
        dp = self.dp
        n_cls, rmax = dp.cls_lo.shape
        head = [self.memb_B, n_cls, rmax, *self.memb_M]
        return torch.cat([
            self.memb_bmp[:128], dp.alnum_ascii, dp.ctx_map.to(torch.int32),
            torch.tensor(head, dtype=torch.int32), dp.cls_lo.flatten(), dp.cls_hi.flatten(),
        ])

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
        variant of each position (`DeviceProgram.position_uid`, None for a
        program with one variant)."""
        chars = chars.to(torch.int32)
        membw = torch.full(chars.shape, self.memb_B, dtype=torch.int32, device=chars.device)
        for c, m in enumerate(self.memb_M):
            if m:
                membw ^= self.dp._class_hit(chars, c, ascii).to(torch.int32) * m
        return membw, self.dp.position_uid(chars, lengths, ascii)

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
        table = self.on("table", chars.device)
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

    # -- the predicates from the span kernel's char tables --------------

    def _memb_plain(self, c):
        """int64 class bit word (32 bits used) of chars c, any shape, read
        from `char_table` and `memb_bmp` as csrc/spans.cu reads them."""
        dev = c.device
        ct = self.on("char_table", dev).to(torch.int64) & 0xFFFFFFFF
        bmp = self.on("memb_bmp", dev)[:BMP].to(torch.int64) & 0xFFFFFFFF
        c = c.to(torch.int64)
        n, r = int(ct[CT_CLS + 1]), int(ct[CT_CLS + 2])
        M, lo, hi = ct[CT_CLS + 3 :].split([n, n * r, n * r])[:3]
        astral = torch.full_like(c, int(ct[CT_CLS]))
        cE = c[..., None]
        for k in range(n):
            hit = ((cE >= lo[k * r : (k + 1) * r]) & (cE <= hi[k * r : (k + 1) * r])).any(dim=-1)
            astral ^= torch.where(hit, M[k], 0)
        bmp_m = torch.where(c < 128, ct[c.clamp(0, 127)], bmp[c.clamp(0, BMP - 1)])
        return torch.where((c >= 0) & (c < BMP), bmp_m, astral)

    def _alnum_plain(self, c):
        """bool: the word-boundary alnum flag of chars c (int64), from the
        same tables: the ASCII set, the BMP bits, false above."""
        dev = c.device
        ct = self.on("char_table", dev).to(torch.int64)
        bmp = self.on("memb_bmp", dev)[BMP:].to(torch.int64)
        w = torch.where(c < 128, ct[CT_ALNUM + (c.clamp(0, 127) >> 5)], bmp[c.clamp(0, BMP - 1) >> 5])
        return (c > 0) & (c < BMP) & (((w >> (c & 31)) & 1) != 0)

    def _uid_plane(self, chars, lens):
        """int64[N, L+1]: each position's closure variant (EOS slot
        included) from the chars at p - 1 and p (0 outside the row and
        past the matrix) and `char_table`'s ctx_map, as csrc/spans.cu
        computes it; None for a program with one variant."""
        if self.U == 1:
            return None
        N, L = chars.shape
        c = chars.to(torch.int64)
        pos = torch.arange(L + 1, dtype=torch.int64, device=c.device)[None, :]
        lensE = lens.to(torch.int64)[:, None]
        F = torch.nn.functional
        cur = torch.where((pos < lensE) & (pos < L), F.pad(c, (0, 1)), 0)
        prev = torch.where((pos > 0) & (pos - 1 < lensE), F.pad(c, (1, 0))[:, : L + 1], 0)
        ctx = self.dp._ctx(prev, cur, self._alnum_plain(prev), self._alnum_plain(cur), pos == 0)
        return self.on("char_table", chars.device)[CT_CTX + ctx].to(torch.int64)
