"""K2b: the multi-word bit NFA matcher (programs of up to 256 insts).

Port of `custrings_tpu/regex/pallas_nfa.py`: `pallas_supported` (the
instruction cap and the table budget), the W32 = ceil(I/32) membership
planes of `PallasNFA.__init__`, `_pos_tables` and `_matches_f32`.  On the
TPU the state is a dense f32 vector of the padded instruction count and
each step is two MXU products (`closed = state @ closure[uid]`, `state' =
(closed * pred) @ next`).  Here, as in K2, the state is a bitset: W32
32-bit words per row.  The CUDA kernel is `csrc/nfa_words.cu` (one thread
per row, the words in registers, the program table in shared memory); the
plain version below runs the same walk over all rows at once, one Python
iteration per position, on W32 int64 words per row holding 32 bits each,
and is what a CPU tensor takes.

The per-position planes stay in torch, as on the TPU: `membw` int32[N, L,
W32] (word w bit b is inst 32w + b's class predicate) and `uid` (the
closure variant of each position, `DeviceProgram.position_uid`, shared
with K2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..column import i32_bits
from .compiler import ANY, ANYNL, CCLASS, CHAR, NCCLASS

MAX_INSTS = 256
LANE = 128
#: the TPU's VMEM budget for the dense closure tables; kept as the routing
#: rule so that the port sends every program to the JAX package's engine
TABLE_BUDGET = 6 * 1024 * 1024

#: inst kinds in the kernel's table (`csrc/nfa_words.cu`)
K_OTHER, K_CHAR, K_ANY, K_ANYNL, K_CLASS = 0, 1, 2, 3, 4
_KIND = {CHAR: K_CHAR, ANY: K_ANY, ANYNL: K_ANYNL, CCLASS: K_CLASS, NCCLASS: K_CLASS}


def pallas_supported(dp) -> bool:
    """Can this program run on K2b (the dense matcher's instruction cap
    and table budget)?"""
    if dp.I > MAX_INSTS:
        return False
    PI = -(-max(dp.I, 1) // LANE) * LANE
    U = int(dp.closure_unique.shape[0])
    return U * PI * PI * 4 <= TABLE_BUDGET


def _words(bits: np.ndarray, W: int) -> list[int]:
    """bool[..., I] -> W 32-bit words per leading index (bit b of word w =
    bits[..., 32w + b]), as Python ints in a nested list."""
    I = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (W * 32,), np.int64)
    padded[..., :I] = bits
    words = (padded.reshape(bits.shape[:-1] + (W, 32)) << np.arange(32, dtype=np.int64)).sum(axis=-1)
    return words.tolist()


class NFAWords:
    """Multi-word bit tables of one DeviceProgram, and its matcher."""

    def __init__(self, dp):
        if not pallas_supported(dp):
            raise ValueError(
                f"program has {dp.I} instructions or too many closure variants "
                "for K2b; the vector engine takes it"
            )
        self.dp = dp
        prog = dp.prog
        I = self.I = dp.I
        W = self.W32 = -(-I // 32)
        cu = dp.closure_unique.numpy()
        self.U = cu.shape[0]
        # class membership in W planes: word w = B[w] ^ OR_c(in_class_c ?
        # M[c][w] : 0), M[c] the bits of the insts testing class c and B
        # those of the negated ones (PallasNFA's affine pack computes the
        # same bits, since no two insts share a bit)
        n_cls = max(len(prog.classes), 1)
        M = np.zeros((n_cls, I), np.bool_)
        B = np.zeros(I, np.bool_)
        for i in range(I):
            if prog.types[i] in (CCLASS, NCCLASS):
                M[int(prog.args[i]), i] = True
                B[i] = prog.types[i] == NCCLASS
        self.memb_M = [[i32_bits(v) for v in row] for row in _words(M, W)]
        crows = _words(cu, W)  # [U][I][W]
        nrows = _words(dp.next_mat.numpy(), W)  # [I][W]
        start_w = _words(dp.start_vec.numpy(), W)
        end_w = _words(dp.is_end.numpy(), W)
        self.inst = [
            (_KIND.get(int(prog.types[i]), K_OTHER) << 24) | (int(prog.args[i]) & 0xFFFFFF)
            for i in range(I)
        ]
        table = [self.U, I, W]
        table += [v for u in crows for row in u for v in row]
        table += [v for row in nrows for v in row]
        table += start_w + end_w + self.inst
        # host tables, copied to a device once by on(): the kernel's table,
        # the membership planes' base word, and the plain walk's rows as
        # int64 words of 32 bits
        self.table = torch.tensor([i32_bits(v) for v in table], dtype=torch.int32)
        self.memb_B = torch.tensor([i32_bits(v) for v in _words(B, W)], dtype=torch.int32)
        self.crows = torch.tensor(crows, dtype=torch.int64)
        self.nrows = torch.tensor(nrows, dtype=torch.int64)
        self.start_w = torch.tensor(start_w, dtype=torch.int64)
        self.end_w = torch.tensor(end_w, dtype=torch.int64)
        self._on = {}

    def on(self, name: str, device) -> torch.Tensor:
        """Cached copy of table `name` on `device`."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    def matches(self, chars, lengths, anchored: bool, ascii: bool = False):
        """bool[N]: does the program match row r (anchored: at 0)?

        chars int32[N, L] codepoints 0-padded; lengths int32[N]; ascii=True
        promises every codepoint < 128 (packed-bit predicates)."""
        N, L = chars.shape
        if N == 0:
            return torch.zeros(0, dtype=torch.bool, device=chars.device)
        membw, uid = self._pos_tables(chars, lengths, ascii)
        return self._matches_words(chars, lengths, membw, uid, anchored)

    def _pos_tables(self, chars, lengths, ascii: bool):
        """(membw int32[N, L, W32], uid int32[N, L+1] or None): the class
        bit planes of each char and the closure variant of each position."""
        chars = chars.to(torch.int32)
        base = self.on("memb_B", chars.device).expand(*chars.shape, self.W32)
        membw = base.clone(memory_format=torch.contiguous_format)  # a copy: XORed in place
        for c, Mc in enumerate(self.memb_M):
            if not any(Mc):
                continue
            hit = self.dp._class_hit(chars, c, ascii).to(torch.int32)
            for w, m in enumerate(Mc):
                if m:
                    membw[..., w] ^= hit * m
        return membw, self.dp.position_uid(chars, lengths, ascii)

    def _matches_words(self, chars, lengths, membw, uid, anchored: bool):
        if not chars.is_cuda:
            return self._matches_plain(chars, lengths, membw, uid, anchored)
        N, L = chars.shape
        W = self.W32
        if L == 0:
            raise ValueError("nfa_words: the char matrix has no columns")
        # the kernel reads the row-major planes in place (see nfa_words.cu)
        chars = chars.to(torch.int32).contiguous()
        membw = membw.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        if membw.shape != (N, L, W) or lens.shape != (N,):
            raise ValueError("nfa_words: membw or lengths do not fit the char matrix")
        table = self.on("table", chars.device)
        planes = [chars, membw, lens, table]
        if self.U > 1:  # the kernel reads uid only with several variants
            uid = uid.to(torch.int32).contiguous()
            if uid.shape != (N, L + 1):
                raise ValueError("nfa_words: uid does not fit the char matrix")
            planes.append(uid)
        for t in planes:
            kernels.require_cuda(t, "nfa_words")
        out = torch.empty(N, dtype=torch.uint8, device=chars.device)
        err = kernels.lib().cs_nfa_words(
            chars.data_ptr(), membw.data_ptr(), uid.data_ptr() if self.U > 1 else 0,
            lens.data_ptr(), table.data_ptr(), table.shape[0], N, L, W,
            1 if anchored else 0, out.data_ptr(), kernels.stream_ptr(chars),
        )
        kernels.check(err, "nfa_words")
        kernels.LAUNCHES["nfa_words"] += 1
        return out.bool()

    def _matches_plain(self, chars, lengths, membw, uid, anchored: bool):
        """The kernel's walk over all rows at once: W32 int64 words of 32
        bits per row, one iteration per position p = 0..L."""
        N, L = chars.shape
        dev = chars.device
        W = self.W32
        lens = lengths.to(torch.int64)
        crows, nrows = self.on("crows", dev), self.on("nrows", dev)
        start, end = self.on("start_w", dev), self.on("end_w", dev)
        shifts = torch.arange(32, dtype=torch.int64, device=dev)
        state = torch.zeros((N, W), dtype=torch.int64, device=dev)
        matched = torch.zeros(N, dtype=torch.bool, device=dev)
        for p in range(L + 1):
            pc = min(p, L - 1)
            cur = torch.where(p < lens, chars[:, pc].to(torch.int64), 0)
            if anchored:
                inj = ~matched if p == 0 else torch.zeros_like(matched)
            else:
                inj = ~matched & (p <= lens)
            state = torch.where(inj[:, None], state | start, state)
            sbits = ((state[:, :, None] >> shifts) & 1).bool()  # [N, W, 32]
            uidp = uid[:, p].to(torch.int64) if self.U > 1 else None
            closed = torch.zeros_like(state)
            for i in range(self.I):
                row = crows[:, i][uidp] if uidp is not None else crows[0, i]
                closed |= torch.where(sbits[:, i >> 5, i & 31, None], row, 0)
            matched |= ((closed & end) != 0).any(dim=1)
            cbits = ((closed[:, :, None] >> shifts) & 1).bool()
            mbits = ((membw[:, pc].to(torch.int64)[:, :, None] >> shifts) & 1).bool()
            live = cur != 0
            nxt = torch.zeros_like(state)
            for i in range(self.I):
                kind, arg = self.inst[i] >> 24, self.inst[i] & 0xFFFFFF
                if kind == K_OTHER:
                    continue
                fire = cbits[:, i >> 5, i & 31] & live
                if kind == K_CHAR:
                    fire = fire & (cur == arg)
                elif kind == K_ANY:
                    fire = fire & (cur != 10)
                elif kind == K_CLASS:
                    fire = fire & mbits[:, i >> 5, i & 31]
                nxt |= torch.where(fire[:, None], nrows[i], 0)
            state = nxt
        return matched
