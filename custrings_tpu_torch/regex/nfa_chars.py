"""The per-char tables of the bit matchers (K2, K2b) and the span passes (K5).

The kernels `csrc/nfa_bits.cu`, `csrc/nfa_words.cu` and `csrc/spans.cu`
compute each position's consume predicate and closure variant from the
chars at p - 1 and p (`csrc/nfa_chars.cuh`), through two tables built
once per program on the host and cached per device (`on`), with W =
ceil(I / 32) words a char (bit i % 32 of word i // 32 is instruction i):

    char_table  int32 [pred_a[128, W], alnum[4], ctx_map[32],
                       memb_B[W], n_cls, rmax, memb_M[n_cls, W],
                       lo[n_cls, rmax], hi[n_cls, rmax]]
    memb_bmp    int32 [memb[65536, W], alnum bits[2048]]

pred_a is the whole consume predicate of each ASCII char (its class bits,
CHAR, ANY, ANYNL; 0 at c = 0), alnum the ASCII word-boundary set and
ctx_map the closure variant of each context; these form the head that the
kernels copy to shared memory.  The class words of a BMP char are memb_B ^
memb_M[k] of each class k holding it; a char above the BMP tests the
classes' explicit ranges (builtins never match there).  The word-boundary
flag of a BMP char is bit c & 31 of alnum word c >> 5.

`CharTables` builds both and expands them per position for the plain
versions, reading them as the kernels do.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..column import i32_bits
from ..unicode.tables import FLAG_ALPHANUM, host_tables
from .compiler import ANY, ANYNL, CCLASS, CHAR, NCCLASS

#: chars below this read `memb_bmp`; above it only the explicit ranges
BMP = 65536
MASK = 0xFFFFFFFF


def words(bits: np.ndarray, W: int) -> list:
    """bool[..., I] -> W 32-bit words per leading index (bit b of word w =
    bits[..., 32w + b]), as Python ints in a nested list."""
    I = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (W * 32,), np.int64)
    padded[..., :I] = bits
    return (padded.reshape(bits.shape[:-1] + (W, 32)) << np.arange(32, dtype=np.int64)).sum(axis=-1).tolist()


class CharTables:
    """The char tables of one DeviceProgram; a base of NFABits (W = 1) and
    NFAWords."""

    def __init__(self, dp, W: int):
        self.dp = dp
        self.W32 = W
        prog = dp.prog
        types = np.asarray(prog.types)
        n_cls = max(len(prog.classes), 1)
        # class membership: word w = B[w] ^ OR_c(in_class_c ? M[c][w] : 0),
        # M[c] the bits of the insts testing class c and B those of the
        # negated ones (PallasNFA's affine pack computes the same bits,
        # since no two insts share a bit)
        M = np.zeros((n_cls, dp.I), np.bool_)
        for i in np.nonzero(np.isin(types, (CCLASS, NCCLASS)))[0]:
            M[int(prog.args[i]), i] = True
        self.memb_B_w = words(types == NCCLASS, W)
        self.memb_M_w = words(M, W)
        self.any_w = words(types == ANY, W)
        self.anynl_w = words(types == ANYNL, W)
        self.char_pairs = [(i, int(prog.args[i])) for i in range(dp.I) if types[i] == CHAR]
        self._on = {}

    def on(self, name: str, device) -> torch.Tensor:
        """Cached copy of table `name` on `device`."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    @property
    def ct_alnum(self) -> int:
        """Offset of the ASCII alnum set in `char_table` (ctx_map 4 later,
        the class part 36 later)."""
        return 128 * self.W32

    @cached_property
    def memb_bmp(self) -> torch.Tensor:
        """int32[65536 * W + 2048]: the class words of each BMP char, then
        the 64K table's alnum flag as bits."""
        tab = self.dp.class_tab.numpy()
        memb = np.tile(np.asarray(self.memb_B_w, np.int64), (BMP, 1))
        for k, m in enumerate(self.memb_M_w):
            if any(m):
                memb ^= tab[k].astype(np.int64)[:, None] * np.asarray(m, np.int64)[None, :]
        flags, _ = host_tables()
        alnum = ((flags.astype(np.int64) & FLAG_ALPHANUM) > 0).reshape(BMP // 32, 32)
        alnum_w = (alnum.astype(np.int64) << np.arange(32, dtype=np.int64)).sum(axis=1)
        return torch.from_numpy(i32_bits(np.concatenate([memb.ravel(), alnum_w])).astype(np.int32))

    @cached_property
    def char_table(self) -> torch.Tensor:
        """int32: [pred_a[128, W], the ASCII alnum set (4), ctx_map (32),
        memb_B[W], n_cls, rmax, memb_M[n_cls, W], the classes' explicit
        ranges lo[n_cls, rmax] and hi[n_cls, rmax]]."""
        W, dp = self.W32, self.dp
        c = torch.arange(128, dtype=torch.int64)
        memb = self.memb_bmp[: 128 * W].to(torch.int64).view(128, W) & MASK
        pred_a = torch.where((c != 0)[:, None], self._with_insts(c, memb), 0)
        n_cls, rmax = dp.cls_lo.shape
        cls = [*self.memb_B_w, n_cls, rmax, *[v for row in self.memb_M_w for v in row]]
        return torch.cat([
            i32_bits(pred_a.flatten()).to(torch.int32), dp.alnum_ascii, dp.ctx_map.to(torch.int32),
            torch.tensor([i32_bits(v) for v in cls], dtype=torch.int32),
            dp.cls_lo.flatten(), dp.cls_hi.flatten(),
        ])

    # -- the tables expanded per position, as the kernels read them ------

    def _with_insts(self, c, memb):
        """int64[..., W]: class words `memb` of chars c with the CHAR pairs,
        ANY (c != '\\n') and ANYNL bits added."""
        out = memb.clone()
        for i, a in self.char_pairs:
            out[..., i >> 5] |= (c == a).to(torch.int64) << (i & 31)
        any_w = torch.tensor(self.any_w, dtype=torch.int64, device=c.device)
        anynl_w = torch.tensor(self.anynl_w, dtype=torch.int64, device=c.device)
        return out | torch.where((c != 10)[..., None], any_w, 0) | anynl_w

    def _memb_plain(self, c):
        """int64[..., W] class words (32 bits used each) of chars c, any
        shape: `memb_bmp` in the BMP, the explicit ranges above it."""
        dev, W = c.device, self.W32
        cls = self.on("char_table", dev)[self.ct_alnum + 36 :].to(torch.int64) & MASK
        bmp = self.on("memb_bmp", dev)[: BMP * W].to(torch.int64).view(BMP, W) & MASK
        c = c.to(torch.int64)
        n, r = int(cls[W]), int(cls[W + 1])
        M, lo, hi = cls[W + 2 :].split([n * W, n * r, n * r])[:3]
        M, lo, hi = M.view(n, W), lo.view(n, r), hi.view(n, r)
        astral = cls[:W].expand(*c.shape, W).clone()
        cE = c[..., None]
        for k in range(n):
            hit = ((cE >= lo[k]) & (cE <= hi[k])).any(dim=-1)
            astral ^= torch.where(hit[..., None], M[k], 0)
        in_bmp = (c >= 0) & (c < BMP)
        return torch.where(in_bmp[..., None], bmp[c.clamp(0, BMP - 1)], astral)

    def _pred_plain(self, cur):
        """int64[..., W] consume predicate words of chars cur (0 at cur ==
        0): pred_a for an ASCII char, else its class words with the CHAR
        pairs, ANY and ANYNL."""
        W = self.W32
        head = self.on("char_table", cur.device)[: 128 * W].to(torch.int64).view(128, W) & MASK
        cur = cur.to(torch.int64)
        ascii = (cur >= 0) & (cur < 128)
        return torch.where(ascii[..., None], head[cur.clamp(0, 127)], self._with_insts(cur, self._memb_plain(cur)))

    def _alnum_plain(self, c):
        """bool: the word-boundary alnum flag of chars c (int64): the ASCII
        set, the BMP bits, false above."""
        dev = c.device
        ct = self.on("char_table", dev).to(torch.int64)
        bits = self.on("memb_bmp", dev)[BMP * self.W32 :].to(torch.int64)
        w = torch.where(c < 128, ct[self.ct_alnum + (c.clamp(0, 127) >> 5)], bits[c.clamp(0, BMP - 1) >> 5])
        return (c > 0) & (c < BMP) & (((w >> (c & 31)) & 1) != 0)

    def _uid_plane(self, chars, lens):
        """int64[N, L+1]: each position's closure variant (EOS slot
        included) from the chars at p - 1 and p (0 outside the row and
        past the matrix) and `char_table`'s ctx_map; None for a program
        with one variant."""
        if int(self.dp.closure_unique.shape[0]) == 1:
            return None
        N, L = chars.shape
        c = chars.to(torch.int64)
        pos = torch.arange(L + 1, dtype=torch.int64, device=c.device)[None, :]
        lensE = lens.to(torch.int64)[:, None]
        F = torch.nn.functional
        cur = torch.where((pos < lensE) & (pos < L), F.pad(c, (0, 1)), 0)
        prev = torch.where((pos > 0) & (pos - 1 < lensE), F.pad(c, (1, 0))[:, : L + 1], 0)
        ctx = self.dp._ctx(prev, cur, self._alnum_plain(prev), self._alnum_plain(cur), pos == 0)
        return self.on("char_table", chars.device)[self.ct_alnum + 4 + ctx].to(torch.int64)
