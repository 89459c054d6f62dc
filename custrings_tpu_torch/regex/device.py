"""Regex program tables and the per-character predicate helpers.

Port of the table part of `custrings_tpu/regex/device.py`
(`DeviceProgram.__init__`, `closure_tensor`, `class_match_table`,
`_lut128_hit`, `_class_membership`, and the alnum test of `_ctx_bits`;
the context bits themselves are built in `nfa_bits.NFABits._pos_tables`,
as the TPU kernel's `_pos_tables` builds them), and the span router
`spans_single` / `all_spans` on the bit span passes (K5).  The tables are
built on the host with the same numpy code and kept as CPU tensors;
`on(name, device)` hands out a cached device copy.  The boolean matcher
itself is `regex/nfa_bits.py` (K2), the span passes `regex/span_bits.py`.

Only programs the span passes take are ported: `longest_safe` or
`end_unique`, and at most 32 instructions.  The JAX package's other span
engines (min-plus `nfa_spans`, the ordered-closure `ordered_spans` and the
per-row DFS `run_spans`) are not ported yet; `spans_single` raises
NotImplementedError for the programs that need them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import i32_bits
from ..unicode.tables import FLAG_ALPHANUM, device_tables, host_tables
from .compiler import (
    ANY,
    ANYNL,
    B_D,
    B_ND,
    B_NS,
    B_NW,
    B_S,
    B_W,
    BOL,
    BOW,
    CCLASS,
    CHAR,
    END,
    EOL,
    LBRA,
    NBOW,
    NCCLASS,
    OR,
    RBRA,
    Program,
)

# context bits for eps-edges
CTX_BOS = 1  # pos == 0
CTX_PREV_NL = 2  # prev char == '\n'
CTX_EOS = 4  # cur char == sentinel 0 (pos == len)
CTX_CUR_NL = 8  # cur char == '\n'
CTX_WB = 16  # word boundary (alnum(prev) != alnum(cur))


def _edge_active(ptype, parg, ctx):
    """Is the eps-edge of this inst active under ctx bits?"""
    if ptype in (LBRA, RBRA, OR):
        return True
    if ptype == BOL:
        if parg == ord("^"):
            return bool(ctx & (CTX_BOS | CTX_PREV_NL))
        return bool(ctx & CTX_BOS)
    if ptype == EOL:
        if parg == ord("$"):
            return bool(ctx & (CTX_EOS | CTX_CUR_NL))
        return bool(ctx & CTX_EOS)
    if ptype == BOW:
        return bool(ctx & CTX_WB)
    if ptype == NBOW:
        return not (ctx & CTX_WB)
    return False


def closure_tensor(prog: Program) -> np.ndarray:
    """bool[32, I, I]: closure[ctx, i, j] — from inst i, consuming/END inst
    j is reachable over eps-edges under anchor context ctx."""
    I = prog.n_insts
    out = np.zeros((32, I, I), np.bool_)
    consuming = np.isin(prog.types, (CHAR, ANY, ANYNL, CCLASS, NCCLASS, END))
    for ctx in range(32):
        adj = np.zeros((I, I), np.bool_)
        for i in range(I):
            t = prog.types[i]
            if consuming[i]:
                continue
            if _edge_active(t, prog.args[i], ctx):
                adj[i, prog.next_ids[i]] = True
                if t == OR:
                    adj[i, prog.args[i]] = True
        reach = np.eye(I, dtype=np.bool_) | adj
        for _ in range(I.bit_length() + 1):
            nxt = reach | (reach @ reach)
            if (nxt == reach).all():
                break
            reach = nxt
        out[ctx] = reach & consuming[None, :]
    return out


def class_match_table(prog: Program) -> np.ndarray:
    """bool[n_classes, 65536] membership of every BMP codepoint."""
    flags, _ = host_tables()
    n = len(prog.classes)
    cps = np.arange(65536, dtype=np.int64)
    alnum = (flags & FLAG_ALPHANUM) > 0
    space = (flags & 16) > 0
    digit = (flags & 4) > 0
    tab = np.zeros((max(n, 1), 65536), np.bool_)
    for k, cls in enumerate(prog.classes):
        m = np.zeros(65536, np.bool_)
        r = cls.ranges
        for i in range(0, len(r), 2):
            lo, hi = r[i], min(r[i + 1], 65535)
            if lo < 65536:
                m[lo : hi + 1] = True
        b = cls.builtins
        if b & B_W:
            m |= alnum | (cps == ord("_"))
        if b & B_S:
            m |= space
        if b & B_D:
            m |= digit
        if b & B_NW:
            m |= (~alnum) & (cps != ord("_")) & (cps != ord("\n"))
        if b & B_NS:
            m |= ~space
        if b & B_ND:
            m |= (~digit) & (cps != ord("\n"))
        tab[k] = m
    return tab


def _pack128(bits: np.ndarray) -> np.ndarray:
    """bool[..., 128] -> int32[..., 4] holding uint32 bit patterns: bit b of
    word w = bits[w*32 + b]."""
    words = bits.reshape(bits.shape[:-1] + (4, 32)).astype(np.int64)
    packed = (words << np.arange(32, dtype=np.int64)).sum(axis=-1)
    return i32_bits(packed).astype(np.int32)


class DeviceProgram:
    """A compiled program's tables (CPU tensors; `on()` moves them)."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.I = prog.n_insts
        closure = closure_tensor(prog)
        uniq, ctx_map = [], np.zeros(32, np.int32)
        for ctx in range(32):
            for k, m in enumerate(uniq):
                if (m == closure[ctx]).all():
                    ctx_map[ctx] = k
                    break
            else:
                ctx_map[ctx] = len(uniq)
                uniq.append(closure[ctx])
        self.closure_unique = torch.from_numpy(np.stack(uniq))
        self.ctx_map = torch.from_numpy(ctx_map)
        tab = class_match_table(prog)
        self.class_tab = torch.from_numpy(tab)
        # explicit class ranges at full codepoint width for non-BMP chars
        n_cls = max(len(prog.classes), 1)
        rmax = max([len(c.ranges) // 2 for c in prog.classes] or [0])
        lo = np.ones((n_cls, max(rmax, 1)), np.int32)
        hi = np.zeros((n_cls, max(rmax, 1)), np.int32)
        for k, cls in enumerate(prog.classes):
            r = cls.ranges
            for j in range(0, len(r), 2):
                lo[k, j // 2], hi[k, j // 2] = r[j], r[j + 1]
        self.cls_lo = torch.from_numpy(lo)
        self.cls_hi = torch.from_numpy(hi)
        I = self.I
        nm = np.zeros((I, I), np.bool_)
        for i in range(I):
            if prog.types[i] in (CHAR, ANY, ANYNL, CCLASS, NCCLASS):
                nm[i, prog.next_ids[i]] = True
        self.next_mat = torch.from_numpy(nm)
        self.is_end = torch.from_numpy(prog.types == END)
        start = np.zeros(I, np.bool_)
        start[prog.start_ids] = True
        self.start_vec = torch.from_numpy(start)
        # ASCII fast path: class membership and the alnum flag over
        # codepoints 0..127, packed into 4 32-bit words
        self.cls_ascii = torch.from_numpy(_pack128(tab[:, :128]))
        flags_h, _ = host_tables()
        self.alnum_ascii = torch.from_numpy(
            _pack128((flags_h[:128].astype(np.int64) & FLAG_ALPHANUM) > 0)
        )
        self._on = {}

    def on(self, name: str, device) -> torch.Tensor:
        """Cached copy of table `name` on `device`."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    @staticmethod
    def _lut128_hit(c: torch.Tensor, lut4: torch.Tensor) -> torch.Tensor:
        """bit c of a 128-bit set packed into 4 words; caller guarantees
        0 <= c < 128 (codepoints >= 128 read word 3, as on the TPU)."""
        word = lut4[(c >> 5).clamp(0, 3)]
        return ((word >> (c & 31)) & 1) != 0

    def _alnum(self, c: torch.Tensor, ascii: bool) -> torch.Tensor:
        """Word-boundary alnum test (IS_ALPHANUM only)."""
        if ascii:
            return (c > 0) & self._lut128_hit(c, self.on("alnum_ascii", c.device))
        flags, _ = device_tables(c.device)
        safe = c.clamp(0, flags.shape[0] - 1)
        return (c > 0) & (c < flags.shape[0]) & ((flags[safe] & FLAG_ALPHANUM) != 0)

    def _class_membership(self, c: torch.Tensor, ascii: bool = False) -> torch.Tensor:
        """bool[..., n_classes] for chars c.

        BMP chars read the 64K table; chars >= 0x10000 compare against the
        explicit ranges, builtins never matching there.  ascii=True (every
        c < 128): packed-bit test, no table gather."""
        if ascii:
            packs = self.on("cls_ascii", c.device)
            return torch.stack(
                [self._lut128_hit(c, packs[k]) for k in range(packs.shape[0])], dim=-1
            )
        tab = self.on("class_tab", c.device)
        hit = tab[:, c.clamp(0, 65535)].movedim(0, -1)
        lo = self.on("cls_lo", c.device)
        hi = self.on("cls_hi", c.device)
        cE = c[..., None, None]
        hi_hit = ((cE >= lo) & (cE <= hi)).any(dim=-1)
        return torch.where((c < 65536)[..., None], hit & (c >= 0)[..., None], hi_hit)

    def _span_bits(self):
        """The program's span passes (K5), or None when it is not
        certified or has more than 32 instructions (cached)."""
        if not hasattr(self, "_sbits"):
            from .nfa_bits import NFABits, pallas_supported
            from .span_bits import SpanBits, span_bits_ok

            ok = span_bits_ok(self.prog) and pallas_supported(self)
            self._sbits = SpanBits(NFABits(self)) if ok else None
        return self._sbits

    def _span_bits_or_raise(self):
        sb = self._span_bits()
        if sb is None:
            from .span_bits import span_bits_ok

            if not span_bits_ok(self.prog):
                need = (
                    "the ordered-closure engine (DeviceProgram.ordered_spans, "
                    "custrings_tpu/regex/device.py:783) or the per-row DFS "
                    "(run_spans, :945)"
                )
                why = "is neither longest_safe nor end_unique"
            else:
                need = "the min-plus engine (DeviceProgram.nfa_spans, custrings_tpu/regex/device.py:541)"
                why = f"has {self.I} instructions (the bit span passes take at most 32)"
            raise NotImplementedError(
                f"the span program {why}: it needs {need}, "
                "which is not ported yet (ROADMAP queue 1, item 10)"
            )
        return sb

    def spans_single(self, chars, lengths, start_pos, ascii: bool = False):
        """First match at or after start_pos per row: (matched bool[N],
        begin int32[N], end int32[N]), on the bit span passes (K5)."""
        return self._span_bits_or_raise().single(chars, lengths, start_pos, ascii)

    def all_spans(self, chars, lengths, validity, Rcap: int, ascii: bool = False,
                  counts_only: bool = False):
        """ALL non-overlapping leftmost matches per row: a round loop around
        `spans_single` with the reference's advance rule (count.cu:178-199:
        begin = end if end > begin else begin + 1).

        Returns (counts int32[N], begins int32[N, Rcap], ends int32[N,
        Rcap]); match r of a row sits in column r, -1 past its count (with
        counts_only the planes are [N, 1] of -1).  A row leaves the loop
        for good at its first miss or when its begin passes its length.

        The per-position planes are built once for all rounds (the JAX
        package rebuilds them inside each round), and a row that has left
        the loop is given a start past its length, so the span passes skip
        it; its result was masked out anyway."""
        sb = self._span_bits_or_raise()
        N, L = chars.shape
        dev = chars.device
        membw, uid = sb.tables(chars, lengths, ascii)
        lens = lengths.to(torch.int32)
        W = 1 if counts_only else Rcap
        B = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        E = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        begins = torch.zeros(N, dtype=torch.int32, device=dev)
        active = validity.to(torch.bool).clone()
        skip = torch.full_like(begins, (1 << 31) - 1)
        r = 0
        while r < Rcap and bool(active.any()):
            m, b, e = sb.spans(chars, lens, torch.where(active, begins, skip), membw, uid)
            hit = active & m
            counts += hit.to(torch.int32)
            if not counts_only:
                B[:, r] = torch.where(hit, b, -1)
                E[:, r] = torch.where(hit, e, -1)
            begins = torch.where(hit, torch.where(e > b, e, begins + 1), begins)
            active = hit & (begins <= lens)
            r += 1
        return counts, B, E

