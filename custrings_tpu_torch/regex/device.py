"""Regex program tables, the per-character predicates and the two dense
boolean engines.

Port of `custrings_tpu/regex/device.py`: the tables (`DeviceProgram.
__init__`, `closure_tensor`, `class_match_table`), the predicate helpers
(`_lut128_hit`, `_class_membership`, `_ctx_bits`, `_char_pred`) of the
torch engines, the vector engine `nfa_matches` and the chunked engine
`nfa_matches_chunked` (plain torch, as the JAX package left them to XLA),
and the span router `spans_single` / `all_spans` on the span kernel (K5,
one launch per call).  The tables are built on the host with the same
numpy code and kept as CPU tensors; `on(name, device)` hands out a cached
device copy.  The bit matchers are `regex/nfa_bits.py` (K2) and
`regex/nfa_words.py` (K2b), the span passes `regex/span_bits.py`; the
three kernels compute predicates and closure variants from the chars
through the per-char tables of `regex/nfa_chars.py`, so no per-position
plane is built for them.

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


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean (batched) matrix product as a float product and a > 0 test:
    every product term is 0 or 1, so a sum is positive exactly when one
    term is, in any float type and summation order (float16 on the card,
    float32 on the CPU)."""
    ft = torch.float16 if a.is_cuda else torch.float32
    return (a.to(ft) @ b.to(ft)) > 0


def _combine_pairs(T, A, S, M):
    """One round of the chunked engine's fold over the chunk axis (dim 1):
    segments 2k and 2k+1 combine; an odd last segment passes through."""
    C = T.shape[1]
    h = C // 2
    x, y = slice(0, 2 * h, 2), slice(1, 2 * h, 2)
    T1, A1, S1, M1 = T[:, x], A[:, x], S[:, x], M[:, x]
    T2, A2, S2, M2 = T[:, y], A[:, y], S[:, y], M[:, y]
    out = (
        _bmm(T1, T2),
        A1 | _bmm(T1, A2[..., None])[..., 0],
        _bmm(S1[..., None, :], T2)[..., 0, :] | S2,
        M1 | M2 | (S1 & A2).any(dim=-1),
    )
    if C % 2:
        out = tuple(torch.cat([o, z[:, C - 1 :]], dim=1) for o, z in zip(out, (T, A, S, M)))
    return out


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
        self.types = torch.from_numpy(prog.types.astype(np.int32))
        self.args = torch.from_numpy(prog.args.astype(np.int32))
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

    def _class_hit(self, c: torch.Tensor, k: int, ascii: bool = False) -> torch.Tensor:
        """bool[...]: is char c in class k?

        BMP chars read the 64K table; chars >= 0x10000 compare against the
        explicit ranges, builtins never matching there.  ascii=True (every
        c < 128): packed-bit test, no table gather."""
        if ascii:
            return self._lut128_hit(c, self.on("cls_ascii", c.device)[k])
        hit = self.on("class_tab", c.device)[k][c.clamp(0, 65535)]
        lo, hi = self.on("cls_lo", c.device)[k], self.on("cls_hi", c.device)[k]
        cE = c[..., None]
        hi_hit = ((cE >= lo) & (cE <= hi)).any(dim=-1)
        return torch.where(c < 65536, hit & (c >= 0), hi_hit)

    def _class_membership(self, c: torch.Tensor, ascii: bool = False) -> torch.Tensor:
        """bool[..., n_classes] for chars c (`_class_hit` of every class)."""
        n = self.cls_ascii.shape[0]
        return torch.stack([self._class_hit(c, k, ascii) for k in range(n)], dim=-1)

    @staticmethod
    def _ctx(prev_c, cur_c, al_prev, al_cur, is_bos) -> torch.Tensor:
        """int32 anchor-context bits from a position's previous and current
        chars (0 outside the row), their alnum flags and its BOS flag."""
        i32 = torch.int32
        return (
            is_bos.to(i32) * CTX_BOS
            | (prev_c == 10).to(i32) * CTX_PREV_NL
            | (cur_c == 0).to(i32) * CTX_EOS
            | (cur_c == 10).to(i32) * CTX_CUR_NL
            | (al_cur != al_prev).to(i32) * CTX_WB
        )

    def _ctx_bits(self, prev_c, cur_c, is_bos, ascii: bool = False) -> torch.Tensor:
        return self._ctx(prev_c, cur_c, self._alnum(prev_c, ascii), self._alnum(cur_c, ascii), is_bos)

    def _char_pred(self, c: torch.Tensor, ascii: bool = False) -> torch.Tensor:
        """bool[..., I]: does char c satisfy each consuming inst?  The
        sentinel 0 satisfies none."""
        types = self.on("types", c.device)
        args = self.on("args", c.device)
        cE = c[..., None]
        in_class = self._class_membership(c, ascii)
        cls_hit = in_class[..., args.clamp(0, in_class.shape[-1] - 1)]
        pred = (
            ((types == CHAR) & (cE == args))
            | ((types == ANY) & (cE != 10))
            | (types == ANYNL)
            | ((types == CCLASS) & cls_hit)
            | ((types == NCCLASS) & ~cls_hit)
        )
        return pred & (cE != 0)

    def _select_close(self, x: torch.Tensor, uid: torch.Tensor) -> torch.Tensor:
        """bool, x's shape: the eps-closure of the state sets x ([M, I] or
        [M, I, I], each row a set) under each leading row's variant uid[M]:
        one boolean product per unique closure, then a select."""
        cu = self.on("closure_unique", x.device)
        out = None
        for k in range(cu.shape[0]):
            ck = _bmm(x, cu[k])
            if out is None:
                out = ck
            else:
                cond = (uid == k).view(-1, *([1] * (x.dim() - 1)))
                out = torch.where(cond, ck, out)
        return out

    def _step_next(self, fire: torch.Tensor) -> torch.Tensor:
        """bool: the states the fired consuming insts lead to."""
        return _bmm(fire, self.on("next_mat", fire.device))

    # -- the vector engine -------------------------------------------------

    def nfa_matches(self, chars, lengths, anchored: bool, ascii: bool = False) -> torch.Tensor:
        """bool[N]: does the program match row r (anchored: at 0)?

        Port of `DeviceProgram.nfa_matches`: the state is bool[N, I], one
        step per position p = 0..L, one [N, I] @ [I, I] product per unique
        closure then a select by uid, and a product with the next-pointer
        matrix.  The route for programs K2 and K2b do not take, and the
        tests' oracle.  chars int32[N, L] codepoints 0-padded; lengths
        int32[N]; ascii=True promises every codepoint < 128."""
        N, L = chars.shape
        dev = chars.device
        lengths = lengths.to(torch.int32)
        state = torch.zeros((N, self.I), dtype=torch.bool, device=dev)
        matched = torch.zeros(N, dtype=torch.bool, device=dev)
        if N == 0:
            return matched
        start = self.on("start_vec", dev)
        is_end = self.on("is_end", dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        for p in range(L + 1):
            cur = torch.where(p < lengths, chars[:, min(p, L - 1)].to(torch.int32), zero)
            pp = max(min(p - 1, L - 1), 0)
            prev = torch.where((p > 0) & (p - 1 < lengths), chars[:, pp].to(torch.int32), zero)
            if anchored:
                inject = ~matched if p == 0 else torch.zeros_like(matched)
            else:
                # starts only at positions 0..len (p = len is the EOS slot)
                inject = ~matched & (p <= lengths)
            state = state | (start[None, :] & inject[:, None])
            bos = torch.full((N,), p == 0, dtype=torch.bool, device=dev)
            uid = self.on("ctx_map", dev)[self._ctx_bits(prev, cur, bos, ascii)]
            closed = self._select_close(state, uid)
            matched = matched | (closed & is_end[None, :]).any(dim=1)
            state = self._step_next(closed & self._char_pred(cur, ascii))
        return matched

    # -- the chunked engine ------------------------------------------------

    def nfa_matches_chunked(self, chars, lengths, anchored: bool, G: int, ascii: bool = False) -> torch.Tensor:
        """bool[N]: `nfa_matches` for long rows, by chunks of G chars.

        Port of `DeviceProgram.nfa_matches_chunked`.  Each of the C chunks
        of a row evolves, over its G positions, its transfer relation
          T [I, I]  entry state i -> state j at the chunk's end
          A [I]     entry state i reaches END inside the chunk
          S [I]     a start injected inside the chunk reaches state j
          M         a start injected inside the chunk reaches END inside
        and two segments compose associatively (o = boolean product)
          T = T1 o T2   A = A1 | T1 o A2   S = S1 o T2 | S2   M = M1 | M2 | S1.A2
        so the chunks combine in log2(C) rounds of pairwise combines, then
        one sentinel step at the padded end closes the row."""
        N, L = chars.shape
        I = self.I
        dev = chars.device
        if N == 0:
            return torch.zeros(0, dtype=torch.bool, device=dev)
        C = max(-(-L // G), 1)
        Lp = C * G
        chars = chars.to(torch.int32)
        lengths = lengths.to(torch.int32)
        if Lp != L:
            chars = torch.nn.functional.pad(chars, (0, Lp - L))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        goff = torch.arange(C, dtype=torch.int32, device=dev)[None, :] * G
        clen = (lengths[:, None] - goff).clamp(0, G)
        prev0 = torch.where(
            (goff > 0) & (goff - 1 < lengths[:, None]),
            torch.gather(chars, 1, (goff - 1).clamp(min=0).expand(N, C).to(torch.int64)),
            zero,
        )
        Nc = N * C
        ch = chars.reshape(Nc, G)
        clen_f = clen.reshape(Nc)
        prev0_f = prev0.reshape(Nc)
        cidx = torch.arange(Nc, dtype=torch.int32, device=dev) % C
        glob0 = cidx == 0
        goff_f = cidx * G
        len_f = lengths[:, None].expand(N, C).reshape(Nc)
        start = self.on("start_vec", dev)
        is_end = self.on("is_end", dev)
        ctx_map = self.on("ctx_map", dev)

        T = torch.eye(I, dtype=torch.bool, device=dev).expand(Nc, I, I)
        A = torch.zeros((Nc, I), dtype=torch.bool, device=dev)
        S = torch.zeros((Nc, I), dtype=torch.bool, device=dev)
        M = torch.zeros(Nc, dtype=torch.bool, device=dev)
        for g in range(G):
            cur = torch.where(g < clen_f, ch[:, g], zero)
            prev = prev0_f if g == 0 else torch.where(g - 1 < clen_f, ch[:, g - 1], zero)
            bos = glob0 & (g == 0)
            uid = ctx_map[self._ctx_bits(prev, cur, bos, ascii)]
            inj = (goff_f + g) <= len_f
            cS = self._select_close(S | (start[None, :] & inj[:, None]), uid)
            cT = self._select_close(T, uid)
            M = M | (cS & is_end[None, :]).any(dim=1)
            A = A | (cT & is_end[None, None, :]).any(dim=2)
            pred = self._char_pred(cur, ascii)
            S = self._step_next(cS & pred)
            T = self._step_next(cT & pred[:, None, :])

        T = T.reshape(N, C, I, I)
        A = A.reshape(N, C, I)
        S = S.reshape(N, C, I)
        M = M.reshape(N, C)
        # fold the chunk axis: pair (2k, 2k+1) in each round; an odd last
        # segment passes through unchanged (the combine is associative)
        while T.shape[1] > 1:
            T, A, S, M = _combine_pairs(T, A, S, M)
        T1, A1, S1, M1 = T[:, 0], A[:, 0], S[:, 0], M[:, 0]

        sv = start[None, :].expand(N, I)
        if anchored:
            matched = (sv & A1).any(dim=1)
            vend = _bmm(sv[:, None, :], T1)[:, 0, :]
        else:
            matched = M1
            # inject at the final EOS slot only for rows whose EOS is there
            vend = S1 | (sv & (Lp <= lengths)[:, None])
        # the sentinel step at p = Lp (EOS context; consumes nothing)
        prevL = torch.where((Lp - 1 < lengths) & (Lp > 0), chars[:, Lp - 1], zero)
        bos = torch.full((N,), Lp == 0, dtype=torch.bool, device=dev)
        uid = ctx_map[self._ctx_bits(prevL, torch.zeros(N, dtype=torch.int32, device=dev), bos, ascii)]
        closed = self._select_close(vend, uid)
        return matched | (closed & is_end[None, :]).any(dim=1)

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
                "which is not ported yet (ROADMAP queue 1, item 2)"
            )
        return sb

    def spans_single(self, chars, lengths, start_pos, ascii: bool = False):
        """First match at or after start_pos per row: (matched bool[N],
        begin int32[N], end int32[N]), on the bit span passes (K5)."""
        return self._span_bits_or_raise().single(chars, lengths, start_pos, ascii)

    def all_spans(self, chars, lengths, validity, Rcap: int, ascii: bool = False,
                  counts_only: bool = False):
        """ALL non-overlapping leftmost matches per row, with the
        reference's advance rule (count.cu:178-199: begin = end if end >
        begin else begin + 1), in one pass of the span kernel (K5,
        `SpanBits.all`): the JAX package's round loop of `spans_single`
        with each row walked back once.

        Returns (counts int32[N], begins int32[N, Rcap], ends int32[N,
        Rcap]); match r of a row sits in column r, -1 past its count (with
        counts_only the planes are [N, 1] of -1).  A row stops at its first
        miss, after Rcap matches or when its begin passes its length.  The
        predicates come from the program's char tables, so `ascii` is a
        hint the kernel does not need; it is accepted for the callers'
        ASCII / non-ASCII split."""
        sb = self._span_bits_or_raise()
        return sb.all(chars, lengths, validity, Rcap, counts_only=counts_only)
