"""Regex program tables, the per-character predicates and the engines.

Port of `custrings_tpu/regex/device.py`: the tables (`DeviceProgram.
__init__`, `closure_tensor`, `class_match_table`), the predicate helpers
(`_lut128_hit`, `_class_membership`, `_ctx_bits`, `_char_pred`), the two
boolean engines (the vector engine `nfa_matches` and the chunked engine
`nfa_matches_chunked`), the three span engines with capture groups and
the span routers.  The tables are built on the host with the same numpy
code and kept as CPU tensors; `on(name, device)` hands out a cached
device copy.  The bit matchers are `regex/nfa_bits.py` (K2) and
`regex/nfa_words.py` (K2b), the span passes `regex/span_bits.py` (K5);
the three kernels compute predicates and closure variants from the chars
through the per-char tables of `regex/nfa_chars.py`, so no per-position
plane is built for them.

The span engines are plain torch, as the JAX package left them to XLA:

    nfa_spans      min-plus: the least begin per instruction, for
                   `longest_safe` programs K5 does not take (over 32
                   instructions)
    ordered_spans  the ordered closure: per position, each instruction's
                   claim from host tables of the standalone DFS of every
                   seed, exact priority semantics and one capture group,
                   for programs of at most 128 instructions
    run_spans      the reference's per-row DFS list machine, all rows in
                   lockstep, for larger programs

Each step of the JAX engines unrolls Python loops over instructions into
one XLA fusion; here the instruction loops are gathers over padded index
tables built once per program, so a position is a few gathers and
reductions over [N, I, K].  Each row walks its own window: the engines
start row r at its own begin and stop at its own end, and an engine
stops when no row can change any more (the results are those of the
JAX loop over every position).

    spans_single   first match: K5 for certified programs of <= 32
                   instructions, else min-plus for `longest_safe`, else
                   spans_exec
    spans_exec     the exact engine: ordered (<= 128 instructions), else
                   the DFS
    all_spans      every non-overlapping match and, per match, the spans
                   of the asked capture groups: one K5 launch for a K5
                   program, else the round loop of spans_single over the
                   rows still active
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import i32_bits
from ..unicode.tables import FLAG_ALPHANUM, host_tables
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


#: inactive begin of the min-plus engine, inactive key of the ordered
#: engine, unreachable rank of the ordered engine's tables
INF_SPAN = 1 << 28
INF_KEY = 1 << 30
INF_RANK = 1 << 20
#: the ordered engine and the DFS test whether any row can still change
#: once every this many steps (each test is one device-to-host sync)
_EXIT_EVERY = 8


def _padded(lists, pad: int, width: int | None = None) -> torch.Tensor:
    """int64[len(lists), width]: each list's entries, then `pad` (width
    defaults to the longest list, at least 1)."""
    width = max([len(x) for x in lists] + [1]) if width is None else max(width, 1)
    out = np.full((len(lists), width), pad, np.int64)
    for i, x in enumerate(lists):
        out[i, : len(x)] = x
    return torch.from_numpy(out)


def _char_at(chars: torch.Tensor, pos: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """int32[N]: chars[r, pos[r]] (pos clamped into the row) where ok, else 0."""
    c = chars.gather(1, pos.clamp(0, chars.shape[1] - 1)[:, None])[:, 0]
    return torch.where(ok, c.to(torch.int32), 0)


def _steps(first: torch.Tensor, last: torch.Tensor) -> int:
    """The most positions a row walks from first to last (inclusive)."""
    return int((last - first + 1).clamp(min=0).max()) if first.numel() else 0


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
        self.start_ids = torch.from_numpy(prog.start_ids.astype(np.int64))
        self.groups_count = prog.groups_count
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
        self.alnum_bmp = torch.from_numpy((flags_h.astype(np.int64) & FLAG_ALPHANUM) != 0)
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
        flags = self.on("alnum_bmp", c.device)
        safe = c.clamp(0, flags.shape[0] - 1)
        return (c > 0) & (c < flags.shape[0]) & flags[safe]

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

    # -- the span engines ----------------------------------------------------

    def _span_bits(self):
        """The program's span passes (K5), or None when it is not
        certified or has more than 32 instructions (cached)."""
        if not hasattr(self, "_sbits"):
            from .nfa_bits import NFABits, pallas_supported
            from .span_bits import SpanBits, span_bits_ok

            ok = span_bits_ok(self.prog) and pallas_supported(self)
            self._sbits = SpanBits(NFABits(self)) if ok else None
        return self._sbits

    def _engine_tables(self):
        """Host tables shared by the span engines (cached): the consume
        sources of each instruction (the consuming non-END insts whose next
        it is) padded with I, int64[I, K]; the END insts, int64[E]."""
        if not hasattr(self, "next_src"):
            prog = self.prog
            cons = np.isin(prog.types, (CHAR, ANY, ANYNL, CCLASS, NCCLASS))
            self.next_src = _padded([np.nonzero(cons & (prog.next_ids == t))[0] for t in range(self.I)], self.I)
            self.end_ids = torch.from_numpy(np.nonzero(prog.types == END)[0].astype(np.int64))

    def nfa_spans(self, chars, lengths, start_pos, ascii: bool = False):
        """Leftmost-longest first match at or after start_pos for
        `longest_safe` programs: (matched bool[N], begin int32[N], end
        int32[N]), -1 where none.

        Port of `DeviceProgram.nfa_spans` (min-plus): every begin is
        explored at once, the state beg[N, I] holding the least begin
        that reaches each instruction (INF inactive); a position injects
        the start insts, takes the closure minimum over each instruction's
        incoming columns (`cc`: per unique closure, int64[U, I, K] padded
        with the INF column I), records END candidates (least begin, then
        the latest end) and consumes the char."""
        N, L = chars.shape
        dev = chars.device
        INF = INF_SPAN
        if not hasattr(self, "minplus_cc"):
            cu = self.closure_unique.numpy()
            per_u = [[np.nonzero(cu[u][:, j])[0] for j in range(self.I)] for u in range(cu.shape[0])]
            K = max(max((len(c) for c in cols), default=0) for cols in per_u)
            self.minplus_cc = torch.from_numpy(np.stack([_padded(cols, self.I, K).numpy() for cols in per_u]))
        cc = self.on("minplus_cc", dev)
        self._engine_tables()
        nsrc, end_ids = self.on("next_src", dev), self.on("end_ids", dev)
        ctx_map = self.on("ctx_map", dev)
        sids = self.on("start_ids", dev)
        lens = lengths.to(torch.int64)
        start = torch.as_tensor(start_pos, dtype=torch.int64, device=dev).expand(N)
        best_b = torch.full((N,), INF, dtype=torch.int32, device=dev)
        best_e = torch.full((N,), -1, dtype=torch.int32, device=dev)
        # row r walks positions P0[r]..last[r]; outside them nothing changes
        P0 = start.clamp(min=0)
        last = lens.clamp(max=L)
        steps = _steps(P0, last)
        inf1 = torch.full((N, 1), INF, dtype=torch.int32, device=dev)
        beg = torch.full((N, self.I), INF, dtype=torch.int32, device=dev)
        for q in range(steps):
            P = P0 + q
            upd = P <= last
            cur = _char_at(chars, P, P < lens)
            prev = _char_at(chars, P - 1, (P > 0) & (P - 1 < lens))
            inj = torch.where(upd, P, INF).to(torch.int32)
            beg[:, sids] = torch.minimum(beg[:, sids], inj[:, None])
            uid = ctx_map[self._ctx_bits(prev, cur, P == 0, ascii)]
            bp = torch.cat([beg, inf1], 1)
            closed = bp[:, cc[0]].amin(2)
            for u in range(1, cc.shape[0]):
                closed = torch.where((uid == u)[:, None], bp[:, cc[u]].amin(2), closed)
            if end_ids.numel():
                b_end = torch.where(upd, closed[:, end_ids].amin(1), INF)
                better = b_end < best_b
                best_e = torch.where(better | ((b_end == best_b) & (b_end < INF)), P.to(torch.int32), best_e)
                best_b = torch.where(better, b_end, best_b)
            fired = torch.where(self._char_pred(cur, ascii), closed, INF)
            beg = torch.cat([fired, inf1], 1)[:, nsrc].amin(2)
        matched = best_b < INF
        return matched, torch.where(matched, best_b, -1), torch.where(matched, best_e, -1)

    def _ordered_tables(self, group_id: int):
        """Host tables of ordered_spans for one group (cached): per unique
        context, each (seed s, target t)'s DFS rank and whether the path
        crossed the group's LBRA / RBRA, the context map, and each
        target's seed columns.

        Port of `DeviceProgram._ordered_tables`, the same numpy code: for
        each anchor context and seed inst s, the reference's addthread DFS
        (regexec.inl:279-362) run standalone records, for every
        consuming/END inst t it reaches, its visit rank and the capture
        bits of its path.  The merged expansion's claimant of t is the
        lexicographic least (seed priority, standalone rank) over seeds,
        with that path's capture bits."""
        if not hasattr(self, "_otabs"):
            self._otabs = {}
        if group_id in self._otabs:
            return self._otabs[group_id]
        prog = self.prog
        I = self.I
        INFR = np.int32(INF_RANK)
        consuming = (CHAR, ANY, ANYNL, CCLASS, NCCLASS, END)
        R = np.full((32, I, I), INFR, np.int32)
        SB = np.zeros((32, I, I), np.bool_)
        SE = np.zeros((32, I, I), np.bool_)
        for ctx in range(32):
            for s in range(I):
                stack = [(s, False, False)]
                visited = np.zeros(I, np.bool_)
                rank = 0
                while stack:
                    iid, sb, se = stack.pop()
                    if visited[iid]:
                        continue
                    visited[iid] = True
                    t = prog.types[iid]
                    if t in consuming:
                        R[ctx, s, iid] = rank
                        SB[ctx, s, iid] = sb
                        SE[ctx, s, iid] = se
                        rank += 1
                        continue
                    sb2 = sb or (t == LBRA and prog.args[iid] == group_id)
                    se2 = se or (t == RBRA and prog.args[iid] == group_id)
                    if t == OR:
                        # next = low priority (pushed first), args = high
                        stack.append((prog.next_ids[iid], sb2, se2))
                        stack.append((prog.args[iid], sb2, se2))
                    elif _edge_active(t, prog.args[iid], ctx):
                        stack.append((prog.next_ids[iid], sb2, se2))
        uniq, ctx_map = [], np.zeros(32, np.int32)
        for ctx in range(32):
            for k, (r0, b0, e0) in enumerate(uniq):
                if (r0 == R[ctx]).all() and (b0 == SB[ctx]).all() and (e0 == SE[ctx]).all():
                    ctx_map[ctx] = k
                    break
            else:
                ctx_map[ctx] = len(uniq)
                uniq.append((R[ctx], SB[ctx], SE[ctx]))
        anyfin = np.zeros((I, I), np.bool_)
        for r0, _, _ in uniq:
            anyfin |= r0 < INFR
        cols = [np.nonzero(anyfin[:, t])[0] for t in range(I)]
        tabs = ([u[0] for u in uniq], [u[1] for u in uniq], [u[2] for u in uniq], np.asarray(ctx_map), cols)
        self._otabs[group_id] = tabs
        return tabs

    def _ordered_index(self, group_id: int, dev):
        """ordered_spans' tables as tensors on dev (cached): each target's
        seeds int64[I, K] padded with the INF column I, their ranks
        int32[U, I, K] (INF_RANK on padding) and capture bits bool[U, I, K],
        the context map int64[32]."""
        key = ("ordered", group_id, str(dev))
        if key not in self._on:
            Runi, SBuni, SEuni, ctx_map, cols = self._ordered_tables(group_id)
            I = self.I
            seeds = _padded(cols, I).numpy()
            t = np.arange(I)[:, None]
            s = np.minimum(seeds, I - 1)
            pad = seeds >= I
            rk = np.stack([np.where(pad, INF_RANK, r[s, t]) for r in Runi]).astype(np.int32)
            sb = np.stack([np.where(pad, False, b[s, t]) for b in SBuni])
            se = np.stack([np.where(pad, False, e[s, t]) for e in SEuni])
            self._on[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (seeds, rk, sb, se, ctx_map.astype(np.int64))
            )
        return self._on[key]

    def ordered_spans(self, chars, lengths, begins, ends, group_id: int, ascii: bool = False):
        """Exact first-match spans with priority semantics and group
        group_id's capture: (matched int32[N], begin int32[N], end
        int32[N]), -1 where none; a match must begin in [begins, ends)
        (ends < 0: open).  Group 0 is the whole match.

        Port of `DeviceProgram.ordered_spans`.  Each live instruction holds
        a claim key (priority order; an injected start k of S gets I + k,
        the lowest) and the group's (b, e).  A position: inject the starts
        into empty slots; each consuming/END target t takes the least
        packed key*I*I + rank*I + s over its seeds s (the standalone DFS
        rank of t from s under the row's context) with the capture bits of
        that path; the highest-priority END claims a match and drops every
        lower thread; the char is consumed (each target the least key of
        its sources); and the keys are re-ranked densely (a stable argsort
        and its inverse).  A row past its own length is frozen."""
        N, L = chars.shape
        dev = chars.device
        I = self.I
        INF = INF_KEY
        if N == 0:
            z = torch.zeros(0, dtype=torch.int32, device=dev)
            return z, z.clone(), z.clone()
        seeds, rk, sbt, set_, ctx_map = self._ordered_index(group_id, dev)
        U = rk.shape[0]
        self._engine_tables()
        nsrc, end_ids = self.on("next_src", dev), self.on("end_ids", dev)
        start_ids = self.prog.start_ids.tolist()
        g0 = group_id == 0
        lens = lengths.to(torch.int64)
        begins = torch.as_tensor(begins, dtype=torch.int64, device=dev).expand(N)
        ends = torch.as_tensor(ends, dtype=torch.int64, device=dev).expand(N)
        seed_s = (seeds % I).to(torch.int32)  # the seed id of the packed key (padding is masked)
        tcol = torch.arange(I, device=dev)[None, :]
        # the working set: the rows that can still change, with their ids
        # (all rows at first); rows drop out once half of them are done
        rows = torch.arange(N, device=dev)
        out = torch.full((3, N), -1, dtype=torch.int32, device=dev)  # matched, mb, me by row id
        key = torch.full((N, I), INF, dtype=torch.int32, device=dev)
        b = torch.zeros((N, I), dtype=torch.int32, device=dev)
        e = torch.zeros((N, I), dtype=torch.int32, device=dev)
        matched = torch.zeros(N, dtype=torch.bool, device=dev)
        mb = torch.full((N,), -1, dtype=torch.int32, device=dev)
        me = torch.full((N,), -1, dtype=torch.int32, device=dev)
        # row r walks positions P0[r]..last[r]: before its begin nothing is
        # live, after its length it is frozen
        P0 = begins.clamp(min=0)
        last = lens.clamp(max=L)
        steps = _steps(P0, last)
        n = N
        for q in range(steps):
            if q == 0 or n != inf1.shape[0]:
                inf1 = torch.full((n, 1), INF, dtype=torch.int32, device=dev)
                zero1 = torch.zeros((n, 1), dtype=torch.int32, device=dev)
                ar = torch.arange(I, dtype=torch.int32, device=dev).expand(n, I)
            P = P0 + q
            P32 = P.to(torch.int32)
            upd = P <= last
            cur = _char_at(chars, P, upd)
            prev = _char_at(chars, P - 1, (P > 0) & (P - 1 < lens))
            can = upd & ~matched & (P >= begins) & ((ends < 0) | (P < ends))
            for k, sid in enumerate(start_ids):
                take = can & (key[:, sid] >= INF)
                key[:, sid] = torch.where(take, I + k, key[:, sid])
                b[:, sid] = torch.where(take, P32 if g0 else -1, b[:, sid])
                e[:, sid] = torch.where(take, -1, e[:, sid])
            uid = ctx_map[self._ctx_bits(prev, cur, P == 0, ascii)]
            # claim each consuming/END target from its seeds
            ks = torch.cat([key, inf1], 1)[:, seeds]
            r = rk[0] if U == 1 else rk[uid]
            ok = (ks < INF) & (r < INF_RANK)
            cand = torch.where(ok, torch.where(ok, ks, 0) * (I * I) + r * I + seed_s, INF)
            ckey, kmin = cand.min(dim=2)
            src = seeds[tcol, kmin]
            hb = (sbt[0][tcol, kmin] if U == 1 else sbt[uid[:, None], tcol, kmin])
            he = (set_[0][tcol, kmin] if U == 1 else set_[uid[:, None], tcol, kmin])
            live = ckey < INF
            cb = torch.where(live, torch.where(hb, P32[:, None], torch.cat([b, zero1], 1).gather(1, src)), 0)
            ce = torch.where(live, torch.where(he, P32[:, None], torch.cat([e, zero1], 1).gather(1, src)), 0)
            # END: the highest-priority END thread matches; lower ones drop
            if end_ids.numel():
                ek, ei = ckey[:, end_ids].min(dim=1)
                new_m = upd & (ek < INF)
                mb = torch.where(new_m, cb[:, end_ids].gather(1, ei[:, None])[:, 0], mb)
                me = torch.where(new_m, P32 if g0 else ce[:, end_ids].gather(1, ei[:, None])[:, 0], me)
                matched = matched | new_m
                ckey = torch.where(ckey > ek[:, None], INF, ckey)
            # consume: each target takes its least-key source
            pred = self._char_pred(cur, ascii)
            fired = torch.where(pred & (ckey < INF) & upd[:, None], ckey, INF)
            nkey, ni = torch.cat([fired, inf1], 1)[:, nsrc].min(dim=2)
            src = nsrc[tcol, ni]
            alive = nkey < INF
            nb = torch.where(alive, torch.cat([cb, zero1], 1).gather(1, src), 0)
            ne = torch.where(alive, torch.cat([ce, zero1], 1).gather(1, src), 0)
            # dense re-rank: keys stay below I (injection uses I + k)
            order = torch.argsort(nkey, dim=1, stable=True)
            rank = torch.empty_like(nkey).scatter_(1, order, ar)
            nkey = torch.where(alive, rank, INF)
            u2 = upd[:, None]
            key = torch.where(u2, nkey, key)
            b = torch.where(u2, nb, b)
            e = torch.where(u2, ne, e)
            if q % _EXIT_EVERY == _EXIT_EVERY - 1 and q + 1 < steps:
                # the rows that can still change: a thread alive or a start
                # still to inject, before their end
                nxt = P + 1
                more = (nxt <= last) & (((key < INF).any(1)) | (~matched & ((ends < 0) | (nxt < ends))))
                keep = torch.nonzero(more)[:, 0]
                if keep.numel() * 2 <= n:
                    out[:, rows] = torch.stack([matched.to(torch.int32), mb, me])
                    if keep.numel() == 0:
                        break
                    rows, chars, lens, last, P0 = rows[keep], chars[keep], lens[keep], last[keep], P0[keep]
                    begins, ends, key, b, e = begins[keep], ends[keep], key[keep], b[keep], e[keep]
                    matched, mb, me = matched[keep], mb[keep], me[keep]
                    n = keep.numel()
        out[:, rows] = torch.stack([matched.to(torch.int32), mb, me])
        m = out[0] > 0
        return out[0], torch.where(m, out[1], -1), torch.where(m, out[2], -1)

    def _dfs_tables(self, group_id: int, dev):
        """run_spans' per-instruction tables on dev (cached): consuming
        (incl. END), END, OR, sets the group's begin / end, the next inst,
        the inst the high-priority branch pushes (args for OR, else next),
        and whether the single eps-edge is taken under each context,
        bool[32, I] (LBRA/RBRA always; BOL/EOL/BOW/NBOW by context)."""
        key = ("dfs", group_id, str(dev))
        if key not in self._on:
            prog = self.prog
            t, a, nx = prog.types, prog.args, prog.next_ids.astype(np.int64)
            is_or = t == OR
            edge = np.zeros((32, self.I), np.bool_)
            for ctx in range(32):
                for i in range(self.I):
                    edge[ctx, i] = t[i] in (LBRA, RBRA, BOL, EOL, BOW, NBOW) and _edge_active(t[i], a[i], ctx)
            tabs = (
                np.isin(t, (CHAR, ANY, ANYNL, CCLASS, NCCLASS, END)),
                t == END,
                is_or,
                (t == LBRA) & (a == group_id),
                (t == RBRA) & (a == group_id),
                nx,
                np.where(is_or, a, nx).astype(np.int64),
                edge,
            )
            self._on[key] = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in tabs)
        return self._on[key]

    def run_spans(self, chars, lengths, begins, ends, group_id: int, ascii: bool = False):
        """The reference's list machine (regexec.inl:204-442): (matched
        int32[N], begin int32[N], end int32[N]) as ordered_spans returns
        them, for programs of any size.

        Port of `DeviceProgram.run_spans`, which vmaps a per-row machine
        with nested while_loops; here every row runs in lockstep.  A row
        holds a list of up to I threads (inst, b, e packed into one int64:
        inst | (b + 1) << 16 | (e + 1) << 40) with its membership mask.
        Each step of a row, at its own position: inject the start insts
        while it has no match and the position is in its window; expand
        the list by the addthread DFS (an explicit stack of 3I + 4 entries
        and a visited set; each iteration pops one entry of every row
        whose stack is not empty, and the loop ends when every stack is);
        consume the char (the first END entry is the match and drops the
        entries after it; the others step to their next inst, first
        occurrence kept); the row is done at its end (char 0) or once its
        list empties after a match."""
        N, L = chars.shape
        dev = chars.device
        I = self.I
        if N == 0:
            z = torch.zeros(0, dtype=torch.int32, device=dev)
            return z, z.clone(), z.clone()
        is_cons, is_end, is_or, setb, sete, nxt, hi, edge = self._dfs_tables(group_id, dev)
        start_ids = self.prog.start_ids.tolist()
        g0 = group_id == 0
        SP = 3 * I + 4
        lens = lengths.to(torch.int64)
        pos = torch.as_tensor(begins, dtype=torch.int64, device=dev).expand(N).clone()
        eos = torch.as_tensor(ends, dtype=torch.int64, device=dev).expand(N)
        rows = torch.arange(N, device=dev)
        idx = torch.arange(I, device=dev)
        # the list: entries [N, I] and a dummy column I that masked writes go to
        lst = torch.zeros((N, I + 1), dtype=torch.int64, device=dev)
        mask = torch.zeros((N, I + 1), dtype=torch.bool, device=dev)
        size = torch.zeros(N, dtype=torch.int64, device=dev)
        match = torch.zeros(N, dtype=torch.bool, device=dev)
        mb = torch.full((N,), -1, dtype=torch.int32, device=dev)
        me = torch.full((N,), -1, dtype=torch.int32, device=dev)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        while bool((~done).any()):
            act = ~done
            c = _char_at(chars, pos, (pos >= 0) & (pos < lens))
            prev = _char_at(chars, pos - 1, (pos >= 1) & (pos - 1 < lens))
            size = torch.where(act, size, 0)
            can = act & ((eos < 0) | (pos < eos)) & ~match
            sb = (pos + 1) if g0 else torch.zeros_like(pos)
            for sid in start_ids:
                fresh = can & ~mask[:, sid]
                lst[rows, torch.where(fresh, size, I)] = sid | (sb << 16)
                mask[:, sid] |= fresh
                size = size + fresh
            out, osize = self._dfs_expand(lst, size, pos, c, prev, SP, is_cons, is_or, setb, sete, nxt, hi, edge)
            # consume
            ent = out[:, :I]
            iid = ent & 0xFFFF
            valid = idx[None, :] < osize[:, None]
            end_here = valid & is_end[iid]
            new_m = end_here.any(1)
            first_end = torch.where(new_m, end_here.to(torch.int8).argmax(1), I)
            ok = self._char_pred(c, ascii).gather(1, iid)
            prod = valid & (idx[None, :] < first_end[:, None]) & ok & ~end_here
            tgt = torch.where(prod, nxt[iid], I)
            first = torch.full((N, I + 1), I, dtype=torch.int64, device=dev)
            first.scatter_reduce_(1, tgt, idx.expand(N, I), "amin")
            keep = prod & (first.gather(1, tgt) == idx)
            slot = torch.where(keep, keep.cumsum(1) - 1, I)
            lst = torch.zeros_like(lst).scatter_(1, slot, (ent & ~0xFFFF) | tgt)
            mask = torch.zeros_like(mask).scatter_(1, torch.where(keep, tgt, I), True)
            size = keep.sum(1)
            hit = out.gather(1, first_end.clamp(max=I - 1)[:, None])[:, 0]
            mb = torch.where(new_m, (((hit >> 16) & 0xFFFFFF) - 1).to(torch.int32), mb)
            me = torch.where(new_m, (pos if g0 else (hit >> 40) - 1).to(torch.int32), me)
            match = match | new_m
            done = done | (act & ((c == 0) | ((size == 0) & match)))
            pos = pos + act
        return match.to(torch.int32), mb, me

    def _dfs_expand(self, lst, size, pos, c, prev, SP, is_cons, is_or, setb, sete, nxt, hi, edge):
        """run_spans' expand phase for every row at once: (the consuming
        and END insts in DFS order, packed as the list is, [N, I + 1] with
        a dummy column I, and their count)."""
        N, I1 = lst.shape
        I = I1 - 1
        dev = lst.device
        rows = torch.arange(N, device=dev)
        # initial stack: the list's entries reversed, so entry 0 pops first
        k = torch.arange(SP, device=dev)
        src = size[:, None] - 1 - k[None, :]
        st = torch.where(src >= 0, lst.gather(1, src.clamp(0, I)), 0)
        st = torch.cat([st, torch.zeros((N, 1), dtype=torch.int64, device=dev)], 1)
        sp = size.clone()
        visited = torch.zeros((N, I + 1), dtype=torch.bool, device=dev)
        out = torch.zeros((N, I + 1), dtype=torch.int64, device=dev)
        osize = torch.zeros(N, dtype=torch.int64, device=dev)
        ctx = self._ctx_bits(prev, c, pos == 0, False)
        step_ok = edge[ctx]  # [N, I]: each inst's eps-edge under the row's context
        p1 = (pos + 1) << 16
        if not bool((sp > 0).any()):
            return out, osize
        it = 0
        while True:
            alive = sp > 0
            v = st.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0]
            sp = sp - alive.to(torch.int64)
            iid = v & 0xFFFF
            seen = visited.gather(1, iid[:, None])[:, 0]
            fresh = alive & ~seen
            visited[rows, iid] = seen | fresh
            # the group's begin / end recorded at this position
            v = torch.where(setb[iid], (v & ~(0xFFFFFF << 16)) | p1, v)
            v = torch.where(sete[iid], (v & ((1 << 40) - 1)) | ((pos + 1) << 40), v)
            base = v & ~0xFFFF
            o = is_or[iid]
            # OR pushes next (low priority) first, the args branch last
            low = fresh & o
            st[rows, torch.where(low, sp, SP)] = base | nxt[iid]
            sp = sp + low
            high = fresh & (o | step_ok.gather(1, iid[:, None])[:, 0])
            st[rows, torch.where(high, sp, SP)] = base | hi[iid]
            sp = sp + high
            add = fresh & is_cons[iid]
            out[rows, torch.where(add, osize, I)] = v
            osize = osize + add
            it += 1
            if it % _EXIT_EVERY == 0 and not bool((sp > 0).any()):
                return out, osize

    def spans_exec(self, chars, lengths, begins, ends, group_id: int, ascii: bool = False):
        """Exact-span engine: ordered_spans for programs of at most 128
        instructions (its packed claim key needs 4*log2(I) bits), run_spans
        beyond."""
        if self.I <= 128:
            return self.ordered_spans(chars, lengths, begins, ends, group_id, ascii)
        return self.run_spans(chars, lengths, begins, ends, group_id, ascii)

    def spans_single(self, chars, lengths, start_pos, ascii: bool = False):
        """First match at or after start_pos per row: (matched bool[N],
        begin int32[N], end int32[N]), -1 where none.  K5 for certified
        programs of <= 32 instructions, the min-plus engine for other
        `longest_safe` ones, the exact engine otherwise."""
        sb = self._span_bits()
        if sb is not None:
            return sb.single(chars, lengths, start_pos, ascii)
        if self.prog.longest_safe:
            return self.nfa_spans(chars, lengths, start_pos, ascii)
        N = chars.shape[0]
        begins = torch.as_tensor(start_pos, dtype=torch.int32, device=chars.device).expand(N)
        m, b, e = self.spans_exec(chars, lengths, begins, torch.full_like(begins, -1), 0, ascii)
        return m > 0, b, e

    def all_spans(self, chars, lengths, validity, Rcap: int | None, ascii: bool = False,
                  counts_only: bool = False, groups: tuple = ()):
        """ALL non-overlapping leftmost matches per row, with the
        reference's advance rule (count.cu:178-199: begin = end if end >
        begin else begin + 1).

        Returns (counts int32[N], begins int32[N, W], ends int32[N, W]);
        match r of a row sits in column r, -1 past its count.  W is Rcap,
        or with Rcap None the most matches a row has (at least 1), or 1
        with counts_only (planes of -1).  A row stops at its first miss,
        after Rcap matches or when its begin passes its length.
        `groups`: capture-group ids; each adds a (GB, GE) pair of
        int32[N, W] planes, the group's span in each match (from
        spans_exec anchored at the match's begin, on the rows of that
        round's matches), -1/-1 where the group takes no part; they come
        as a fourth result, a list of pairs.

        A K5 program is one span_all launch for every round
        (`SpanBits.all`; its predicates come from the char tables, so
        `ascii` is a hint it does not need), after a counts-only launch
        that bounds the planes when Rcap is None.  Any other runs the JAX
        package's round loop of spans_single, each round on the rows still
        active; its planes grow by a column a round, so Rcap None costs no
        extra pass."""
        N, L = chars.shape
        dev = chars.device
        sb = self._span_bits()
        if sb is not None:
            if Rcap is None:
                Rcap = 1 if counts_only else max(int(sb.all(chars, lengths, validity, L + 2, counts_only=True)[0].max()) if N else 1, 1)
            counts, B, E = sb.all(chars, lengths, validity, Rcap, counts_only=counts_only)
            rounds = [(r, B[:, r]) for r in range(min(Rcap, int(counts.max()) if N and groups else 0))]
        else:
            counts, B, E, rounds = self._round_loop(chars, lengths, validity, Rcap, ascii, counts_only)
        if not groups:
            return counts, B, E
        planes = []
        for g in groups:
            GB = torch.full(B.shape, -1, dtype=torch.int32, device=dev)
            GE = torch.full(B.shape, -1, dtype=torch.int32, device=dev)
            for r, b in rounds:
                rows = torch.nonzero(b >= 0)[:, 0]
                if rows.numel():
                    GB[rows, r], GE[rows, r] = self._anchored(chars, lengths, rows, b[rows], g, ascii)
            planes.append((GB, GE))
        return counts, B, E, planes

    def _anchored(self, chars, lengths, rows, b, g: int, ascii: bool = False):
        """Group g's (begin, end) int32 in the match of each of `rows` that
        begins at b (spans_exec in the window [b, b + 1) on those rows),
        -1/-1 where the group takes no part."""
        sub = chars if rows.numel() == chars.shape[0] else chars[rows]
        b = b.to(torch.int32)
        mg, bg, eg = self.spans_exec(sub, lengths[rows], b, b + 1, g, ascii)
        ok = mg > 0
        return torch.where(ok, bg, -1), torch.where(ok, eg, -1)

    def _round_loop(self, chars, lengths, validity, Rcap: int | None, ascii: bool, counts_only: bool):
        """all_spans on the torch engines: (counts, B, E, [(r, begins of
        round r's matches, -1 elsewhere)]), each round's spans_single run
        on the rows still active (a row's result does not depend on the
        others); Rcap None: rounds until no row is active."""
        N, L = chars.shape
        dev = chars.device
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        begins = torch.zeros(N, dtype=torch.int32, device=dev)
        active = validity.to(torch.bool)
        lens = lengths.to(torch.int32)
        rounds, ends = [], []
        for r in range(L + 2 if Rcap is None else Rcap):
            rows = torch.nonzero(active)[:, 0]
            if rows.numel() == 0:
                break
            whole = rows.numel() == N
            m, b, e = self.spans_single(chars if whole else chars[rows], lens[rows], begins[rows], ascii)
            rows, b, e = rows[m], b[m], e[m]
            counts[rows] += 1
            rb = torch.full((N,), -1, dtype=torch.int32, device=dev)
            rb[rows] = b
            rounds.append((r, rb))
            if not counts_only:
                re_ = torch.full((N,), -1, dtype=torch.int32, device=dev)
                re_[rows] = e
                ends.append(re_)
            nb = torch.where(e > b, e, begins[rows] + 1)
            begins[rows] = nb
            active = torch.zeros(N, dtype=torch.bool, device=dev)
            active[rows] = nb <= lens[rows]
        if rounds and int((rounds[-1][1] >= 0).sum()) == 0:
            rounds.pop()  # the last round found nothing
            if ends:
                ends.pop()
        W = 1 if counts_only else (max(len(rounds), 1) if Rcap is None else Rcap)
        B = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        E = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        if not counts_only and rounds:
            B[:, : len(rounds)] = torch.stack([rb for _, rb in rounds], 1)
            E[:, : len(rounds)] = torch.stack(ends, 1)
        return counts, B, E, rounds
