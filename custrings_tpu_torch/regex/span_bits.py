"""K5: bit-parallel first-match spans (certified programs of <= 32 insts).

Port of `custrings_tpu/regex/pallas_spans.py` (`SpanBits.single` with
the TPU kernels `_back_kernel_factory` and `_fwd_end_kernel_factory`, and
`span_bits_ok`).  Span extraction is two passes of the boolean matcher's
bit state over K2's tables (`nfa_bits.NFABits`):

    back   B_p = "injecting the start state at p reaches END in the
           suffix", by the reversed recurrence; the leftmost p >= start_pos
           with start & B_p != 0 is the match's begin b0
    fwd    inject only at b0; the last END fired is the match's end

The last-fire end equals the reference's priority semantics exactly for
programs the compiler certifies `longest_safe` or `end_unique`.  The CUDA
kernels are `csrc/spans.cu` (one thread per row, one uint32 state, the
row-major planes read in place); the plain versions below run the same
steps over all rows at once, one Python iteration per position, and are
what a CPU tensor takes.  The per-position planes (`membw`, `uid`) are
K2's, built by `NFABits._pos_tables`; a caller running several passes over
one char matrix (`DeviceProgram.all_spans`) builds them once.
"""

from __future__ import annotations

import torch

from .. import kernels
from .nfa_bits import NFABits


def span_bits_ok(prog) -> bool:
    """Program classes whose priority end == last-fire end."""
    return bool(prog.longest_safe or prog.end_unique)


class SpanBits:
    """The two span passes over one program's bit tables."""

    def __init__(self, nfa: NFABits):
        if not span_bits_ok(nfa.dp.prog):
            raise ValueError("span passes need a longest_safe or end_unique program")
        self.nfa = nfa

    def tables(self, chars, lengths, ascii: bool = False):
        """(membw int32[N, L], uid int32[N, L+1] or None): K2's planes."""
        return self.nfa._pos_tables(chars, lengths, ascii)

    def single(self, chars, lengths, start_pos, ascii: bool = False):
        """Leftmost(-longest) first-match spans at or after start_pos:
        (matched bool[N], begin int32[N], end int32[N]), -1 where none."""
        N = chars.shape[0]
        start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=chars.device)
        start_pos = start_pos.expand(N).contiguous()
        if N == 0:
            z = torch.zeros(0, dtype=torch.int32, device=chars.device)
            return torch.zeros(0, dtype=torch.bool, device=chars.device), z, z
        membw, uid = self.tables(chars, lengths, ascii)
        return self.spans(chars, lengths, start_pos, membw, uid)

    def spans(self, chars, lengths, start_pos, membw, uid):
        """`single` on planes the caller already built."""
        b = self.back(chars, lengths, start_pos, membw, uid)
        e = self.fwd(chars, lengths, b, membw, uid)
        matched = (b >= 0) & (e >= 0)
        neg = torch.full_like(b, -1)
        return matched, torch.where(matched, b, neg), torch.where(matched, e, neg)

    # -- the kernels ---------------------------------------------------

    def back(self, chars, lengths, start_pos, membw, uid):
        """int32[N]: the leftmost match begin at or after start_pos, or -1."""
        if not chars.is_cuda:
            return self._back_plain(chars, lengths, start_pos, membw, uid)
        return self._launch("cs_span_back", "span_back", chars, lengths, start_pos, membw, uid)

    def fwd(self, chars, lengths, begins, membw, uid):
        """int32[N]: the last END fired after injecting at `begins`, or -1."""
        if not chars.is_cuda:
            return self._fwd_plain(chars, lengths, begins, membw, uid)
        return self._launch("cs_span_fwd", "span_fwd", chars, lengths, begins, membw, uid)

    def _launch(self, fn, counter, chars, lengths, rowarg, membw, uid):
        N, L = chars.shape
        if L == 0:
            raise ValueError(f"{counter}: the char matrix has no columns")
        # the kernels read the row-major planes in place (see spans.cu)
        chars = chars.to(torch.int32).contiguous()
        membw = membw.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        rowarg = rowarg.to(torch.int32).contiguous()
        if membw.shape != (N, L) or lens.shape != (N,) or rowarg.shape != (N,):
            raise ValueError(f"{counter}: membw, lengths or the row argument do not fit the char matrix")
        nfa = self.nfa
        table = nfa._table_on(chars.device)
        planes = [chars, membw, lens, rowarg, table]
        if nfa.U > 1:  # the kernels read uid only with several variants
            uid = uid.to(torch.int32).contiguous()
            if uid.shape != (N, L + 1):
                raise ValueError(f"{counter}: uid does not fit the char matrix")
            planes.append(uid)
        for t in planes:
            kernels.require_cuda(t, counter)
        out = torch.empty(N, dtype=torch.int32, device=chars.device)
        err = getattr(kernels.lib(), fn)(
            chars.data_ptr(), membw.data_ptr(), L, 1,
            uid.data_ptr() if nfa.U > 1 else 0, L + 1, 1,
            lens.data_ptr(), rowarg.data_ptr(), table.data_ptr(), table.shape[0], N, L,
            out.data_ptr(), kernels.stream_ptr(chars),
        )
        kernels.check(err, counter)
        kernels.LAUNCHES[counter] += 1
        return out

    # -- the plain versions --------------------------------------------

    def _back_plain(self, chars, lengths, start_pos, membw, uid):
        """The backward pass over all rows at once (int64 states, 32 bits
        used), one iteration per position p = L..0.  Positions past every
        row's length (B stays 0 there) and below every start (b0 cannot
        move there) are skipped, as the kernel's per-row bounds do."""
        nfa = self.nfa
        N, L = chars.shape
        dev = chars.device
        lens = lengths.to(torch.int64)
        w = start_pos.to(torch.int64)
        B = torch.zeros(N, dtype=torch.int64, device=dev)
        b0 = torch.full((N,), -1, dtype=torch.int64, device=dev)
        work = w <= lens
        if not bool(work.any()):
            return b0.to(torch.int32)
        hi = min(L, int(lens[work].max()))
        lo = max(0, int(w[work].min()))
        for p in range(hi, lo - 1, -1):
            pc = min(p, L - 1)
            cur = torch.where(p < lens, chars[:, pc].to(torch.int64), 0)
            t = torch.zeros_like(B)
            for i, nr in enumerate(nfa.nrows):
                if nr:
                    t |= ((B & nr) != 0).to(torch.int64) << i
            end_ok = torch.where(p <= lens, nfa.end_bits, 0)
            t2 = (t & nfa._pred_plain(cur, membw[:, pc])) | end_ok
            rows = nfa._closure_rows(uid, p, N, dev)
            B = torch.zeros_like(B)
            for i in range(nfa.I):
                B |= ((t2 & rows[:, i]) != 0).to(torch.int64) << i
            sbit = ((B & nfa.start_bits) != 0) & (p <= lens) & (p >= w)
            b0 = torch.where(sbit, p, b0)
        return b0.to(torch.int32)

    def _fwd_plain(self, chars, lengths, begins, membw, uid):
        """The forward pass over all rows at once, injecting only at
        p == begins[row], one iteration per position from the first
        injection until every state is empty after the last one."""
        nfa = self.nfa
        N, L = chars.shape
        dev = chars.device
        lens = lengths.to(torch.int64)
        b0 = begins.to(torch.int64)
        state = torch.zeros(N, dtype=torch.int64, device=dev)
        e0 = torch.full((N,), -1, dtype=torch.int64, device=dev)
        inj = (b0 >= 0) & (b0 <= L)
        if not bool(inj.any()):
            return e0.to(torch.int32)
        last_inj = int(b0[inj].max())
        for p in range(int(b0[inj].min()), L + 1):
            if p > last_inj and not bool(state.any()):
                break
            pc = min(p, L - 1)
            cur = torch.where(p < lens, chars[:, pc].to(torch.int64), 0)
            state = torch.where(b0 == p, state | nfa.start_bits, state)
            closed = nfa._or_rows(state, nfa._closure_rows(uid, p, N, dev))
            e0 = torch.where((closed & nfa.end_bits) != 0, p, e0)
            state = nfa._or_rows(closed & nfa._pred_plain(cur, membw[:, pc]), nfa.nrows)
        return e0.to(torch.int32)
