"""K5: bit-parallel match spans (certified programs of <= 32 insts).

Port of `custrings_tpu/regex/pallas_spans.py` (`SpanBits.single` with
the TPU kernels `_back_kernel_factory` and `_fwd_end_kernel_factory`, and
`span_bits_ok`) together with the round loop of the JAX package's
`DeviceProgram.all_spans`.  Span extraction runs the boolean matcher's
bit state over K2's tables (`nfa_bits.NFABits`):

    back   B_p = "injecting the start state at p reaches END in the
           suffix", by the reversed recurrence, once per row; its set
           bits at or after a round's begin are that round's candidates
    fwd    inject only at the round's first candidate b0; the last END
           fired is the match's end

B_p does not depend on where a round starts, so one backward walk serves
every match of a row.  The last-fire end equals the reference's priority
semantics exactly for programs the compiler certifies `longest_safe` or
`end_unique`.  The CUDA kernel is `csrc/spans.cu` (`span_all`: one thread
per row, the whole match loop in one launch, the predicates computed from
the chars with `NFABits.char_table` / `memb_bmp`); the plain version
`_all_plain` runs the same steps over all rows at once, one Python
iteration per position, from the same tables, and is what a CPU tensor
takes.
"""

from __future__ import annotations

import torch

from .. import kernels
from .nfa_bits import NFABits


def span_bits_ok(prog) -> bool:
    """Program classes whose priority end == last-fire end."""
    return bool(prog.longest_safe or prog.end_unique)


class SpanBits:
    """The span passes over one program's bit tables."""

    def __init__(self, nfa: NFABits):
        if not span_bits_ok(nfa.dp.prog):
            raise ValueError("span passes need a longest_safe or end_unique program")
        self.nfa = nfa

    def single(self, chars, lengths, start_pos, ascii: bool = False):
        """Leftmost(-longest) first-match spans at or after start_pos:
        (matched bool[N], begin int32[N], end int32[N]), -1 where none.
        `ascii` is a hint the passes do not need."""
        N = chars.shape[0]
        valid = torch.ones(N, dtype=torch.bool, device=chars.device)
        counts, B, E = self.all(chars, lengths, valid, 1, start_pos=start_pos)
        return counts > 0, B[:, 0], E[:, 0]

    def all(self, chars, lengths, validity, Rcap: int, start_pos=0, counts_only: bool = False):
        """All non-overlapping leftmost matches of each row from start_pos:
        (counts int32[N], B int32[N, W], E int32[N, W]) with W = 1 if
        counts_only else Rcap, match r of a row in column r and -1 past its
        count (all -1 with counts_only).  After a match (b, e) the next
        begin is e if e > b else begin + 1 (count.cu:178-199); a row stops
        at its first miss, after Rcap matches or once its begin passes its
        length; invalid rows count 0."""
        N, L = chars.shape
        dev = chars.device
        start = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).expand(N).contiguous()
        W = 1 if counts_only else Rcap
        if N == 0:
            z = torch.zeros((0, W), dtype=torch.int32, device=dev)
            return torch.zeros(0, dtype=torch.int32, device=dev), z, z.clone()
        if not chars.is_cuda:
            return self._all_plain(chars, lengths, validity, Rcap, start, counts_only)
        return self._launch(chars, lengths, validity, Rcap, start, counts_only)

    # -- the kernel ------------------------------------------------------

    def _launch(self, chars, lengths, validity, Rcap, start, counts_only):
        N, L = chars.shape
        if L == 0:
            raise ValueError("span_all: the char matrix has no columns")
        chars = chars.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        valid = validity.to(torch.bool).contiguous().view(torch.uint8)
        if lens.shape != (N,) or valid.shape != (N,):
            raise ValueError("span_all: lengths or validity do not fit the char matrix")
        nfa = self.nfa
        dev = chars.device
        table = nfa.on("table", dev)
        ctab = nfa.on("char_table", dev)
        bmp = nfa.on("memb_bmp", dev)
        for t in (chars, lens, valid, start, table, ctab, bmp):
            kernels.require_cuda(t, "span_all")
        W = 1 if counts_only else Rcap
        counts = torch.empty(N, dtype=torch.int32, device=dev)
        B = torch.empty((N, W), dtype=torch.int32, device=dev)
        E = torch.empty((N, W), dtype=torch.int32, device=dev)
        scratch = torch.empty(((L + 32) // 32, N), dtype=torch.int32, device=dev)
        with kernels.launched("span_all"):
            err = kernels.lib().cs_span_all(
                chars.data_ptr(), L, lens.data_ptr(), valid.data_ptr(), start.data_ptr(),
                table.data_ptr(), table.shape[0], ctab.data_ptr(), ctab.shape[0], bmp.data_ptr(),
                N, Rcap, int(counts_only), counts.data_ptr(), B.data_ptr(),
                E.data_ptr(), scratch.data_ptr(), kernels.stream_ptr(chars),
            )
            kernels.check(err, "span_all")
        return counts, B, E

    # -- the plain versions ----------------------------------------------

    def _all_plain(self, chars, lengths, validity, Rcap, start, counts_only):
        """`all` on tensors, all rows at once: the predicates and closure
        variants of every position from the kernel's char tables, one
        backward pass for the begin bitmap, then per round the next
        candidate (torch ops) and `_fwd_plain` from it."""
        N, L = chars.shape
        dev = chars.device
        lens = lengths.to(torch.int64)
        begin = start.to(torch.int64).clamp(min=0)
        W = 1 if counts_only else Rcap
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        B = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        E = torch.full((N, W), -1, dtype=torch.int32, device=dev)
        active = validity.to(torch.bool) & (begin <= lens.clamp(max=L))
        uid = self.nfa._uid_plane(chars, lens)
        bits = self._back_plain(chars, lens, begin, active, uid)
        pos = torch.arange(L + 1, dtype=torch.int64, device=dev)
        r = 0
        while r < Rcap and bool(active.any()):
            cand = bits & (pos[None, :] >= begin[:, None])
            b0 = torch.where(active & cand.any(dim=1), cand.to(torch.int8).argmax(dim=1), -1)
            e0 = self._fwd_plain(chars, lens, b0, uid).to(torch.int64)
            hit = (b0 >= 0) & (e0 >= 0)
            counts += hit.to(torch.int32)
            if not counts_only:
                B[:, r] = torch.where(hit, b0, -1).to(torch.int32)
                E[:, r] = torch.where(hit, e0, -1).to(torch.int32)
            begin = torch.where(hit, torch.where(e0 > b0, e0, begin + 1), begin)
            active = hit & (begin <= lens)
            r += 1
        return counts, B, E

    def _back_plain(self, chars, lens, start, work, uid):
        """bool[N, L+1]: the begin bitmap, bit p set where B_p & start != 0
        for start[row] <= p <= min(len, L) on the rows of `work` (int64
        states, 32 bits used; uid as `_all_plain` builds it),
        one iteration per position p = L..0.
        Positions past every row's length (B stays 0 there) and below
        every start are skipped, as the kernel's per-row bounds do."""
        nfa = self.nfa
        N, L = chars.shape
        dev = chars.device
        bits = torch.zeros((N, L + 1), dtype=torch.bool, device=dev)
        if not bool(work.any()):
            return bits
        B = torch.zeros(N, dtype=torch.int64, device=dev)
        hi = min(L, int(lens[work].max()))
        lo = int(start[work].min())
        for p in range(hi, lo - 1, -1):
            cur = torch.where((p < lens) & (p < L), chars[:, min(p, L - 1)].to(torch.int64), 0)
            t = torch.zeros_like(B)
            for i, nr in enumerate(nfa.nrows):
                if nr:
                    t |= ((B & nr) != 0).to(torch.int64) << i
            end_ok = torch.where(p <= lens, nfa.end_bits, 0)
            t2 = (t & nfa._pred_plain(cur)[:, 0]) | end_ok
            rows = nfa._closure_rows(uid, p, N, dev)
            B = torch.zeros_like(B)
            for i in range(nfa.I):
                B |= ((t2 & rows[:, i]) != 0).to(torch.int64) << i
            bits[:, p] = ((B & nfa.start_bits) != 0) & (p <= lens) & (p >= start) & work
        return bits

    def _fwd_plain(self, chars, lengths, begins, uid):
        """int32[N]: the last END fired after injecting the start state at
        p == begins[row] (none where begins is -1), or -1; all rows at
        once, one iteration per position from the first injection until
        every state is empty after the last one."""
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
            state = nfa._or_rows(closed & nfa._pred_plain(cur)[:, 0], nfa.nrows)
        return e0.to(torch.int32)
