"""K2b: the multi-word bit NFA matcher (programs of up to 256 insts).

Port of `custrings_tpu/regex/pallas_nfa.py`: `pallas_supported` (the
instruction cap and the table budget) and `_matches_f32`.  On the TPU the
state is a dense f32 vector of the padded instruction count and each step
is two MXU products (`closed = state @ closure[uid]`, `state' = (closed *
pred) @ next`) over per-position planes built in front of the kernel
(`custrings_tpu/regex/pallas_nfa.py:255`: W32 membership planes and the
closure variant of every position).  Here, as in K2, the state is a
bitset: W32 = ceil(I/32) 32-bit words per row.  The CUDA kernel is `csrc/nfa_words.cu`
(one thread per row, the words in registers, the program table and the
char tables' head in shared memory); it computes each position's
predicate and closure variant from the chars through the program's char
tables (`nfa_chars.CharTables`, W32 words a char), so it reads only the
char matrix, the lengths and the tables.  The plain version below runs
the same walk over all rows at once, one Python iteration per position,
on W32 int64 words per row holding 32 bits each, from the same tables,
and is what a CPU tensor takes.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..column import i32_bits
from .nfa_chars import CharTables, words

MAX_INSTS = 256
LANE = 128
#: the TPU's VMEM budget for the dense closure tables; kept as the routing
#: rule so that the port sends every program to the JAX package's engine
TABLE_BUDGET = 6 * 1024 * 1024


def pallas_supported(dp) -> bool:
    """Can this program run on K2b (the dense matcher's instruction cap
    and table budget)?"""
    if dp.I > MAX_INSTS:
        return False
    PI = -(-max(dp.I, 1) // LANE) * LANE
    U = int(dp.closure_unique.shape[0])
    return U * PI * PI * 4 <= TABLE_BUDGET


class NFAWords(CharTables):
    """Multi-word bit tables of one DeviceProgram, and its matcher."""

    def __init__(self, dp):
        if not pallas_supported(dp):
            raise ValueError(
                f"program has {dp.I} instructions or too many closure variants "
                "for K2b; the vector engine takes it"
            )
        I = self.I = dp.I
        super().__init__(dp, -(-I // 32))
        W = self.W32
        cu = dp.closure_unique.numpy()
        self.U = cu.shape[0]
        crows = words(cu, W)  # [U][I][W]
        nrows = words(dp.next_mat.numpy(), W)  # [I][W]
        start_w = words(dp.start_vec.numpy(), W)
        end_w = words(dp.is_end.numpy(), W)
        # the kernel's table (csrc/nfa_words.cu); an ASCII char's predicate
        # is char_table's pred_a, so only the CHAR pairs of chars >= 128 go in
        pairs = [(i, a) for i, a in self.char_pairs if a >= 128]
        table = [self.U, I, W, len(pairs)]
        table += [v for u in crows for row in u for v in row]
        table += [v for row in nrows for v in row]
        table += start_w + end_w + self.any_w + self.anynl_w
        table += [v for pair in pairs for v in pair]
        # host tables, copied to a device once by on(): the kernel's table
        # and the plain walk's rows as int64 words of 32 bits
        self.table = torch.tensor([i32_bits(v) for v in table], dtype=torch.int32)
        self.crows = torch.tensor(crows, dtype=torch.int64)
        self.nrows = torch.tensor(nrows, dtype=torch.int64)
        self.start_w = torch.tensor(start_w, dtype=torch.int64)
        self.end_w = torch.tensor(end_w, dtype=torch.int64)
        #: the insts with a next row (the consuming ones)
        self.consumers = [i for i in range(I) if any(nrows[i])]

    def matches(self, chars, lengths, anchored: bool):
        """bool[N]: does the program match row r (anchored: at 0)?

        chars int32[N, L] codepoints 0-padded; lengths int32[N].  The
        kernel reads the full char tables, so it is exact on every char
        and needs no ASCII pass."""
        N, L = chars.shape
        if N == 0:
            return torch.zeros(0, dtype=torch.bool, device=chars.device)
        return self._matches_words(chars, lengths, anchored)

    def _matches_words(self, chars, lengths, anchored: bool):
        if not chars.is_cuda:
            return self._matches_plain(chars, lengths, anchored)
        N, L = chars.shape
        if L == 0:
            raise ValueError("nfa_words: the char matrix has no columns")
        # the kernel reads the row-major char matrix in place (nfa_words.cu)
        chars = chars.to(torch.int32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        if lens.shape != (N,):
            raise ValueError("nfa_words: lengths do not fit the char matrix")
        dev = chars.device
        table, ctab, bmp = (self.on(k, dev) for k in ("table", "char_table", "memb_bmp"))
        for t in (chars, lens, table, ctab, bmp):
            kernels.require_cuda(t, "nfa_words")
        out = torch.empty(N, dtype=torch.uint8, device=dev)
        with kernels.launched("nfa_words"):
            err = kernels.lib().cs_nfa_words(
                chars.data_ptr(), lens.data_ptr(), table.data_ptr(), table.shape[0],
                ctab.data_ptr(), ctab.shape[0], bmp.data_ptr(), N, L, self.W32,
                1 if anchored else 0, out.data_ptr(), kernels.stream_ptr(chars),
            )
            kernels.check(err, "nfa_words")
        return out.bool()

    def _matches_plain(self, chars, lengths, anchored: bool):
        """The kernel's walk over all rows at once: W32 int64 words of 32
        bits per row, one iteration per position p = 0..L, the predicates
        and closure variants read from the char tables."""
        N, L = chars.shape
        dev = chars.device
        W = self.W32
        lens = lengths.to(torch.int64)
        uid = self._uid_plane(chars, lens)
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
            uidp = uid[:, p] if uid is not None else None
            closed = torch.zeros_like(state)
            for i in range(self.I):
                row = crows[:, i][uidp] if uidp is not None else crows[0, i]
                closed |= torch.where(sbits[:, i >> 5, i & 31, None], row, 0)
            matched |= ((closed & end) != 0).any(dim=1)
            fire = closed & self._pred_plain(cur)
            fbits = ((fire[:, :, None] >> shifts) & 1).bool()
            nxt = torch.zeros_like(state)
            for i in self.consumers:
                nxt |= torch.where(fbits[:, i >> 5, i & 31, None], nrows[i], 0)
            state = nxt
        return matched
