// K2: lockstep boolean NFA with one uint32 state per row (programs of at
// most 32 instructions), for contains_re / match_re.
//
// Replaces the TPU kernel custrings_tpu/regex/pallas_nfa.py::
// PallasNFA._matches_bits (body _bit_kernel_factory) and the per-position
// planes built in front of it (pallas_nfa.py:255: the class bits of every
// char, the closure variant of every position).  The step per
// position p = 0..min(len, L) is the TPU kernel's:
//   1. start injection: at p == 0 only when anchored, otherwise at every
//      p <= len (a row leaves the loop at its first match);
//   2. eps-closure: OR of crows[variant][i] over the set state bits i;
//   3. matched |= (closed & end_bits) != 0;
//   4. predicate pred(c_p) (0 at c == 0, so the EOS slot consumes nothing);
//   5. transition: OR of nrows[i] over the fired bits i of closed & pred.
// Both walks visit only the set bits (__ffs).  The predicate and the
// closure variant are computed from the chars at p - 1 and p through the
// program's char tables (nfa_chars.cuh): an ASCII char's predicate is one
// shared-memory word, and the variant (programs with several only) comes
// from the two chars' context bits, the previous char's alnum flag carried
// over from the last step.  The TPU bakes the program tables into the
// kernel as Python ints; here they arrive as one small int32 array per
// program (K2's table, nfa_chars.cuh) and sit in shared memory with the
// char table's head.
//
// Bound on the H100: device-memory bytes and load latency.  The kernel
// reads 4 bytes of chars a position and the row's length, writes one byte
// a row; a step is a few shared-memory lookups and ~4 integer ops a live
// state bit, far below the card's op rate per byte.  Each thread's
// positions form a serial chain.  One thread per row reads its row of the
// row-major char matrix in place: a warp's step touches one 32-byte sector
// per row and the row's next positions find it in L1 (1.41 ms row-major
// against 1.50 ms on position-major copies at 1M rows x 320, whose
// transposes cost 11.3 ms a plane; NVIDIA H100 80GB HBM3, 700 W).  Four
// chars a 16-byte load in place of four 4-byte loads was a wash on the
// H100 (K2 -2% to +9%, K2b -11% to +18% by program; PERF.md), so the
// loads stay 4-byte.  A row stops at p = min(len, L), at its first match,
// and, anchored, once its state is empty (no later injection can revive
// it).

#include <cstdint>
#include <cuda_runtime.h>

#include "nfa_chars.cuh"

namespace {

using namespace nfa_chars;

constexpr int THREADS = 256;
constexpr int HEAD = head_words(1);

__global__ void __launch_bounds__(THREADS)
nfa_bits(const int32_t* __restrict__ chars, const int32_t* __restrict__ lengths,
         const int32_t* __restrict__ prog, int prog_len,
         const int32_t* __restrict__ ctab, const uint32_t* __restrict__ bmp,
         int64_t N, int64_t L, int anchored, uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[MAX_PROG];
  __shared__ uint32_t head[HEAD];
  for (int i = threadIdx.x; i < prog_len; i += THREADS) tab[i] = (uint32_t)prog[i];
  for (int i = threadIdx.x; i < HEAD; i += THREADS) head[i] = (uint32_t)ctab[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  const Prog g = load_prog(tab);
  const Chars<1> t{head, bmp, ctab};

  const int64_t len = lengths[row];
  const int64_t last = len < L ? len : L;
  const int32_t* crow = chars + row * L;
  uint32_t state = 0;
  bool matched = false, al_prev = false;
  int32_t prev = 0;
  for (int64_t p = 0; p <= last; ++p) {
    // the char at p, 0 at the EOS slot (p == len) and past the matrix
    const int32_t cur = p < last ? crow[p] : 0;
    if (!anchored || p == 0) state |= g.start_bits;
    const uint32_t* cr = g.crows;
    if (g.U > 1) {
      const bool al = alnum_of(t, cur);
      cr += variant(t, p == 0, prev, cur, al_prev, al) * g.I;
      al_prev = al;
    }
    uint32_t closed = 0;
    for (uint32_t b = state; b != 0u; b &= b - 1) closed |= cr[__ffs(b) - 1];
    if (closed & g.end_bits) {  // matched only ORs: the result is final
      matched = true;
      break;
    }
    uint32_t next = 0;
    if (cur != 0) {  // the sentinel (or a NUL char) consumes nothing
      for (uint32_t b = closed & pred_bits(g, t, cur); b != 0u; b &= b - 1) {
        next |= g.nrows[__ffs(b) - 1];
      }
    }
    state = next;
    if (anchored && state == 0u) break;  // no injection after p = 0
    prev = cur;
  }
  out[row] = matched ? 1 : 0;
}

}  // namespace

extern "C" {

// chars: int32 [N, L] row-major; lengths: int32 [N]; prog: int32 table of
// prog_len entries and ctab: int32 char table of ctab_len entries (layouts
// in nfa_chars.cuh); bmp: uint32 [65536 + 2048]; out: uint8 [N] (0/1).
int cs_nfa_bits(const void* chars, const void* lengths, const void* prog,
                int prog_len, const void* ctab, int ctab_len, const void* bmp,
                int64_t N, int64_t L, int anchored, void* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (prog_len > MAX_PROG || prog_len < HDR || ctab_len < HEAD + 3 || L <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  nfa_bits<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)chars, (const int32_t*)lengths, (const int32_t*)prog,
      prog_len, (const int32_t*)ctab, (const uint32_t*)bmp, N, L, anchored,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
