// K5: every non-overlapping leftmost(-longest) match span of each row in
// one launch (span_all), for certified programs of at most 32
// instructions, one uint32 bit state per row.
//
// Replaces the TPU kernels of custrings_tpu/regex/pallas_spans.py::
// SpanBits.single, _back_kernel_factory (:251) and _fwd_end_kernel_factory
// (:266), together with the round loop around them (custrings_tpu/regex/
// device.py::DeviceProgram.all_spans, :1171), which relaunches both
// passes over every row each round.  Here one thread per row does:
//
//   back, once, p = min(len, L) .. start, carrying B = B_{p+1}:
//     t    = { i : nrows[i] & B != 0 }         insts whose successor is in B
//     t2   = (t & pred(c_p)) | END             (p <= len on this walk)
//     B    = { i : crows[uid(p)][i] & t2 != 0 }
//     bit p of the row's begin bitmap = (B & start != 0)
//   B_p ("a match can begin at p") depends on the row's suffix only, not
//   on where a round starts, so this one walk gives every round's begin:
//   b0 = the first set bit >= begin.  Then per match:
//   fwd from b0 (state = start at b0):
//     closed = OR of crows[uid(p)][i] over the state's bits
//     e0 = p  where closed & END != 0
//     state  = OR of nrows[i] over the bits of closed & pred(c_p)
//     until the state empties or the row ends
//   record (b0, e0), begin = e0 > b0 ? e0 : begin + 1 (the reference's
//   advance rule, count.cu:178-199); a row stops at its first miss, after
//   Rcap matches or once begin > len.  A row walks ~len plus the lengths
//   of its matches, where the round loop walked len - begin every round.
//
// The predicates and closure variants come from the chars, not from
// per-position planes (nfa_chars.cuh, shared with K2 and K2b): pred(c) is
// one shared-memory word for an ASCII char, memb(c) reads the program's
// 64K-entry table (L2-resident) in the rest of the BMP and the classes'
// explicit ranges above it, and uid(p) is ctx_map[ctx] of the chars at
// p - 1 and p, read only for programs with several closure variants.
// The program table is K2's (nfa_chars.cuh, regex/nfa_bits.py), the char
// tables NFABits.char_table and memb_bmp (regex/nfa_chars.py, W = 1).
//
// The begin bitmap has ceil((L + 1) / 32) words a row.  It lives in a
// word-major scratch plane [words, N] (a register array would need a
// word index known at compile time), so a warp's stores and loads of one
// word are one 128-byte line.
//
// Bound on the H100: device-memory bytes and, in practice, the serial
// chain of each thread's steps.  The chars of [0, len) are read once by
// the backward walk, the forward walks read only the match spans again
// (from L1/L2: they were just walked); per position a step walks only the
// set bits of its state through transposed tables in shared memory, and
// an ASCII char's predicate is one shared-memory word.  Each thread loads
// its row's chars in place (L1 keeps a row's 32-byte sector for its next
// positions).  A form that staged each warp's 32 rows through shared
// memory in 32 x 32 tiles by cp.async, so that the loads were coalesced,
// was slower at every shape of chip_smoke.py's span_all case on the H100,
// by about 2.5x: its 50 KB of tiles a block left 16 warps an SM, and all
// its lanes waited for the warp's longest row (PERF.md has both times).

#include <cstdint>
#include <cuda_runtime.h>

#include "nfa_chars.cuh"

namespace {

using namespace nfa_chars;

constexpr int THREADS = 128;
constexpr int HEAD = head_words(1);

// the offset of the closure variant at position p in the [U, I] tables,
// from the chars at p - 1 and p (each 0 outside the row)
__device__ __forceinline__ int closure_at(const Prog& g, const Chars<1>& t,
                                          int64_t p, int32_t prev,
                                          int32_t cur) {
  if (g.U == 1) return 0;
  return variant(t, p == 0, prev, cur, alnum_of(t, prev), alnum_of(t, cur)) * g.I;
}

// one backward step at p <= len: B_{p+1} -> B_p; cur is the char at p
// (0 at p == len), prev the char at p - 1 (0 at p == 0); trans holds the
// transposed closure rows [U*I], then the transposed next rows [I] (bit i
// of row k is bit k of crows[i] / nrows[i])
__device__ __forceinline__ uint32_t back_step(const Prog& g, const Chars<1>& t,
                                              const uint32_t* trans,
                                              uint32_t B, int64_t p,
                                              int32_t prev, int32_t cur) {
  // both steps walk the set bits only, through the transposed rows:
  // { i : rows[i] & x != 0 } = OR of rows_t[k] over the bits k of x
  uint32_t t2 = g.end_bits;
  if (B != 0u && cur != 0) {
    const uint32_t* nrows_t = trans + g.U * g.I;
    uint32_t tt = 0;
    for (uint32_t b = B; b != 0u; b &= b - 1) tt |= nrows_t[__ffs(b) - 1];
    t2 |= tt & pred_bits(g, t, cur);
  }
  const uint32_t* ct = trans + closure_at(g, t, p, prev, cur);
  uint32_t nb = 0;
  for (uint32_t b = t2; b != 0u; b &= b - 1) nb |= ct[__ffs(b) - 1];
  return nb;
}

// the last END fired after injecting the start state at b0 (0 <= b0 <= L),
// or -1; chars read in place
__device__ int32_t fwd_end(const Prog& g, const Chars<1>& t,
                           const int32_t* __restrict__ crow, int64_t len,
                           int64_t L, int64_t b0) {
  int32_t e0 = -1;
  uint32_t state = g.start_bits;
  int32_t prev = (b0 > 0 && b0 - 1 < len) ? crow[b0 - 1] : 0;
  for (int64_t p = b0; p <= L; ++p) {
    // the char at p for the anchors (0 past the matrix), and for the
    // predicate (the last column's past the matrix, as the plain version)
    const int32_t at = (p < len && p < L) ? crow[p] : 0;
    const int32_t cur = p < len ? (p < L ? at : crow[L - 1]) : 0;
    const uint32_t* cr = g.crows + closure_at(g, t, p, prev, at);
    uint32_t closed = 0;
    for (uint32_t b = state; b != 0u; b &= b - 1) closed |= cr[__ffs(b) - 1];
    if (closed & g.end_bits) e0 = (int32_t)p;
    if (cur == 0) break;  // no char: the next state is empty
    const uint32_t fire = closed & pred_bits(g, t, cur);
    uint32_t next = 0;
    for (uint32_t b = fire; b != 0u; b &= b - 1) next |= g.nrows[__ffs(b) - 1];
    state = next;
    if (state == 0u) break;  // no injection after b0: nothing fires again
    prev = at;
  }
  return e0;
}

struct Args {
  const int32_t* chars;
  int64_t L;
  const int32_t* lengths;
  const uint8_t* validity;
  const int32_t* start_pos;
  const int32_t* prog;
  int prog_len;
  const int32_t* ctab;
  const uint32_t* bmp;
  int64_t N;
  int Rcap, W, counts_only;
  int32_t* counts;
  int32_t* B;
  int32_t* E;
  uint32_t* scratch;  // [words, N]
};

__global__ void __launch_bounds__(THREADS) span_all(const Args a) {
  __shared__ uint32_t tab[MAX_PROG];
  __shared__ uint32_t head[HEAD];
  __shared__ uint32_t trans[MAX_U * MAX_I + MAX_I];
  for (int i = threadIdx.x; i < a.prog_len; i += THREADS) tab[i] = (uint32_t)a.prog[i];
  for (int i = threadIdx.x; i < HEAD; i += THREADS) head[i] = (uint32_t)a.ctab[i];
  __syncthreads();
  const Prog g = load_prog(tab);
  const Chars<1> t{head, a.bmp, a.ctab};
  // the transposed closure and next rows
  for (int e = threadIdx.x; e < (g.U + 1) * g.I; e += THREADS) {
    const uint32_t* src = e < g.U * g.I ? g.crows + (e / g.I) * g.I : g.nrows;
    const int k = e % g.I;
    uint32_t v = 0;
    for (int i = 0; i < g.I; ++i) v |= ((src[i] >> k) & 1u) << i;
    trans[e] = v;
  }
  __syncthreads();

  const int64_t N = a.N, L = a.L;
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  const int64_t len = a.lengths[row];
  const int64_t w = a.start_pos[row] > 0 ? a.start_pos[row] : 0;
  const int64_t hi = len < L ? len : L;
  const int32_t* crow = a.chars + row * L;
  int cnt = 0;
  if (a.validity[row] != 0 && w <= hi) {
    // the backward walk over [w, hi]: the begin bitmap
    uint32_t B = 0, word = 0;
    int32_t cur = 0;  // the char at hi: hi == len, or hi == L past the matrix
    for (int64_t p = hi; p >= w; --p) {
      const int32_t prev = p > 0 ? crow[p - 1] : 0;
      B = back_step(g, t, trans, B, p, prev, cur);
      if (B & g.start_bits) word |= 1u << (p & 31);
      if ((p & 31) == 0 || p == w) {
        a.scratch[(p >> 5) * N + row] = word;
        word = 0;
      }
      cur = prev;
    }
    // the matches: next begin bit, forward walk, advance
    int64_t begin = w;
    const int64_t wlast = hi >> 5;
    while (cnt < a.Rcap && begin <= hi) {
      int64_t wi = begin >> 5;
      uint32_t bits = a.scratch[wi * N + row] & (~0u << (begin & 31));
      int64_t b0 = -1;
      for (;;) {
        if (bits != 0u) {
          b0 = wi * 32 + __ffs(bits) - 1;
          break;
        }
        if (++wi > wlast) break;
        bits = a.scratch[wi * N + row];
      }
      if (b0 < 0) break;
      const int32_t e0 = fwd_end(g, t, crow, len, L, b0);
      if (e0 < 0) break;
      if (!a.counts_only) {
        a.B[row * a.W + cnt] = (int32_t)b0;
        a.E[row * a.W + cnt] = e0;
      }
      ++cnt;
      begin = e0 > b0 ? (int64_t)e0 : begin + 1;
      if (begin > len) break;
    }
  }
  a.counts[row] = cnt;
  for (int r = a.counts_only ? 0 : cnt; r < a.W; ++r) {
    a.B[row * a.W + r] = -1;
    a.E[row * a.W + r] = -1;
  }
}

}  // namespace

extern "C" {

// chars: int32 [N, L] row-major; lengths, start_pos: int32 [N]; validity:
// uint8 [N]; prog: int32 table of prog_len entries and ctab: int32 char
// table of ctab_len entries (layouts in nfa_chars.cuh); bmp: uint32
// [65536 + 2048];
// counts: int32 [N]; B, E: int32 [N, W] (W = 1 with counts_only, else
// Rcap), -1 past a row's count (all -1 with counts_only); scratch: uint32
// [(L + 32) / 32, N].
int cs_span_all(const void* chars, int64_t L, const void* lengths,
                const void* validity, const void* start_pos, const void* prog,
                int prog_len, const void* ctab, int ctab_len, const void* bmp,
                int64_t N, int Rcap, int counts_only, void* counts, void* B,
                void* E, void* scratch, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (prog_len > MAX_PROG || ctab_len < HEAD + 3 || L <= 0 || Rcap < 0 ||
      (L + 32) / 32 > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const int32_t*)chars, L, (const int32_t*)lengths,
         (const uint8_t*)validity, (const int32_t*)start_pos,
         (const int32_t*)prog, prog_len, (const int32_t*)ctab,
         (const uint32_t*)bmp, N, Rcap, counts_only ? 1 : Rcap,
         counts_only, (int32_t*)counts, (int32_t*)B, (int32_t*)E,
         (uint32_t*)scratch};
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  span_all<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
