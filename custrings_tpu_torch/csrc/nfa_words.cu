// K2b: lockstep boolean NFA with a multi-word bitset state per row
// (programs of up to 256 instructions), for contains_re / match_re.
//
// Replaces the TPU kernel custrings_tpu/regex/pallas_nfa.py::
// PallasNFA._matches_f32 (body _kernel_factory) and the per-position
// planes built in front of it (pallas_nfa.py:255: W32 membership planes,
// the closure variant of every position).  The TPU holds the state
// as a dense f32 vector of the instruction count padded to 128 or 256
// lanes and pays two MXU products per position over every lane:
//   closed = state @ closure[uid]        state' = (closed * pred) @ next.
// Here the state is W = ceil(I/32) <= 8 uint32 words in registers, and the
// step per position p = 0..min(len, L) is the same automaton as K2
// (nfa_bits.cu):
//   1. start injection: at p == 0 only when anchored, otherwise at every
//      p <= len (a row leaves the loop at its first match);
//   2. eps-closure: for every SET state bit i, OR in inst i's closure row
//      for the position's variant (W words of a [U, I, W] table);
//   3. matched |= (closed & end) != 0;
//   4. consume: fire = closed & pred(c_p) word by word, then for every SET
//      bit i of fire OR in inst i's next row (pred is 0 at c == 0).
// Walking set bits only (__ffs), the cost follows the number of live
// states, where the TPU pays for every lane of the padded matrix.  The
// predicate and the variant come from the chars at p - 1 and p through the
// program's char tables (nfa_chars.cuh): an ASCII char's predicate is W
// words of pred_a in shared memory; another char's is its class words
// (the 64K table, L2-resident, or the classes' ranges above the BMP) with
// the CHAR pairs of chars >= 128, ANY and ANYNL; the variant (programs
// with several only) is ctx_map[ctx] of the two chars, the previous
// char's alnum flag carried over from the last step.
//
// The program table is one int32 array built by regex/nfa_words.py:
//   [U, I, W, n_pairs, crows[U*I*W], nrows[I*W], start[W], end[W],
//    any[W], anynl[W], (inst, char) pairs[2*n_pairs]].
// Each block stages it in shared memory with the char table's head
// (head_words(W) words): a program K2b takes (at most 256 instructions
// within the TPU's table budget, so U*I*W*4 <= 196,608 bytes for the
// closure rows, ~210 KB in all at W = 8) fits the block's 227 KB, dynamic
// shared memory above 48 KB with the opt-in.  A larger table is refused
// (cudaErrorInvalidValue).
//
// Bound on the H100: device-memory bytes and load latency.  The kernel
// reads 4 bytes of chars a position and the row's length, writes one byte
// a row; the ops per position follow the live states.  One thread per row
// reads its row of the row-major char matrix in place, 4 bytes a load, as
// K2 does (four chars a 16-byte load moved ISO by +14% to +18% and MONTH
// by -8% to -11% on the H100, a wash over the log filters; PERF.md).  A
// row stops at p = min(len, L), at its first match, and, anchored, once
// its state is empty (no later injection can revive it).

#include <cstdint>
#include <cuda_runtime.h>

#include "nfa_chars.cuh"

namespace {

using namespace nfa_chars;

constexpr int THREADS = 256;
constexpr int TAB_HDR = 4;  // U, I, W, n_pairs
constexpr int SMEM_OPT_IN = 232448;  // 227 KB: a block's shared memory on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;

template <int W>
__global__ void __launch_bounds__(THREADS)
nfa_words(const int32_t* __restrict__ chars, const int32_t* __restrict__ lengths,
          const uint32_t* __restrict__ prog, int prog_len,
          const int32_t* __restrict__ ctab, const uint32_t* __restrict__ bmp,
          int64_t N, int64_t L, int anchored, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* head = smem;                    // head_words(W) words
  uint32_t* tab = smem + head_words(W);     // prog_len words
  for (int i = threadIdx.x; i < head_words(W); i += THREADS) head[i] = (uint32_t)ctab[i];
  for (int i = threadIdx.x; i < prog_len; i += THREADS) tab[i] = prog[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  const Chars<W> t{head, bmp, ctab};
  const int U = (int)tab[0];
  const int I = (int)tab[1];
  const int n_pairs = (int)tab[3];
  const uint32_t* crows = tab + TAB_HDR;
  const uint32_t* nrows = crows + U * I * W;
  const uint32_t* start = nrows + I * W;
  const uint32_t* endw = start + W;
  const uint32_t* any = endw + W;
  const uint32_t* anynl = any + W;
  const uint32_t* pairs = anynl + W;

  const int64_t len = lengths[row];
  const int64_t last = len < L ? len : L;
  const int32_t* crow = chars + row * L;

  uint32_t state[W], closed[W], nxt[W], pred[W];
#pragma unroll
  for (int w = 0; w < W; ++w) state[w] = 0u;
  bool matched = false, al_prev = false;
  int32_t prev = 0;
  for (int64_t p = 0; p <= last; ++p) {
    // the char at p, 0 at the EOS slot (p == len) and past the matrix
    const int32_t cur = p < last ? crow[p] : 0;
    if (!anchored || p == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) state[w] |= start[w];
    }
    const uint32_t* cr = crows;
    if (U > 1) {
      const bool al = alnum_of(t, cur);
      cr += variant(t, p == 0, prev, cur, al_prev, al) * I * W;
      al_prev = al;
    }
    uint32_t hit = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) closed[w] = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      for (uint32_t s = state[w]; s != 0u; s &= s - 1u) {
        const uint32_t* r = cr + (w * 32 + __ffs(s) - 1) * W;
#pragma unroll
        for (int v = 0; v < W; ++v) closed[v] |= r[v];
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) hit |= closed[w] & endw[w];
    if (hit) {  // matched only ORs: the result is final
      matched = true;
      break;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) nxt[w] = 0u;
    if (cur != 0) {  // the sentinel (or a NUL char) consumes nothing
      pred_of<W>(t, cur, pairs, n_pairs, any, anynl, pred);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        for (uint32_t f = closed[w] & pred[w]; f != 0u; f &= f - 1u) {
          const uint32_t* r = nrows + (w * 32 + __ffs(f) - 1) * W;
#pragma unroll
          for (int v = 0; v < W; ++v) nxt[v] |= r[v];
        }
      }
    }
    uint32_t live = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      state[w] = nxt[w];
      live |= nxt[w];
    }
    if (anchored && live == 0u) break;  // no injection after p = 0
    prev = cur;
  }
  out[row] = matched ? 1 : 0;
}

template <int W>
int launch(const void* chars, const void* lengths, const void* prog,
           int prog_len, const void* ctab, const void* bmp, int64_t N,
           int64_t L, int anchored, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(head_words(W) + prog_len) * sizeof(uint32_t);
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t e = cudaFuncSetAttribute(
        nfa_words<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  nfa_words<W><<<grid, THREADS, smem, stream>>>(
      (const int32_t*)chars, (const int32_t*)lengths, (const uint32_t*)prog,
      prog_len, (const int32_t*)ctab, (const uint32_t*)bmp, N, L, anchored,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// chars: int32 [N, L] row-major; lengths: int32 [N]; prog: int32 table of
// prog_len entries (layout above); ctab: int32 char table of ctab_len
// entries and bmp: uint32 [65536 * W + 2048] (layouts in nfa_chars.cuh);
// W = ceil(I/32) <= 8, the word count of both tables; out: uint8 [N].
int cs_nfa_words(const void* chars, const void* lengths, const void* prog,
                 int prog_len, const void* ctab, int ctab_len, const void* bmp,
                 int64_t N, int64_t L, int W, int anchored, void* out,
                 void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (L <= 0 || prog_len < TAB_HDR || W < 1 || W > 8 || ctab_len < head_words(W) + W + 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 2: return launch<2>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 3: return launch<3>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 4: return launch<4>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 5: return launch<5>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 6: return launch<6>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    case 7: return launch<7>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
    default: return launch<8>(chars, lengths, prog, prog_len, ctab, bmp, N, L, anchored, out, s);
  }
}

}  // extern "C"
