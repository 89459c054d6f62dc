// The per-char predicates and closure variants of the bit matchers (K2,
// nfa_bits.cu; K2b, nfa_words.cu) and the span passes (K5, spans.cu),
// computed from the chars at p - 1 and p, which the kernels read anyway,
// in place of per-position planes built in front of them.
//
// Two tables per program, built by regex/nfa_chars.py (CharTables), W =
// ceil(I / 32) words a char (bit i % 32 of word i / 32 is instruction i):
//   char table  [pred_a[128 * W], alnum[4], ctx_map[32],
//                memb_B[W], n_cls, rmax, memb_M[n_cls * W],
//                lo[n_cls * rmax], hi[n_cls * rmax]]
//   bmp table   [memb[65536 * W], alnum bits[2048]]
// The head of the char table (head_words(W): pred_a, alnum, ctx_map) is
// copied to shared memory by each block; the rest stays in device memory
// (the bmp table, 256 KB a word, stays L2-resident).
//   pred(c)  pred_a[c] for an ASCII char: its class bits, CHAR, ANY
//            (c != '\n') and ANYNL, 0 at c == 0.  Above ASCII: memb(c)
//            | the CHAR pairs of chars >= 128 | ANY | ANYNL, where memb(c)
//            is the bmp table's W words in the BMP, and above it memb_B ^
//            memb_M[k] of each class k whose explicit ranges hold c
//            (builtin classes never match there)
//   variant  ctx_map[BOS | PREV_NL | EOS | CUR_NL | WB] from the chars at
//            p - 1 and p (0 outside the row) and their alnum flags (the
//            ASCII set in shared memory, the BMP bits in device memory,
//            none above)
//
// K2's program table, read by K2 and K5 (regex/nfa_bits.py::NFABits):
//   [U, I, start, end, any, anynl, n_pairs,
//    crows[U*I], nrows[I], (inst, char) pairs[2*n_pairs]]
// with the pairs of chars >= 128 only (an ASCII char's are in pred_a).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nfa_chars {

constexpr int BMP = 65536;
constexpr int ALNUM_WORDS = 4;
constexpr int CTX_WORDS = 32;

// the words of the char table's head, which blocks stage in shared memory
__host__ __device__ constexpr int head_words(int W) {
  return 128 * W + ALNUM_WORDS + CTX_WORDS;
}

// the tables, with W words a char: the head in shared memory, the bmp
// table and the char table (for its class part) in device memory
template <int W>
struct Chars {
  const uint32_t* head;  // shared: pred_a[128 * W], alnum[4], ctx_map[32]
  const uint32_t* bmp;   // device: memb[65536 * W], alnum bits[2048]
  const int32_t* ctab;   // device: the char table
};

// the class words of a char outside ASCII (c >= 128, or negative)
template <int W>
__device__ __forceinline__ void memb_of(const Chars<W>& t, int32_t c,
                                        uint32_t (&m)[W]) {
  const uint32_t u = (uint32_t)c;
  if (u < (uint32_t)BMP) {
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = __ldg(t.bmp + (size_t)u * W + w);
    return;
  }
  // above the BMP (or negative): the explicit ranges, each class once
  const int32_t* cls = t.ctab + head_words(W);  // memb_B[W], n_cls, rmax, ...
  const int n = cls[W], r = cls[W + 1];
  const int32_t* M = cls + W + 2;
  const int32_t* lo = M + n * W;
  const int32_t* hi = lo + n * r;
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = (uint32_t)cls[w];
  for (int k = 0; k < n; ++k) {
    for (int j = 0; j < r; ++j) {
      if (c >= lo[k * r + j] && c <= hi[k * r + j]) {
#pragma unroll
        for (int w = 0; w < W; ++w) m[w] ^= (uint32_t)M[k * W + w];
        break;
      }
    }
  }
}

// the consume predicate of any char (0 at c == 0): pairs are the (inst,
// char) pairs of chars >= 128, any and anynl the ANY and ANYNL words
template <int W>
__device__ __forceinline__ void pred_of(const Chars<W>& t, int32_t c,
                                        const uint32_t* pairs, int n_pairs,
                                        const uint32_t* any,
                                        const uint32_t* anynl,
                                        uint32_t (&pred)[W]) {
  if ((uint32_t)c < 128u) {
#pragma unroll
    for (int w = 0; w < W; ++w) pred[w] = t.head[c * W + w];
    return;
  }
  memb_of<W>(t, c, pred);
  for (int k = 0; k < n_pairs; ++k) {
    if (c == (int32_t)pairs[2 * k + 1]) {
      const uint32_t i = pairs[2 * k];
#pragma unroll
      for (int w = 0; w < W; ++w) pred[w] |= (i >> 5) == (uint32_t)w ? 1u << (i & 31) : 0u;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) pred[w] |= (c != 10 ? any[w] : 0u) | anynl[w];
}

template <int W>
__device__ __forceinline__ bool alnum_of(const Chars<W>& t, int32_t c) {
  if (c <= 0) return false;
  if (c < 128) return (t.head[128 * W + (c >> 5)] >> (c & 31)) & 1u;
  if (c < BMP) return (__ldg(t.bmp + BMP * W + (c >> 5)) >> (c & 31)) & 1u;
  return false;
}

// the closure variant at a position: bos (p == 0), the chars at p - 1 and
// p (each 0 outside the row) and their alnum flags
template <int W>
__device__ __forceinline__ int variant(const Chars<W>& t, bool bos,
                                       int32_t prev, int32_t cur,
                                       bool al_prev, bool al_cur) {
  const int ctx = (bos ? 1 : 0) | (prev == 10 ? 2 : 0) | (cur == 0 ? 4 : 0) |
                  (cur == 10 ? 8 : 0) | (al_prev != al_cur ? 16 : 0);
  return (int)t.head[128 * W + ALNUM_WORDS + ctx];
}

// K2's program table (see above)
constexpr int MAX_U = 32;
constexpr int MAX_I = 32;
constexpr int HDR = 7;
constexpr int MAX_PROG = HDR + MAX_U * MAX_I + MAX_I + 2 * MAX_I;

struct Prog {
  int U, I, n_pairs;
  uint32_t start_bits, end_bits;
  const uint32_t* any;    // [1]
  const uint32_t* anynl;  // [1]
  const uint32_t* crows;
  const uint32_t* nrows;
  const uint32_t* pairs;
};

// the program's fields over its table, already in shared memory
__device__ __forceinline__ Prog load_prog(const uint32_t* tab) {
  Prog g;
  g.U = (int)tab[0];
  g.I = (int)tab[1];
  g.start_bits = tab[2];
  g.end_bits = tab[3];
  g.any = tab + 4;
  g.anynl = tab + 5;
  g.n_pairs = (int)tab[6];
  g.crows = tab + HDR;
  g.nrows = g.crows + g.U * g.I;
  g.pairs = g.nrows + g.I;
  return g;
}

// the one-word predicate of a char under K2's program table
__device__ __forceinline__ uint32_t pred_bits(const Prog& g,
                                              const Chars<1>& t, int32_t c) {
  uint32_t p[1];
  pred_of<1>(t, c, g.pairs, g.n_pairs, g.any, g.anynl, p);
  return p[0];
}

}  // namespace nfa_chars
