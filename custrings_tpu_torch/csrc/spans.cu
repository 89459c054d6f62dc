// K5: first-match spans with one uint32 bit state per row (certified
// programs of at most 32 instructions), in two passes: span_back finds the
// leftmost begin b0 >= start_pos, span_fwd the last END fired from b0.
//
// Replaces the TPU kernels of custrings_tpu/regex/pallas_spans.py::
// SpanBits.single: _back_kernel_factory (span_back) and
// _fwd_end_kernel_factory (span_fwd).  The steps are the TPU kernels':
//
//   back, p = L .. 0, carrying B = B_{p+1} (from p, some match ends):
//     t    = { i : nrows[i] & B != 0 }         insts whose successor is in B
//     t2   = (t & pred(c_p)) | (p <= len ? END : 0)
//     B    = { i : crows[uid(p)][i] & t2 != 0 }
//     b0   = p  where B & start != 0, p <= len and p >= start_pos
//   fwd, p = 0 .. L:
//     state |= start at p == b0 (b0 == -1 never injects)
//     closed = OR of crows[uid(p)][i] over the state's bits
//     e0 = p  where closed & END != 0
//     state  = OR of nrows[i] over the bits of closed & pred(c_p)
//
// pred(c) is K2's predicate: the class plane membw | CHAR bits | ANY
// (c != '\n') | ANYNL, all zero at c == 0 (past the row's length).  The
// program table is K2's (csrc/nfa_bits.cu):
//   [U, I, start, end, any, anynl, n_pairs,
//    crows[U*I], nrows[I], (inst, char) pairs[2*n_pairs]],
// copied to shared memory by each block.
//
// Bound on the H100: device-memory bytes and load latency.  Per row and
// position each pass reads 4 bytes each of chars and membw (and of uid when
// the program has several closure variants) and does ~2*I integer ops, far
// below the card's op rate per byte; each thread's positions are a serial
// chain.  The TPU kernels run every row over all L + 1 positions in
// [8, T] slabs; here one thread per row reads the row-major planes in
// place through their strides (as K2 does: L1 keeps a row's 32-byte sector
// for its next positions) and walks only the positions that can change
// its result:
//   back: B_{p} is 0 for every p > len (no char, no END), so the walk
//         starts at min(len, L); b0 only moves down and never below
//         start_pos, so the walk stops at max(start_pos, 0).  A row given
//         start_pos > len does no work (all_spans passes that for rows
//         whose round loop has ended).
//   fwd:  nothing fires before b0, and once the state is empty after the
//         injection, or the row has ended (c == 0), nothing fires again,
//         so the walk is b0 .. the end of the longest match.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_U = 32;
constexpr int MAX_I = 32;
constexpr int HDR = 7;
constexpr int MAX_PROG = HDR + MAX_U * MAX_I + MAX_I + 2 * MAX_I;

struct Strides {
  int64_t row, pos;  // elements between rows / between positions
};

struct Prog {
  int U, I, n_pairs;
  uint32_t start_bits, end_bits, any_bits, anynl_bits;
  const uint32_t* crows;
  const uint32_t* nrows;
  const uint32_t* pairs;
};

__device__ __forceinline__ Prog load_prog(uint32_t* tab, const int32_t* prog,
                                          int prog_len) {
  for (int i = threadIdx.x; i < prog_len; i += THREADS) {
    tab[i] = (uint32_t)prog[i];
  }
  __syncthreads();
  Prog g;
  g.U = (int)tab[0];
  g.I = (int)tab[1];
  g.start_bits = tab[2];
  g.end_bits = tab[3];
  g.any_bits = tab[4];
  g.anynl_bits = tab[5];
  g.n_pairs = (int)tab[6];
  g.crows = tab + HDR;
  g.nrows = g.crows + g.U * g.I;
  g.pairs = g.nrows + g.I;
  return g;
}

// the consume predicate of a char cur != 0 whose class bits are memb
__device__ __forceinline__ uint32_t pred_bits(const Prog& g, int32_t cur,
                                              uint32_t memb) {
  uint32_t pred = memb;
  for (int k = 0; k < g.n_pairs; ++k) {
    if (cur == (int32_t)g.pairs[2 * k + 1]) pred |= 1u << g.pairs[2 * k];
  }
  if (cur != 10) pred |= g.any_bits;
  return pred | g.anynl_bits;
}

__global__ void __launch_bounds__(THREADS)
span_back(const int32_t* __restrict__ chars, const int32_t* __restrict__ membw,
          Strides cs, const int32_t* __restrict__ uid, Strides us,
          const int32_t* __restrict__ lengths,
          const int32_t* __restrict__ start_pos,
          const int32_t* __restrict__ prog, int prog_len, int64_t N,
          int64_t L, int32_t* __restrict__ out) {
  __shared__ uint32_t tab[MAX_PROG];
  const Prog g = load_prog(tab, prog, prog_len);
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  const int64_t len = lengths[row];
  const int64_t w = start_pos[row];
  const int32_t* crow = chars + row * cs.row;
  const int32_t* mrow = membw + row * cs.row;
  const int32_t* urow = uid + row * us.row;
  const int64_t stop = w > 0 ? w : 0;
  uint32_t B = 0;  // B_{p+1}; 0 past the row's length
  int32_t b0 = -1;
  for (int64_t p = len < L ? len : L; p >= stop; --p) {
    // here p <= len, so END may close the match at p
    uint32_t t2 = g.end_bits;
    if (B != 0u) {
      uint32_t t = 0;
      for (int i = 0; i < g.I; ++i) {
        if (B & g.nrows[i]) t |= 1u << i;
      }
      const int64_t pc = p < L ? p : L - 1;
      const int32_t cur = p < len ? crow[pc * cs.pos] : 0;
      if (t != 0u && cur != 0) {
        t2 |= t & pred_bits(g, cur, (uint32_t)mrow[pc * cs.pos]);
      }
    }
    const uint32_t* cr = g.crows;
    if (g.U > 1) cr += (int64_t)urow[p * us.pos] * g.I;
    uint32_t nb = 0;
    for (int i = 0; i < g.I; ++i) {
      if (t2 & cr[i]) nb |= 1u << i;
    }
    B = nb;
    if (B & g.start_bits) b0 = (int32_t)p;
  }
  out[row] = b0;
}

__global__ void __launch_bounds__(THREADS)
span_fwd(const int32_t* __restrict__ chars, const int32_t* __restrict__ membw,
         Strides cs, const int32_t* __restrict__ uid, Strides us,
         const int32_t* __restrict__ lengths, const int32_t* __restrict__ begins,
         const int32_t* __restrict__ prog, int prog_len, int64_t N, int64_t L,
         int32_t* __restrict__ out) {
  __shared__ uint32_t tab[MAX_PROG];
  const Prog g = load_prog(tab, prog, prog_len);
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  const int64_t len = lengths[row];
  const int64_t b0 = begins[row];
  const int32_t* crow = chars + row * cs.row;
  const int32_t* mrow = membw + row * cs.row;
  const int32_t* urow = uid + row * us.row;
  int32_t e0 = -1;
  uint32_t state = g.start_bits;  // injected at p == b0
  for (int64_t p = b0; p >= 0 && p <= L; ++p) {
    const uint32_t* cr = g.crows;
    if (g.U > 1) cr += (int64_t)urow[p * us.pos] * g.I;
    uint32_t closed = 0;
    for (int i = 0; i < g.I; ++i) {
      if ((state >> i) & 1u) closed |= cr[i];
    }
    if (closed & g.end_bits) e0 = (int32_t)p;
    const int64_t pc = p < L ? p : L - 1;
    const int32_t cur = p < len ? crow[pc * cs.pos] : 0;
    if (cur == 0) break;  // no char: the next state is empty
    const uint32_t fire = closed & pred_bits(g, cur, (uint32_t)mrow[pc * cs.pos]);
    uint32_t next = 0;
    for (int i = 0; i < g.I; ++i) {
      if ((fire >> i) & 1u) next |= g.nrows[i];
    }
    state = next;
    if (state == 0u) break;  // no injection after b0: nothing fires again
  }
  out[row] = e0;
}

int check_args(int64_t L, int prog_len) {
  if (prog_len > MAX_PROG || L <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// chars, membw: int32 [N, L] with element strides (c_row, c_pos), the same
// for both; uid: int32 [N, L + 1] with strides (u_row, u_pos), read only
// when the program has several closure variants (U > 1; else null);
// lengths, start_pos: int32 [N]; prog: int32 table of prog_len entries
// (layout above); out: int32 [N], the leftmost begin b0 or -1.
int cs_span_back(const void* chars, const void* membw, int64_t c_row,
                 int64_t c_pos, const void* uid, int64_t u_row, int64_t u_pos,
                 const void* lengths, const void* start_pos, const void* prog,
                 int prog_len, int64_t N, int64_t L, void* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (int err = check_args(L, prog_len)) return err;
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  span_back<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)chars, (const int32_t*)membw, Strides{c_row, c_pos},
      (const int32_t*)uid, Strides{u_row, u_pos}, (const int32_t*)lengths,
      (const int32_t*)start_pos, (const int32_t*)prog, prog_len, N, L,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// As cs_span_back, with begins: int32 [N] the b0 of span_back; out: int32
// [N], the position of the last END fired from b0, or -1.
int cs_span_fwd(const void* chars, const void* membw, int64_t c_row,
                int64_t c_pos, const void* uid, int64_t u_row, int64_t u_pos,
                const void* lengths, const void* begins, const void* prog,
                int prog_len, int64_t N, int64_t L, void* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (int err = check_args(L, prog_len)) return err;
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  span_fwd<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)chars, (const int32_t*)membw, Strides{c_row, c_pos},
      (const int32_t*)uid, Strides{u_row, u_pos}, (const int32_t*)lengths,
      (const int32_t*)begins, (const int32_t*)prog, prog_len, N, L,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
