// K2: lockstep boolean NFA with one uint32 state per row (programs of at
// most 32 instructions), for contains_re / match_re.
//
// Replaces the TPU kernel custrings_tpu/regex/pallas_nfa.py::
// PallasNFA._matches_bits (body _bit_kernel_factory).  The step per
// position p = 0..L is exactly the TPU kernel's:
//   1. start injection: at p == 0 only when anchored, otherwise while
//      matched == 0 && p <= len;
//   2. eps-closure: OR of crows[uid][i] over every set state bit i;
//   3. matched |= (closed & end_bits) != 0;
//   4. predicate: class plane membw | CHAR bits | ANY (c != '\n' && c != 0)
//      | ANYNL (c != 0), all masked by c != 0;
//   5. transition: OR of nrows[i] over every fired bit i.
// The TPU bakes the program tables into the kernel as Python ints; here
// they arrive as one small int32 array per program and sit in shared
// memory:  [U, I, start, end, any, anynl, n_pairs,
//           crows[U*I], nrows[I], (inst, char) pairs[2*n_pairs]].
//
// Bound on the H100: device-memory bytes and load latency.  Per row and
// position the kernel reads 4 bytes each of chars and membw (and of uid
// when the program has several closure variants) and does ~2*I integer
// ops; at I = 7 (`#\w+`) that is ~14 ops per 8 bytes, far below the card's
// op rate per byte.  Each thread's positions form a serial chain.
//
// Design: one thread per row, reading the planes where they lie.  The
// kernel takes each plane's row and position strides, and the wrapper
// passes the row-major [N, L] tensors torch built, so no copy is made.
// Read row-major, a warp's step touches one 32-byte sector per row and the
// next seven positions of that row find the same sector in L1.  Measured
// at 1M rows x 320 (`#\w+`, NVIDIA H100 80GB HBM3, 700 W): 1.41 ms
// row-major against 1.50 ms on position-major copies, whose transposes
// cost 11.3 ms per plane.  A row stops at p = min(len, L): past its
// length the predicate is 0 and injection has ended, so the state stays 0
// and the result cannot change (the TPU runs every lane to L).  A row
// also stops at its first match, since `matched` only ORs.

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

__global__ void __launch_bounds__(THREADS)
nfa_bits(const int32_t* __restrict__ chars, const int32_t* __restrict__ membw,
         Strides cs, const int32_t* __restrict__ uid, Strides us,
         const int32_t* __restrict__ lengths, const int32_t* __restrict__ prog,
         int prog_len, int64_t N, int64_t L, int anchored,
         uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[MAX_PROG];
  for (int i = threadIdx.x; i < prog_len; i += THREADS) {
    tab[i] = (uint32_t)prog[i];
  }
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  const int U = (int)tab[0];
  const int I = (int)tab[1];
  const uint32_t start_bits = tab[2], end_bits = tab[3];
  const uint32_t any_bits = tab[4], anynl_bits = tab[5];
  const int n_pairs = (int)tab[6];
  const uint32_t* crows = tab + HDR;
  const uint32_t* nrows = crows + U * I;
  const uint32_t* pairs = nrows + I;

  const int64_t len = lengths[row];
  const int32_t* crow = chars + row * cs.row;
  const int32_t* mrow = membw + row * cs.row;
  const int32_t* urow = uid + row * us.row;
  const int64_t last = len < L ? len : L;
  uint32_t state = 0, matched = 0;
  for (int64_t p = 0; p <= last; ++p) {
    const int64_t pc = p < L ? p : L - 1;
    const int32_t cur = p < len ? crow[pc * cs.pos] : 0;
    const bool inject =
        anchored ? (p == 0 && matched == 0) : (matched == 0 && p <= len);
    if (inject) state |= start_bits;
    const uint32_t* cr = crows;
    if (U > 1) cr += (int64_t)urow[p * us.pos] * I;
    uint32_t closed = 0;
    for (int i = 0; i < I; ++i) {
      if ((state >> i) & 1u) closed |= cr[i];
    }
    matched |= (closed & end_bits) != 0u;
    if (matched) break;  // matched only ORs: the result is final
    if (cur == 0) {  // the sentinel consumes nothing
      state = 0;
      continue;
    }
    uint32_t pred = (uint32_t)mrow[pc * cs.pos];
    for (int k = 0; k < n_pairs; ++k) {
      if (cur == (int32_t)pairs[2 * k + 1]) pred |= 1u << pairs[2 * k];
    }
    if (cur != 10) pred |= any_bits;
    pred |= anynl_bits;
    const uint32_t fire = closed & pred;
    uint32_t next = 0;
    for (int i = 0; i < I; ++i) {
      if ((fire >> i) & 1u) next |= nrows[i];
    }
    state = next;
  }
  out[row] = matched ? 1 : 0;
}

}  // namespace

extern "C" {

// chars, membw: int32 [N, L] with element strides (c_row, c_pos), the
// same for both; uid: int32 [N, L + 1] with strides (u_row, u_pos), read
// only when the program has several closure variants (U > 1; else null);
// lengths: int32 [N]; prog: int32 table of prog_len entries (layout above);
// out: uint8 [N] (0/1).
int cs_nfa_bits(const void* chars, const void* membw, int64_t c_row,
                int64_t c_pos, const void* uid, int64_t u_row, int64_t u_pos,
                const void* lengths, const void* prog, int prog_len,
                int64_t N, int64_t L, int anchored, void* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (prog_len > MAX_PROG || L <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  nfa_bits<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)chars, (const int32_t*)membw, Strides{c_row, c_pos},
      (const int32_t*)uid, Strides{u_row, u_pos}, (const int32_t*)lengths,
      (const int32_t*)prog, prog_len, N, L, anchored, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
