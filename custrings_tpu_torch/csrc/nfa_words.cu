// K2b: lockstep boolean NFA with a multi-word bitset state per row
// (programs of up to 256 instructions), for contains_re / match_re.
//
// Replaces the TPU kernel custrings_tpu/regex/pallas_nfa.py::
// PallasNFA._matches_f32 (body _kernel_factory).  The TPU holds the state
// as a dense f32 vector of the instruction count padded to 128 or 256
// lanes and pays two MXU products per position over every lane:
//   closed = state @ closure[uid]        state' = (closed * pred) @ next.
// Here the state is W = ceil(I/32) <= 8 uint32 words in registers, and the
// step per position p = 0..L is the same automaton as K2 (nfa_bits.cu):
//   1. start injection: at p == 0 only when anchored, otherwise while
//      p <= len (a row leaves the loop at its first match);
//   2. eps-closure: for every SET state bit i, OR in inst i's closure row
//      for the position's variant uid (W words of a [U, I, W] table);
//   3. matched |= (closed & end) != 0;
//   4. consume: for every SET bit i of closed, test inst i's own
//      predicate (CHAR against its arg, ANY: c != '\n', ANYNL, or its
//      class bit in the membership plane word i / 32; c == 0 consumes
//      nothing) and OR in inst i's next row.
// Walking set bits only (__ffs), the cost follows the number of live
// states, where the TPU pays for every lane of the padded matrix.
//
// The program table is one int32 array built by regex/nfa_words.py:
//   [U, I, W, crows[U*I*W], nrows[I*W], start[W], end[W], inst[I]],
// inst[i] = kind << 24 | arg (kinds as K_* below).  Each block stages it
// in shared memory: a program K2b takes (at most 256 instructions within
// the TPU's table budget, so U*I*W*4 <= 196,608 bytes for the closure
// rows, ~206 KB in all) fits the block's 227 KB, dynamic shared memory
// above 48 KB with the opt-in.  A larger table is refused
// (cudaErrorInvalidValue).
//
// Bound on the H100: device-memory bytes and load latency.  Per row and
// position the kernel reads 4 bytes of chars, 4*W of the membership planes
// and 4 of uid (several variants only); the ops per position follow the
// live states.  The planes are row-major [N, L], [N, L, W] and [N, L + 1],
// read in place as K2 reads its planes.  A row stops at p = min(len, L),
// at its first match, and, anchored, once its state is empty (no later
// injection can revive it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int HDR = 3;
constexpr int SMEM_OPT_IN = 232448;  // 227 KB: a block's shared memory on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;

constexpr uint32_t K_CHAR = 1, K_ANY = 2, K_ANYNL = 3, K_CLASS = 4;

template <int W>
__global__ void __launch_bounds__(THREADS)
nfa_words(const int32_t* __restrict__ chars, const uint32_t* __restrict__ membw,
          const int32_t* __restrict__ uid, const int32_t* __restrict__ lengths,
          const uint32_t* __restrict__ prog, int prog_len,
          int64_t N, int64_t L, int anchored, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < prog_len; i += THREADS) tab[i] = prog[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  const int U = (int)tab[0];
  const int I = (int)tab[1];
  const uint32_t* crows = tab + HDR;
  const uint32_t* nrows = crows + (int64_t)U * I * W;
  const uint32_t* start = nrows + I * W;
  const uint32_t* endw = start + W;
  const uint32_t* inst = endw + W;

  const int64_t len = lengths[row];
  const int32_t* crow = chars + row * L;
  const uint32_t* mrow = membw + row * L * W;
  const int32_t* urow = uid + row * (L + 1);
  const int64_t last = len < L ? len : L;

  uint32_t state[W], closed[W], nxt[W], memb[W];
#pragma unroll
  for (int w = 0; w < W; ++w) state[w] = 0u;
  bool matched = false;
  for (int64_t p = 0; p <= last; ++p) {
    const int64_t pc = p < L ? p : L - 1;
    const int32_t cur = p < len ? crow[pc] : 0;
    if (anchored ? p == 0 : p <= len) {
#pragma unroll
      for (int w = 0; w < W; ++w) state[w] |= start[w];
    }
    const uint32_t* cr = crows;
    if (U > 1) cr += (int64_t)urow[p] * I * W;
    uint32_t hit = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) closed[w] = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t s = state[w];
      while (s) {
        const int b = __ffs(s) - 1;
        s &= s - 1u;
        const uint32_t* r = cr + (w * 32 + b) * W;
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
#pragma unroll
      for (int w = 0; w < W; ++w) memb[w] = mrow[pc * W + w];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t f = closed[w];
        while (f) {
          const int b = __ffs(f) - 1;
          f &= f - 1u;
          const int i = w * 32 + b;
          const uint32_t ins = inst[i];
          const uint32_t kind = ins >> 24;
          bool ok;
          if (kind == K_CHAR) {
            ok = (uint32_t)cur == (ins & 0xFFFFFFu);
          } else if (kind == K_ANY) {
            ok = cur != 10;
          } else if (kind == K_ANYNL) {
            ok = true;
          } else if (kind == K_CLASS) {
            ok = (memb[w] >> b) & 1u;
          } else {
            ok = false;
          }
          if (ok) {
            const uint32_t* r = nrows + i * W;
#pragma unroll
            for (int v = 0; v < W; ++v) nxt[v] |= r[v];
          }
        }
      }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      state[w] = nxt[w];
      any |= nxt[w];
    }
    if (anchored && any == 0u) break;  // no injection after p = 0
  }
  out[row] = matched ? 1 : 0;
}

template <int W>
int launch(const void* chars, const void* membw, const void* uid,
           const void* lengths, const void* prog, int prog_len, int64_t N,
           int64_t L, int anchored, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)prog_len * sizeof(uint32_t);
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t e = cudaFuncSetAttribute(
        nfa_words<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((N + THREADS - 1) / THREADS);
  nfa_words<W><<<grid, THREADS, smem, stream>>>(
      (const int32_t*)chars, (const uint32_t*)membw, (const int32_t*)uid,
      (const int32_t*)lengths, (const uint32_t*)prog, prog_len, N, L,
      anchored, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// chars: int32 [N, L]; membw: int32 [N, L, W] (W = ceil(I/32) <= 8);
// uid: int32 [N, L + 1], read only when the program has several closure
// variants (else null); lengths: int32 [N]; all row-major and contiguous.
// prog: int32 table of prog_len entries (layout above); out: uint8 [N].
int cs_nfa_words(const void* chars, const void* membw, const void* uid,
                 const void* lengths, const void* prog, int prog_len,
                 int64_t N, int64_t L, int W, int anchored, void* out,
                 void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (L <= 0 || prog_len < HDR) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 2: return launch<2>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 3: return launch<3>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 4: return launch<4>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 5: return launch<5>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 6: return launch<6>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 7: return launch<7>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    case 8: return launch<8>(chars, membw, uid, lengths, prog, prog_len, N, L, anchored, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
