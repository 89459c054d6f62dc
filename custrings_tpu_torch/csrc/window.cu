// K1 / K1b: ragged row-window gather, as bytes or as big-endian words.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_window.py::_ragged_window_p
// (body _window_kernel_factory, words=False via ragged_gather_i32 /
// ragged_gather, words=True via ragged_gather_words).
//
//   bytes: out[r, k] = starts[r] + k < cap ? data[starts[r] + k] : 0, k < W,
//          and 0 for k >= lens[r] when lengths are given
//   words: out[r, q] = b[4q] << 24 | b[4q+1] << 16 | b[4q+2] << 8 | b[4q+3]
//          over the same window, zeros past the end of the buffer
//
// The bytes form masks at each row's length in the kernel when it is given
// the lengths (the padded views and the char matrix), so no second pass
// over the [rows, W] output is needed; without them neither form masks,
// as on the TPU.
//
// Bound on the H100: device-memory bytes, read rows*W input bytes (rows
// overlap little; with lengths, only the bytes inside each row) and write
// rows*W output bytes (x4 for the int32 form).
// The TPU version spends one aligned 4 KB DMA per row plus a rotate,
// because Mosaic only slices aligned windows; Hopper has no such rule,
// so the per-row alignment machinery, the SMEM row chunking and the
// MXU packing all go.
//
// Design of the bytes form: one warp per row, eight rows per 256-thread
// block; each lane moves one byte per step, so a warp reads 32 consecutive
// input bytes and writes 32 consecutive outputs per step: coalesced on
// both sides however the row start is aligned.
//
// Design of the words form: threads over the flat [rows, Wq] output, four
// consecutive output words a thread (one 16-byte store), so every lane
// works at any Wq and a warp stores 512 contiguous bytes; the four words
// may straddle rows.  Each word is assembled from the two aligned 4-byte
// words that cover its window (alignment taken from the absolute address
// data + start, since data may be a view at any offset) with one
// __funnelshift_r and one __byte_perm for the byte swap; a thread whose
// four words lie in one row (every thread when Wq is a multiple of 4, as
// in the encode's key words and tails) takes five aligned loads, the
// others assemble word by word.  An aligned word that would
// reach before data or past cap is not read: that word's bytes are taken
// one by one (the allocation is not known to be padded).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;

template <typename OutT>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
window_bytes(const uint8_t* __restrict__ data, int64_t cap,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
             int64_t rows, int64_t W, OutT* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t s = starts[r];
  const int64_t len = lens != nullptr ? (int64_t)lens[r] : W;
  OutT* o = out + r * W;
  for (int64_t k = lane; k < W; k += 32) {
    const int64_t g = s + k;
    o[k] = (k < len && g >= 0 && g < cap) ? (OutT)data[g] : (OutT)0;
  }
}

constexpr int WORD_THREADS = 256;
constexpr int WORDS_PER_THREAD = 4;

// the big-endian word of bytes [rel, rel + 4) of data[0, cap), 0 outside
__device__ __forceinline__ uint32_t be_word(const uint8_t* __restrict__ data,
                                            int64_t cap, int64_t rel) {
  const int mis = (int)(((uintptr_t)data + (uintptr_t)rel) & 3);
  const int64_t lo = rel - mis;  // data + lo is 4-byte aligned
  if (lo >= 0 && lo + (mis ? 8 : 4) <= cap) {
    const uint32_t* p = (const uint32_t*)(data + lo);
    const uint32_t w0 = __ldg(p);
    const uint32_t w1 = mis ? __ldg(p + 1) : 0u;
    return __byte_perm(__funnelshift_r(w0, w1, 8 * mis), 0, 0x0123);
  }
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t g = rel + i;
    const uint32_t b = (g >= 0 && g < cap) ? (uint32_t)data[g] : 0u;
    w |= b << (24 - 8 * i);
  }
  return w;
}

// x / y, in 32 bits when both fit
__device__ __forceinline__ int64_t quotient(int64_t x, int64_t y) {
  if (((uint64_t)x | (uint64_t)y) >> 32 == 0) return (int64_t)((uint32_t)x / (uint32_t)y);
  return x / y;
}

__global__ void __launch_bounds__(WORD_THREADS)
window_words(const uint8_t* __restrict__ data, int64_t cap,
             const int32_t* __restrict__ starts, int64_t total, int64_t Wq,
             uint32_t* __restrict__ out) {
  const int64_t f = ((int64_t)blockIdx.x * WORD_THREADS + threadIdx.x) *
                    WORDS_PER_THREAD;
  if (f >= total) return;
  int64_t r = quotient(f, Wq);
  int64_t q = f - r * Wq;
  int64_t s = starts[r];
  uint32_t w[WORDS_PER_THREAD];
  const int64_t rel = s + 4 * q;
  const int mis = (int)(((uintptr_t)data + (uintptr_t)rel) & 3);
  const int64_t lo = rel - mis;
  if (q + WORDS_PER_THREAD <= Wq && lo >= 0 && lo + (mis ? 20 : 16) <= cap) {
    // the four words lie in one row, inside the buffer: five aligned
    // loads (four when the window is aligned)
    const uint32_t* p = (const uint32_t*)(data + lo);
    uint32_t a[WORDS_PER_THREAD + 1];
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i) a[i] = __ldg(p + i);
    a[WORDS_PER_THREAD] = mis ? __ldg(p + WORDS_PER_THREAD) : 0u;
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i)
      w[i] = __byte_perm(__funnelshift_r(a[i], a[i + 1], 8 * mis), 0, 0x0123);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i) {
      if (i > 0 && ++q == Wq) {
        q = 0;
        if (f + i < total) s = starts[++r];
      }
      w[i] = f + i < total ? be_word(data, cap, s + 4 * q) : 0u;
    }
  }
  if (f + WORDS_PER_THREAD <= total) {
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD; k += 4)
      *(uint4*)(out + f + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i)
      if (f + i < total) out[f + i] = w[i];
  }
}

unsigned grid_for(int64_t rows) {
  return (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

}  // namespace

extern "C" {

// out_int32: 0 -> uint8 output, 1 -> int32 output (one byte per element);
// lens: int32[rows] row lengths to mask at, or null for no mask
int cs_window_bytes(const void* data, int64_t cap, const void* starts,
                    const void* lens, int64_t rows, int64_t W, int out_int32,
                    void* out, void* stream) {
  if (rows <= 0 || W <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (out_int32) {
    window_bytes<int32_t><<<grid_for(rows), ROWS_PER_BLOCK * 32, 0, s>>>(
        (const uint8_t*)data, cap, (const int32_t*)starts,
        (const int32_t*)lens, rows, W, (int32_t*)out);
  } else {
    window_bytes<uint8_t><<<grid_for(rows), ROWS_PER_BLOCK * 32, 0, s>>>(
        (const uint8_t*)data, cap, (const int32_t*)starts,
        (const int32_t*)lens, rows, W, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

int cs_window_words(const void* data, int64_t cap, const void* starts,
                    int64_t rows, int64_t Wq, void* out, void* stream) {
  if (rows <= 0 || Wq <= 0) return (int)cudaGetLastError();
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int64_t total = rows * Wq;
  const int64_t per_block = (int64_t)WORD_THREADS * WORDS_PER_THREAD;
  window_words<<<(unsigned)((total + per_block - 1) / per_block), WORD_THREADS,
                 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, cap, (const int32_t*)starts, total, Wq,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
