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
// Design: one warp per row, eight rows per 256-thread block.  In the
// bytes form each lane moves one byte per step, so a warp reads 32
// consecutive input bytes and writes 32 consecutive outputs per step:
// coalesced on both sides however the row start is aligned.  In the words
// form each lane assembles one output word from four byte loads.  This is
// the simple first version: aligned 16-byte loads with register shifts
// are the next step if the gather shows up in the profile.

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

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
window_words(const uint8_t* __restrict__ data, int64_t cap,
             const int32_t* __restrict__ starts, int64_t rows, int64_t Wq,
             uint32_t* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t s = starts[r];
  uint32_t* o = out + r * Wq;
  for (int64_t q = lane; q < Wq; q += 32) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t g = s + 4 * q + i;
      const uint32_t b = (g >= 0 && g < cap) ? (uint32_t)data[g] : 0u;
      w |= b << (24 - 8 * i);
    }
    o[q] = w;
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
  window_words<<<grid_for(rows), ROWS_PER_BLOCK * 32, 0,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)data, cap, (const int32_t*)starts, rows, Wq,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
