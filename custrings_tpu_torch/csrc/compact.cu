// K7: stable compaction of a byte buffer by a keep mask, by output tile.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_compact.py::_compact_p
// (body _compact_kernel, via compact_bytes):
//   out[k0[j]] = data[j] for every kept j with k0[j] < out_cap, zeros
//   after the kept bytes, where k0 is the exclusive prefix count of keep
//   (K3, computed by the wrapper as compact_bytes does).
//
// The TPU version grids over output tiles of TB = 2048 bytes, DMAs a fixed
// WIN = 4096-byte input window per tile and moves each kept byte left with
// log2(WIN) roll + select rounds over four byte planes; a tile whose
// dropped bytes overflow the window falls back to an XLA scatter under a
// lax.cond.  Here each block owns one output tile of TB bytes: thread 0
// finds the first input byte that feeds the tile by a binary search in k0
// (as srclo is found by searchsorted, pallas_compact.py:228-233), the
// block walks the input window from there, 256 bytes a step, placing each
// kept byte at k0[j] - TB * tile in a shared-memory tile, until k0 passes
// the tile's end, then writes the tile with one coalesced store of words.
// A block loops over a window of any length, so there is no overflow test
// and one route for every out_cap.  This is the gather-by-output-tile
// form; K4c (route.cu) is one scatter per element.
//
// Bound on the H100: device-memory bytes: data (1 B), keep (1 B) and k0
// (4 B) per input byte, and the out_cap output bytes written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TB = 2048;

__global__ void __launch_bounds__(THREADS)
compact_bytes(const uint8_t* __restrict__ data, const uint8_t* __restrict__ keep,
              const int32_t* __restrict__ k0, int64_t cap, int64_t out_cap,
              uint8_t* __restrict__ out) {
  __shared__ uint32_t tile32[TB / 4];
  __shared__ int64_t first;
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile32);
  const int64_t lo = (int64_t)blockIdx.x * TB;
  const int64_t hi = lo + TB < out_cap ? lo + TB : out_cap;
  for (int i = threadIdx.x; i < TB / 4; i += THREADS) tile32[i] = 0u;
  if (threadIdx.x == 0) {  // the first j in [0, cap] with k0[j] >= lo
    int64_t a = 0, b = cap;
    while (a < b) {
      const int64_t m = (a + b) >> 1;
      if ((int64_t)k0[m] < lo) a = m + 1; else b = m;
    }
    first = a;
  }
  __syncthreads();
  for (int64_t base = first; base < cap; base += THREADS) {
    if ((int64_t)k0[base] >= hi) break;  // the same test in every thread
    const int64_t j = base + threadIdx.x;
    if (j < cap && keep[j]) {
      const int64_t t = k0[j];
      if (t < hi) tile[t - lo] = data[j];
    }
  }
  __syncthreads();
  if (hi - lo == TB) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out + lo);
    for (int i = threadIdx.x; i < TB / 4; i += THREADS) o[i] = tile32[i];
  } else {
    for (int64_t i = threadIdx.x; i < hi - lo; i += THREADS) out[lo + i] = tile[i];
  }
}

}  // namespace

extern "C" {

// data, keep: uint8 [cap]; k0: int32 [cap + 1]; out: uint8 [out_cap],
// 4-byte aligned (every byte is written)
int cs_compact_bytes(const void* data, const void* keep, const void* k0,
                     int64_t cap, int64_t out_cap, void* out, void* stream) {
  if (out_cap <= 0) return (int)cudaGetLastError();
  if (cap < 0 || ((uintptr_t)out & 3u) != 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((out_cap + TB - 1) / TB);
  compact_bytes<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)keep, (const int32_t*)k0, cap,
      out_cap, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
