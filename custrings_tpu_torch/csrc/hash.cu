// K6: MurmurHash3_32 with seed 31 of every row of a string column.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_hash.py::
// hash_rows_pallas (body _hash_kernel).  Reference semantics:
// custring.inl:164-231 -- little-endian 32-bit blocks, the tail of
// len & 3 bytes combined into one block, then the length and the fmix.
//
// The TPU version widens the padded [N, W4] byte view to uint32 (1.1 GB at
// 1M rows x 284 bytes) and packs the blocks and the tail outside its
// kernel, because Mosaic cannot slice bytes with a stride.  Here one
// thread per row reads the row's bytes straight from the flat buffer,
// data[offsets[r] .. offsets[r + 1]), and does the block loop, the tail
// combine and the fmix in one pass: no padded view, no widening.
//
// Bound on the H100: device-memory bytes, each byte of the column read
// once plus 4 bytes of offsets and 4 of output per row (~151 MB at the
// 1M-row tweet corpus, ~0.05 ms); the ops are ~10 integer ops per 4-byte
// block.  A warp's 32 rows lie back to back, so its byte loads fall on
// neighbouring sectors that L1 serves to the next blocks of each row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__global__ void __launch_bounds__(THREADS)
hash_rows(const uint8_t* __restrict__ data, const int32_t* __restrict__ offsets,
          int64_t n, uint32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const int64_t a = offsets[row];
  const uint32_t len = (uint32_t)(offsets[row + 1] - a);
  const uint8_t* p = data + a;
  uint32_t h = 31u;
  const uint32_t nb = len >> 2;
  for (uint32_t k = 0; k < nb; ++k) {
    const uint8_t* q = p + 4 * k;
    uint32_t k1 = (uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                  ((uint32_t)q[2] << 16) | ((uint32_t)q[3] << 24);
    k1 *= C1;
    k1 = rotl(k1, 15);
    k1 *= C2;
    h ^= k1;
    h = rotl(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  const uint8_t* t = p + 4 * nb;
  const uint32_t rem = len & 3u;
  uint32_t k1 = 0u;
  if (rem >= 3) k1 ^= (uint32_t)t[2] << 16;
  if (rem >= 2) k1 ^= (uint32_t)t[1] << 8;
  if (rem >= 1) {
    k1 ^= (uint32_t)t[0];
    k1 *= C1;
    k1 = rotl(k1, 15);
    k1 *= C2;
    h ^= k1;
  }
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  out[row] = h;
}

}  // namespace

extern "C" {

// data: uint8 [capacity]; offsets: int32 [n + 1]; out: uint32 [n]
int cs_hash(const void* data, const void* offsets, int64_t n, void* out,
            void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
  hash_rows<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)offsets, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
