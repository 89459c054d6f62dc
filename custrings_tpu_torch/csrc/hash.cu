// K6: MurmurHash3_32 with seed 31 of every row of a string column.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_hash.py::
// hash_rows_pallas (body _hash_kernel).  Reference semantics:
// custring.inl:164-231 -- little-endian 32-bit blocks, the tail of
// len & 3 bytes combined into one block, then the length and the fmix.
//
// The TPU version widens the padded [N, W4] byte view to uint32 (1.1 GB at
// 1M rows x 284 bytes) and packs the blocks and the tail outside its
// kernel, because Mosaic cannot slice bytes with a stride.  Here the rows
// are read where they lie in the flat buffer, data[offsets[r] ..
// offsets[r + 1]), and the block loop, the tail combine and the fmix run
// in one pass: no padded view, no widening, and the int64 result written
// straight from the kernel.
//
// Bound on the H100: device-memory bytes, each byte of the column read
// once plus 4 bytes of offsets and 8 of output per row (~155 MB at the
// 1M-row tweet corpus, ~0.046 ms); ~10 integer ops per 4-byte block.
//
// Design.  MurmurHash3's block chain is serial, so one thread hashes one
// row, a warp 32 consecutive rows (whose bytes lie back to back).  Each
// thread stages its row through its own slot of shared memory in steps of
// SEG bytes: PIECES 16-byte loads aligned down from the absolute address
// (the column's data may be a view at any offset) cover a step at any
// alignment, and the next step's pieces are loaded into registers while
// the current one is hashed out of the slot, each block read as two
// aligned 32-bit words and one __funnelshift_r.  h and the position carry
// from step to step, so a row of any length is right; a piece that
// reaches before the buffer or past cap is read byte by byte.  A warp's
// load instruction touches 32 rows ~136 bytes apart at the tweet corpus,
// 16 bytes each; on the H100 that beat the warp sharing each row's loads
// (coalesced, at the cost of two shuffles a piece and staging stores to
// other lanes' slots), and a contiguous window over a block's rows would
// leave most threads idle (a 4 KB window holds ~30 tweet rows).  The
// slots are 4 * PIECES + 1 words apart, an odd count, so lanes reading the
// same word of their slots hit distinct banks.  SEG and the block size are
// the fastest of those tried on the H100 (64 to 256 bytes, 64 to 256
// threads).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SEG = 128;                // bytes of a row hashed per step
constexpr int PIECES = SEG / 16 + 1;    // 16-byte pieces covering SEG at any alignment
constexpr int STRIDE = 4 * PIECES + 1;  // words of a row's slot
constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= C1;
  k1 = rotl(k1, 15);
  return k1 * C2;
}

// the 16 bytes data[pr .. pr + 16), data + pr 16-byte aligned; bytes
// outside [0, cap) are read as 0 and never touched
__device__ __forceinline__ uint4 load_piece(const uint8_t* __restrict__ data, int64_t cap,
                                            int64_t pr) {
  if (pr >= 0 && pr + 16 <= cap) return __ldg(reinterpret_cast<const uint4*>(data + pr));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t g = pr + i;
    if (g >= 0 && g < cap) w[i >> 2] |= (uint32_t)data[g] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the pieces of the step starting at byte `from` of a row ending at
// `end`: the 16-byte words from the one holding data + from (aligned
// down from the absolute address), up to the one holding end - 1
__device__ __forceinline__ void fetch(const uint8_t* __restrict__ data, int64_t cap,
                                      uint32_t from, uint32_t end, uint4 (&buf)[PIECES]) {
  const int64_t p0 = (int64_t)from - (int64_t)(((uintptr_t)data + from) & 15);
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    if (p0 + 16 * k < (int64_t)end) buf[k] = load_piece(data, cap, p0 + 16 * k);
  }
}

__device__ __forceinline__ void stage(const uint4 (&buf)[PIECES], uint32_t* __restrict__ slot) {
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    slot[4 * k] = buf[k].x;
    slot[4 * k + 1] = buf[k].y;
    slot[4 * k + 2] = buf[k].z;
    slot[4 * k + 3] = buf[k].w;
  }
}

__global__ void __launch_bounds__(THREADS)
hash_rows(const uint8_t* __restrict__ data, int64_t cap, const int32_t* __restrict__ offsets,
          int64_t n, int64_t* __restrict__ out) {
  __shared__ uint32_t slots[THREADS * STRIDE];
  uint32_t* mine = slots + threadIdx.x * STRIDE;
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const uint32_t a = (uint32_t)offsets[row];
  const uint32_t e = (uint32_t)offsets[row + 1];
  const uint32_t nbe = a + ((e - a) & ~3u);  // the end of the whole blocks
  uint32_t h = 31u;
  uint32_t w = a;  // this step's first byte; every block before it is hashed
  uint4 buf[PIECES] = {};
  fetch(data, cap, w, e, buf);
  while (true) {
    stage(buf, mine);
    const bool fin = e <= w + SEG;
    if (!fin) fetch(data, cap, w + SEG, e, buf);  // the next step's, while this one is hashed
    const uint32_t mis = (uint32_t)(((uintptr_t)data + w) & 15);
    const int sh = 8 * (int)(mis & 3);
    const int nblk = nbe > w ? (int)min((uint32_t)(SEG / 4), (nbe - w) >> 2) : 0;
    const int j = (int)(mis >> 2);
    uint32_t lo = mine[j];
    for (int b = 0; b < nblk; ++b) {
      const uint32_t hi = mine[j + b + 1];
      h ^= mix_k1(__funnelshift_r(lo, hi, sh));
      lo = hi;
      h = rotl(h, 13);
      h = h * 5u + 0xE6546B64u;
    }
    if (fin) break;
    w += SEG;
  }
  const uint32_t rem = e - nbe;
  if (rem) {
    const uint32_t off = (uint32_t)(((uintptr_t)data + w) & 15) + (nbe - w);
    const uint32_t t = __funnelshift_r(mine[off >> 2], mine[(off >> 2) + 1], 8 * (off & 3));
    h ^= mix_k1(t & ((1u << (8 * rem)) - 1u));
  }
  h ^= e - a;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  out[row] = (int64_t)h;
}

}  // namespace

extern "C" {

// data: uint8 [cap]; offsets: int32 [n + 1] into data; out: int64 [n],
// each value in [0, 2^32)
int cs_hash(const void* data, int64_t cap, const void* offsets, int64_t n, void* out,
            void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
  hash_rows<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, cap, (const int32_t*)offsets, n, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
