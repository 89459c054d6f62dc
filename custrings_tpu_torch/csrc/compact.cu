// K7: stable compaction of a byte buffer by a keep mask, in one pass.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_compact.py::_compact_p
// (body _compact_kernel, via compact_bytes):
//   out[k0[j]] = data[j] for every kept j with k0[j] < out_cap, zeros
//   after the kept bytes, where k0 is the exclusive prefix count of keep.
//
// The TPU version takes k0 from a K3 scan over the whole capacity, grids
// over output tiles of 2,048 bytes, DMAs a fixed 4,096-byte input window
// per tile and moves each kept byte left with log2(WIN) roll + select
// rounds; a tile whose dropped bytes overflow the window falls back to an
// XLA scatter.  Here the prefix count never leaves the kernel: it is a
// single pass over input tiles with decoupled look-back (lookback.cuh, as
// K3 runs it), so no capacity-sized int32 plane is written or read.
//
// Bound on the H100: device-memory bytes: data and keep read once (2 B an
// input byte) and the out_cap output bytes written once.
//
// Design:
//   - each 256-thread block takes an 8,192-byte input tile id from an
//     atomic counter; tiles are cut in the data's absolute address space
//     (tile t holds the bytes at addresses [t, t + 1) * TILE from the
//     aligned address below data), so a thread's 32 bytes of data are
//     two 16-byte loads at any view offset, and of keep too when keep has
//     the same offset mod 16; otherwise, and in the first and last tile,
//     a thread loads its bytes one by one;
//   - each thread turns its keep bytes into a 32-bit mask (nonzero is
//     kept), counts it, the block scans the counts, and warp 0 takes the
//     tile's exclusive offset from the look-back;
//   - the threads place their kept bytes in order in shared memory,
//     shifted by the output run's address mod 16, so the run
//     [excl, excl + count), clipped to out_cap, goes out as aligned
//     16-byte stores with byte stores at its two ends; runs of different
//     tiles are disjoint, so every output byte has one writer;
//   - the blocks whose ticket comes after the last tile zero the tail
//     [total, out_cap): they wait for the last tile's inclusive prefix
//     (the total), which cannot deadlock since every tile was handed out
//     before them, then store zeros over their share of the tail.
// The caller zeroes the counter and the status words before every call
// (`cs_compact_bytes_scratch_words` int64 words); nothing survives from
// one call to the next.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 32;
constexpr int TILE = THREADS * ITEMS;  // 8192
// tail bytes a zero block stores per step, and the most zero blocks
constexpr int ZSTEP = THREADS * 16;
constexpr int64_t ZBLOCKS = 264;
using lookback::FULL;
using lookback::Sum;
using lookback::nonzero_bits;

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

__global__ void __launch_bounds__(THREADS)
compact_tiles(const uint8_t* __restrict__ data, const uint8_t* __restrict__ keep, int64_t cap,
              int64_t out_cap, uint8_t* __restrict__ out, int64_t ntiles, int64_t nz,
              unsigned int* __restrict__ counter, unsigned long long* __restrict__ status) {
  __shared__ uint4 packed[TILE / 16 + 1];
  __shared__ int32_t warp_incl[WARPS];
  __shared__ int64_t block_excl;
  __shared__ unsigned int tile_id;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = tile_id;

  if (tile >= ntiles) {  // a zero block: wait for the total, zero the tail
    if (tid == 0) {
      uint32_t total = 0;
      if (ntiles > 0) {
        unsigned long long st;
        while (((st = lookback::load_status(status + ntiles - 1)) >> 32) != 2) __nanosleep(100);
        total = (uint32_t)st;
      }
      block_excl = total;
    }
    __syncthreads();
    lookback::zero_tail<THREADS>(out, block_excl < out_cap ? block_excl : out_cap, out_cap, tile - ntiles, nz, tid);
    return;
  }

  // this thread's 32 bytes: data[j0, j0 + 32), j0 = its first byte
  const int shift = (int)((uintptr_t)data & 15);
  const int64_t j0 = tile * TILE + (int64_t)tid * ITEMS - shift;
  uint4 d[2];
  uint32_t mask = 0;
  if (j0 >= 0 && j0 + ITEMS <= cap && ((uintptr_t)keep & 15) == (uintptr_t)shift) {
    const uint4* dp = reinterpret_cast<const uint4*>(data + j0);
    const uint4* kp = reinterpret_cast<const uint4*>(keep + j0);
    d[0] = __ldg(dp);
    d[1] = __ldg(dp + 1);
    const uint4 k0 = __ldg(kp), k1 = __ldg(kp + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mask |= nonzero_bits(word_of(k0, i)) << (4 * i);
      mask |= nonzero_bits(word_of(k1, i)) << (16 + 4 * i);
    }
  } else {
    uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t j = j0 + k;
      if (j >= 0 && j < cap && keep[j]) {
        mask |= 1u << k;
        w[k >> 2] |= (uint32_t)data[j] << (8 * (k & 3));
      }
    }
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }

  // the counts across the warp, then the warps, then the tiles before
  const int32_t c = __popc(mask);
  int32_t x = c;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t v = lane < WARPS ? warp_incl[lane] : 0;
#pragma unroll
    for (int s = 1; s < WARPS; s <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, v, s);
      if (lane >= s) v += y;
    }
    if (lane < WARPS) warp_incl[lane] = v;
    const int32_t aggregate = __shfl_sync(FULL, v, WARPS - 1);
    const int32_t excl = lookback::publish_and_look_back<Sum>(status, tile, aggregate, lane);
    if (lane == 0) block_excl = (int64_t)(uint32_t)excl;
  }
  __syncthreads();
  const int64_t lo = block_excl;
  const int32_t count = warp_incl[WARPS - 1];
  const int mis = (int)((uintptr_t)(out + lo) & 15);

  // place the kept bytes in order, output byte lo + i at packed byte mis + i
  uint8_t* pk = reinterpret_cast<uint8_t*>(packed);
  int pos = mis + (warp > 0 ? warp_incl[warp - 1] : 0) + (x - c);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if ((mask >> k) & 1u) {
      pk[pos++] = (uint8_t)(word_of(d[k >> 4], (k >> 2) & 3) >> (8 * (k & 3)));
    }
  }
  __syncthreads();

  // the run [lo, hi): byte stores up to the first 16-byte boundary and
  // from the last, 16-byte stores between
  const int64_t hi = lo + count < out_cap ? lo + count : out_cap;
  if (lo >= hi) return;
  const int64_t a16 = lo + ((16 - mis) & 15);
  const int64_t b16 = hi - (int64_t)((uintptr_t)(out + hi) & 15);
  if (a16 >= b16) {
    for (int64_t q = lo + tid; q < hi; q += THREADS) out[q] = pk[q - lo + mis];
    return;
  }
  if (lo + tid < a16) out[lo + tid] = pk[tid + mis];
  if (b16 + tid < hi) out[b16 + tid] = pk[b16 - lo + mis + tid];
  uint4* body = reinterpret_cast<uint4*>(out + a16);
  const uint4* src = packed + (mis ? 1 : 0);
  const int words = (int)((b16 - a16) >> 4);
  for (int i = tid; i < words; i += THREADS) body[i] = src[i];
}

int64_t tiles_for(const void* data, int64_t cap) {
  return cap > 0 ? (cap + (int64_t)((uintptr_t)data & 15) + TILE - 1) / TILE : 0;
}

}  // namespace

extern "C" {

// int64 words of zeroed scratch a compaction of cap bytes needs: the tile
// counter, then one status word per tile (at any offset of data mod 16)
int64_t cs_compact_bytes_scratch_words(int64_t cap) { return 1 + (cap + 15 + TILE - 1) / TILE; }

// data, keep: uint8 [cap] (keep nonzero = kept); out: uint8 [out_cap],
// every byte of it written; scratch: cs_compact_bytes_scratch_words(cap)
// int64 words, all 0
int cs_compact_bytes(const void* data, const void* keep, int64_t cap, int64_t out_cap,
                     void* out, void* scratch, void* stream) {
  if (out_cap <= 0) return (int)cudaGetLastError();
  if (cap < 0 || cap >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = tiles_for(data, cap);
  int64_t nz = (out_cap + ZSTEP - 1) / ZSTEP;
  nz = nz < ZBLOCKS ? nz : ZBLOCKS;
  compact_tiles<<<(unsigned)(ntiles + nz), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)keep, cap, out_cap, (uint8_t*)out, ntiles, nz,
      (unsigned int*)scratch, (unsigned long long*)scratch + 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
