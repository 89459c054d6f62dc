// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016): the status words through which the
// tiles of one launch pass their aggregates and inclusive prefixes, and
// the warp-wide look-back over them.  Used by K3 (scan.cu), K7
// (compact.cu) and K4c (route.cu); the last two also share the byte-mask
// test and the zero tail below.
//
// A tile's status word holds a flag in its high 32 bits (0: nothing yet,
// 1: the tile's aggregate, 2: its inclusive prefix) and the 32-bit value
// in its low bits, so a reader never sees one without the other.  The
// caller zeroes the status words before every launch, and hands tile ids
// out in order from an atomic counter (not blockIdx: blocks start in no
// order, and spinning on a predecessor that is not resident would
// deadlock; a tile handed out earlier belongs to a block already running).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_INCLUSIVE = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// the wrapping int32 sum (computed in uint32, as the TPU's int32
// arithmetic wraps), the op of K3's sums and of K7's counts
struct Sum {
  static __device__ __forceinline__ int32_t identity() { return 0; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

__device__ __forceinline__ unsigned long long pack(unsigned long long flag, int32_t v) {
  return flag | (unsigned long long)(uint32_t)v;
}

// warp 0 of tile `tile`: the op of every tile before it.  Waits in each
// window of 32 predecessors only on those up to the nearest inclusive
// prefix, and folds their aggregates.
template <typename Op>
__device__ __forceinline__ int32_t look_back(const unsigned long long* status, int64_t tile,
                                             int lane) {
  int32_t excl = Op::identity();
  int64_t pred = tile - 1 - lane;  // lane 0 looks at the nearest predecessor
  while (true) {
    unsigned long long st;
    unsigned inclusive;
    while (true) {
      st = pred >= 0 ? load_status(status + pred) : pack(FLAG_INCLUSIVE, Op::identity());
      inclusive = __ballot_sync(FULL, (st >> 32) == 2);
      const unsigned invalid = __ballot_sync(FULL, (st >> 32) == 0);
      const unsigned upto = inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1u : FULL;
      if ((invalid & upto) == 0) break;
    }
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int32_t c = lane <= stop ? (int32_t)(uint32_t)st : Op::identity();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c = Op::op(c, __shfl_xor_sync(FULL, c, d));
    excl = Op::op(excl, c);
    if (inclusive) return excl;
    pred -= 32;
  }
}

// warp 0 of tile `tile`, all lanes: publish the tile's aggregate, look
// back, publish its inclusive prefix; returns the exclusive prefix
template <typename Op>
__device__ __forceinline__ int32_t publish_and_look_back(unsigned long long* status,
                                                         int64_t tile, int32_t aggregate,
                                                         int lane) {
  if (tile == 0) {
    if (lane == 0) store_status(status, pack(FLAG_INCLUSIVE, aggregate));
    return Op::identity();
  }
  if (lane == 0) store_status(status + tile, pack(FLAG_AGGREGATE, aggregate));
  const int32_t excl = look_back<Op>(status, tile, lane);
  if (lane == 0) store_status(status + tile, pack(FLAG_INCLUSIVE, Op::op(excl, aggregate)));
  return excl;
}

// bits 0..3: which of the word's four bytes are nonzero
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t w) {
  const uint32_t m = __vcmpne4(w, 0u);  // 0xff per nonzero byte
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// bit i set where byte i of the 16 is nonzero
__device__ __forceinline__ uint32_t nonzero_bits16(const uint4& q) {
  return nonzero_bits(q.x) | nonzero_bits(q.y) << 4 | nonzero_bits(q.z) << 8 | nonzero_bits(q.w) << 12;
}

// zero out[lo, hi) (bytes) with the zero blocks z of nz, the blocks whose
// ticket comes after the last tile: aligned 16-byte stores over the body,
// shared by all of them; byte stores at the ends by the first
template <int THREADS>
__device__ __forceinline__ void zero_tail(uint8_t* __restrict__ out, int64_t lo, int64_t hi,
                                          int64_t z, int64_t nz, int tid) {
  if (lo >= hi) return;
  const int64_t a16 = lo + (int64_t)((16 - ((uintptr_t)(out + lo) & 15)) & 15);
  const int64_t b16 = hi - (int64_t)((uintptr_t)(out + hi) & 15);
  if (a16 >= b16) {
    if (z == 0) for (int64_t q = lo + tid; q < hi; q += THREADS) out[q] = 0;
    return;
  }
  if (z == 0) {
    if (lo + tid < a16) out[lo + tid] = 0;
    if (b16 + tid < hi) out[b16 + tid] = 0;
  }
  uint4* body = reinterpret_cast<uint4*>(out + a16);
  const int64_t words = (b16 - a16) >> 4;
  for (int64_t i = z * THREADS + tid; i < words; i += nz * THREADS) body[i] = make_uint4(0, 0, 0, 0);
}

}  // namespace lookback
