// K3: inclusive int32 prefix sum / prefix max over a 1-D array.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_scan.py::_scan_pallas
// (bodies _cumsum_kernel and _cummax_kernel, via cumsum_i32/cummax_i32).
// The TPU version walks the array as ONE sequential grid with the carry in
// SMEM scratch; Hopper's blocks run in parallel and in no order, so nothing
// can be carried from block to block.
//
// Bound on the H100: device-memory bytes.  The scan does ~1 add per
// element; the work is read N inputs (1 or 4 bytes), write N int32, then a
// second read+write of the int32 output to add the carries.  At the 1M-row
// tier the byte-domain scans run over ~10^8 elements.
//
// Design: the three-phase scan.
//   1. block_scan: each 256-thread block loads a 4096-element tile with
//      coalesced loads into shared memory, each thread scans 16 contiguous
//      elements serially, the thread totals are scanned with warp shuffles,
//      and the tile is written back coalesced; the tile total goes to
//      `partials`.
//   2. The partials are scanned by the same code, recursively, until one
//      block holds them all (4096^2 = 16.7M elements per two levels).
//   3. add_carry: every element of tile b > 0 is combined with the scanned
//      partial of tile b-1.
// The sum wraps modulo 2^32 (computed in uint32), as the TPU's int32
// arithmetic does; the max uses INT32_MIN as its identity, as the TPU
// kernel does.  The wrapper allocates the output and the partials.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // 4096
// one padding slot every 32 ints: a thread's 16 serial reads then spread
// over banks instead of hitting one bank 16 threads deep
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
constexpr int SMEM_INTS = TILE + TILE / 32;

struct Sum {
  static __device__ __forceinline__ int32_t identity() { return 0; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

struct Max {
  static __device__ __forceinline__ int32_t identity() { return INT_MIN; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
    return a > b ? a : b;
  }
};

template <typename Op, typename T>
__global__ void __launch_bounds__(THREADS)
block_scan(const T* in, int32_t* out, int64_t n, int32_t* partials) {
  // no __restrict__: the recursive levels scan the partials in place
  __shared__ int32_t tile[SMEM_INTS];
  __shared__ int32_t warp_tot[THREADS / 32];
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * TILE;

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + tid;
    const int64_t g = base + i;
    tile[pad(i)] = g < n ? (int32_t)in[g] : Op::identity();
  }
  __syncthreads();

  // serial inclusive scan of this thread's ITEMS contiguous elements
  int32_t acc = Op::identity();
  const int first = tid * ITEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    acc = Op::op(acc, tile[pad(first + k)]);
    tile[pad(first + k)] = acc;
  }

  // inclusive scan of the thread totals across the warp
  const int lane = tid & 31, warp = tid >> 5;
  int32_t x = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = Op::op(y, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < THREADS / 32 ? warp_tot[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < THREADS / 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = Op::op(y, w);
    }
    if (lane < THREADS / 32) warp_tot[lane] = w;
  }
  __syncthreads();

  // exclusive prefix of this thread = earlier warps + earlier lanes
  int32_t excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = Op::identity();
  if (warp > 0) excl = Op::op(warp_tot[warp - 1], excl);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    tile[pad(first + k)] = Op::op(excl, tile[pad(first + k)]);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + tid;
    const int64_t g = base + i;
    if (g < n) out[g] = tile[pad(i)];
  }
  if (partials != nullptr && tid == 0) {
    partials[blockIdx.x] = warp_tot[THREADS / 32 - 1];
  }
}

template <typename Op>
__global__ void __launch_bounds__(THREADS)
add_carry(int32_t* __restrict__ out, int64_t n,
          const int32_t* __restrict__ scanned_partials) {
  const int64_t tile_id = (int64_t)blockIdx.x + 1;
  const int32_t carry = scanned_partials[tile_id - 1];
  const int64_t base = tile_id * TILE;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t g = base + k * THREADS + threadIdx.x;
    if (g < n) out[g] = Op::op(carry, out[g]);
  }
}

int64_t n_tiles(int64_t n) { return (n + TILE - 1) / TILE; }

// scans int32 data already in `out` (in place) or typed `in` into `out`
template <typename Op, typename T>
void scan_level(const T* in, int32_t* out, int64_t n, int32_t* scratch,
                cudaStream_t stream) {
  const int64_t nb = n_tiles(n);
  if (nb <= 1) {
    block_scan<Op, T><<<1, THREADS, 0, stream>>>(in, out, n, nullptr);
    return;
  }
  int32_t* partials = scratch;
  block_scan<Op, T><<<(unsigned)nb, THREADS, 0, stream>>>(in, out, n, partials);
  scan_level<Op, int32_t>(partials, partials, nb, scratch + nb, stream);
  add_carry<Op><<<(unsigned)(nb - 1), THREADS, 0, stream>>>(out, n, partials);
}

template <typename Op>
void scan_dispatch(const void* in, int dtype, int32_t* out, int64_t n,
                   int32_t* scratch, cudaStream_t s) {
  switch (dtype) {
    case 0: scan_level<Op, uint8_t>((const uint8_t*)in, out, n, scratch, s); break;
    case 1: scan_level<Op, int8_t>((const int8_t*)in, out, n, scratch, s); break;
    default: scan_level<Op, int32_t>((const int32_t*)in, out, n, scratch, s); break;
  }
}

}  // namespace

extern "C" {

// int32 elements of scratch the recursive partials need for n inputs
int64_t cs_scan_scratch_elems(int64_t n) {
  int64_t total = 0;
  int64_t nb = n_tiles(n);
  while (nb > 1) {
    total += nb;
    nb = n_tiles(nb);
  }
  return total;
}

// dtype: 0 = uint8 (and bool), 1 = int8, 2 = int32.  op: 0 = sum, 1 = max.
int cs_scan(const void* in, int dtype, void* out, int64_t n, int op,
            void* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    scan_dispatch<Sum>(in, dtype, (int32_t*)out, n, (int32_t*)scratch, s);
  } else {
    scan_dispatch<Max>(in, dtype, (int32_t*)out, n, (int32_t*)scratch, s);
  }
  return (int)cudaGetLastError();
}

const char* cs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
