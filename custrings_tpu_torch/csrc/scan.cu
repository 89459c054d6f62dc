// K3: int32 prefix sum / prefix max over a 1-D array, in one pass.
//
// Replaces the TPU kernel custrings_tpu/ops/pallas_scan.py::_scan_pallas
// (bodies _cumsum_kernel and _cummax_kernel, via cumsum_i32/cummax_i32 and
// column.cumsum0).  The TPU version walks the array as ONE sequential grid
// with the carry in SMEM scratch; Hopper's blocks run in parallel and in
// no order, so a tile cannot simply take its carry from the tile before.
//
//   inclusive:  out[i]     = x[0] op ... op x[i],   i < n
//   shifted:    out[0] = 0, out[i + 1] = the same,  i < n  (cumsum0)
//   then each stored value v becomes clamp(v + add, lo, hi) (wrapping
//   add; row_ids_from_offsets' "- 1" and clamp; identity by default)
//
// Bound on the H100: device-memory bytes.  The function reads n inputs and
// writes n int32 outputs: 5 bytes an element for uint8/bool/int8 input, 8
// for int32.  ~1 op an element is far under the op rate.
//
// Design: a single pass with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).  The
// three-phase scan this replaces (block scans, a recursive scan of the
// block totals, then a carry pass) read and wrote the whole int32 output a
// second time: 13 bytes an element for uint8 input instead of 5, in 3+
// launches.  Here every element is read once and written once:
//   - each 256-thread block takes an 8192-element tile id from an atomic
//     counter (not blockIdx: blocks start in no order, and spinning on a
//     predecessor that is not resident would deadlock; a tile handed out
//     earlier belongs to a block already running);
//   - each thread loads its 32 contiguous elements straight into registers
//     with 16-byte loads, neighbouring threads on neighbouring addresses
//     (element by element for the last tile and for an input that is not
//     16-byte aligned), scans them serially, and the warps and the block
//     combine their totals with shuffles;
//   - the block publishes its aggregate in its 64-bit status word (flag and
//     32-bit value in one store, so a reader never sees one without the
//     other), then warp 0 looks back over 32 predecessors at a time
//     (lookback.cuh), waiting only on those up to the nearest inclusive
//     prefix, folding their aggregates, and publishes its own inclusive
//     prefix;
//   - the results go out through shared memory with 16-byte stores
//     (scalar for the unaligned head and tail: out[1:] of cumsum0 is 4
//     bytes off), so the output is written coalesced.
// The tile size and the 4 blocks an SM (64 registers a thread) are the
// fastest of the shapes measured on the H100 (PERF.md); a block that keeps
// its tile in registers while it looks back is what bounds the blocks in
// flight.  The sum wraps modulo 2^32 (computed in uint32), as the TPU's
// int32 arithmetic does; the max uses INT32_MIN as its identity, as the
// TPU kernel does; int8 input is sign-extended.  The wrapper zeroes the
// tile counter and the status words (one int64 each,
// `cs_scan_scratch_words`) before every call, so nothing survives from one
// call to the next; the kernel allocates nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 32;
constexpr int TILE = THREADS * ITEMS;  // 8192
// blocks an SM must hold at once: caps a thread at 64 registers
constexpr int MIN_BLOCKS = 4;
constexpr int QUADS = TILE / 4;
// one padding quad every 8 quads: the quads a thread writes and the quads
// 8 neighbouring threads read then fall on distinct bank groups
constexpr int QSLOTS = QUADS + QUADS / 8;
using lookback::FULL;
using lookback::Sum;

struct Max {
  static __device__ __forceinline__ int32_t identity() { return INT_MIN; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
    return a > b ? a : b;
  }
};

// the tile in shared memory, element j in lane j % 4 of quad j / 4
struct Tile {
  int4 q[QSLOTS];
  static __device__ __forceinline__ int slot(int quad) { return quad + (quad >> 3); }
  __device__ __forceinline__ int32_t& at(int j) {
    return reinterpret_cast<int32_t*>(&q[slot(j >> 2)])[j & 3];
  }
  __device__ __forceinline__ int4& quad(int k) { return q[slot(k)]; }
};

// one thread's ITEMS inputs of a tile, as the 16-byte words it loaded
template <typename T>
struct Raw {
  static constexpr int WORDS = ITEMS * (int)sizeof(T) / 16;
  uint4 w[WORDS];
};

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// issue the loads of the thread's ITEMS contiguous inputs of `tile` when
// the tile is whole and the input 16-byte aligned (neighbouring threads
// on neighbouring 16-byte words); false, and nothing loaded, otherwise
template <typename T>
__device__ __forceinline__ bool fetch(const T* __restrict__ in, int64_t n, int64_t tile,
                                      bool aligned, int tid, Raw<T>& r) {
  const int64_t g = tile * TILE;
  if (!aligned || g + TILE > n) return false;
  const uint4* p = reinterpret_cast<const uint4*>(in + g) + tid * Raw<T>::WORDS;
#pragma unroll
  for (int m = 0; m < Raw<T>::WORDS; ++m) r.w[m] = __ldg(p + m);
  return true;
}

// the thread's ITEMS inputs as int32: from the fetched words, or loaded
// one by one (the last tile, an unaligned input); 0 past n, which reaches
// no stored value and only the last tile's aggregate, which no tile reads
template <typename T>
__device__ __forceinline__ void unpack(const T* __restrict__ in, int64_t n, int64_t tile,
                                       bool whole, const Raw<T>& r, int tid,
                                       int32_t (&v)[ITEMS]) {
  if (whole) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if constexpr (sizeof(T) == 1) {
        const uint32_t b = (word_of(r.w[k >> 4], (k >> 2) & 3) >> (8 * (k & 3))) & 0xffu;
        v[k] = (int32_t)(T)b;
      } else {
        v[k] = (int32_t)word_of(r.w[k >> 2], k & 3);
      }
    }
  } else {
    const int64_t g = tile * TILE + (int64_t)tid * ITEMS;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) v[k] = g + k < n ? (int32_t)in[g + k] : 0;
  }
}

// the tile's first cnt elements to out[o0 ..)
__device__ __forceinline__ void store_tile(int32_t* __restrict__ out, int64_t o0, int cnt,
                                           Tile& s, int tid) {
  int32_t* p = out + o0;
  // the int32s before p's next 16-byte boundary
  const int head = min((int)((16 - ((uintptr_t)p & 15)) & 15) >> 2, cnt);
  const int body = (cnt - head) >> 2;
  if (tid < head) p[tid] = s.at(tid);
  int4* pv = reinterpret_cast<int4*>(p + head);
  if (head == 0) {
    for (int i = tid; i < body; i += THREADS) pv[i] = s.quad(i);
  } else {
    for (int i = tid; i < body; i += THREADS) {
      const int j = head + 4 * i;
      pv[i] = make_int4(s.at(j), s.at(j + 1), s.at(j + 2), s.at(j + 3));
    }
  }
  for (int j = head + 4 * body + tid; j < cnt; j += THREADS) p[j] = s.at(j);
}

template <typename Op, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scan_tiles(const T* __restrict__ in, int32_t* __restrict__ out, int64_t n, int shift,
           int32_t add, int32_t lo, int32_t hi, unsigned int* __restrict__ counter,
           unsigned long long* __restrict__ status) {
  __shared__ Tile s;
  __shared__ int32_t warp_incl[WARPS];
  __shared__ int32_t block_excl;
  __shared__ unsigned int tile_id;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t g0 = tile * TILE;
  const int cnt = n - g0 < TILE ? (int)(n - g0) : TILE;

  // this thread's ITEMS contiguous elements, scanned serially
  int32_t v[ITEMS];
  {
    Raw<T> r;
    const bool whole = fetch(in, n, tile, ((uintptr_t)in & 15) == 0, tid, r);
    unpack(in, n, tile, whole, r, tid, v);
  }
#pragma unroll
  for (int k = 1; k < ITEMS; ++k) v[k] = Op::op(v[k - 1], v[k]);

  // the thread totals across the warp, then the warp totals
  int32_t x = v[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = Op::op(y, x);
  }
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();

  if (warp == 0) {
    int32_t w = lane < WARPS ? warp_incl[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = Op::op(y, w);
    }
    if (lane < WARPS) warp_incl[lane] = w;
    const int32_t aggregate = __shfl_sync(FULL, w, WARPS - 1);
    const int32_t excl = lookback::publish_and_look_back<Op>(status, tile, aggregate, lane);
    if (lane == 0) block_excl = excl;
  }
  __syncthreads();

  // exclusive prefix of this thread = earlier tiles, warps and lanes
  int32_t lane_excl = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) lane_excl = Op::identity();
  int32_t pre = block_excl;
  if (warp > 0) pre = Op::op(pre, warp_incl[warp - 1]);
  pre = Op::op(pre, lane_excl);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int32_t r = (int32_t)((uint32_t)Op::op(pre, v[k]) + (uint32_t)add);
    v[k] = max(lo, min(hi, r));
  }
#pragma unroll
  for (int m = 0; m < ITEMS / 4; ++m) {
    s.quad(tid * (ITEMS / 4) + m) = make_int4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
  __syncthreads();

  if (shift && tile == 0 && tid == 0) out[0] = 0;
  store_tile(out, g0 + shift, cnt, s, tid);
}

template <typename Op, typename T>
void launch(const void* in, int32_t* out, int64_t n, int shift, int32_t add, int32_t lo,
            int32_t hi, void* scratch, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((n + TILE - 1) / TILE);
  scan_tiles<Op, T><<<tiles, THREADS, 0, stream>>>(
      (const T*)in, out, n, shift, add, lo, hi, (unsigned int*)scratch,
      (unsigned long long*)scratch + 1);
}

template <typename Op>
void dispatch(const void* in, int dtype, int32_t* out, int64_t n, int shift, int32_t add,
              int32_t lo, int32_t hi, void* scratch, cudaStream_t s) {
  switch (dtype) {
    case 0: launch<Op, uint8_t>(in, out, n, shift, add, lo, hi, scratch, s); break;
    case 1: launch<Op, int8_t>(in, out, n, shift, add, lo, hi, scratch, s); break;
    default: launch<Op, int32_t>(in, out, n, shift, add, lo, hi, scratch, s); break;
  }
}

}  // namespace

extern "C" {

// int64 words of zeroed scratch a scan of n elements needs: the tile
// counter, then one status word per tile
int64_t cs_scan_scratch_words(int64_t n) { return 1 + (n + TILE - 1) / TILE; }

// dtype: 0 = uint8 (and bool), 1 = int8, 2 = int32.  op: 0 = sum, 1 = max.
// shift: 0 -> out[i] (n outputs), 1 -> out[0] = 0 and out[i + 1] (n + 1).
// Each stored scan value v becomes clamp(v + add, lo, hi).
int cs_scan(const void* in, int dtype, void* out, int64_t n, int op, int shift, int add,
            int lo, int hi, void* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    dispatch<Sum>(in, dtype, (int32_t*)out, n, shift, add, lo, hi, scratch, s);
  } else {
    dispatch<Max>(in, dtype, (int32_t*)out, n, shift, add, lo, hi, scratch, s);
  }
  return (int)cudaGetLastError();
}

const char* cs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
