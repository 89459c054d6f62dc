// K4c / K4e: stable stream compaction and monotone stream expansion of
// flat planes (uint8, int32 or int64 elements; bool as uint8).
//
// Replaces the TPU kernels custrings_tpu/ops/pallas_route.py::_compact_p
// (body _compact_kernel_factory, via compact_stream) and ::_expand_p (body
// _expand_kernel_factory, via expand_stream).
//
//   compact: out[k0[j]] = in[j] for every kept j of every plane, zeros
//            from k0[n] on, where k0 is the exclusive prefix count of keep
//            (int32[n + 1], the total at k0[n])
//   expand:  out[j + dist[j]] = in[j] for every live j whose target lies
//            in [0, out_cap); placed[t] = 1 where a value landed; zeros
//            elsewhere
//
// Bound on the H100: device-memory bytes.  Compaction reads keep (1 B an
// element) and the kept elements of every plane, writes every output
// element, and reads k0 at the tile starts when the caller gives it or
// writes it (4 B an element) when the caller wants it; expansion reads
// live (1 B), and dist (4 B) and the element of each live lane, and writes
// the element and a placed byte.  At the 1M-row tier both run over the
// 167,772,160-byte capacity.
//
// The TPU version routes each 64K-element tile through log2(T) roll+select
// rounds in registers and stitches tiles through a VMEM ring buffer,
// because the TPU has no fast scatter and its grid runs in order; it takes
// each tile's output offset from k0, a K3 scan over the whole input.
//
// Compaction, one pass over 32,768-element input tiles (K7's design, for
// planes of 1, 4 and 8 bytes):
//   * each 256-thread block takes a tile from an atomic counter (tiles
//     handed out in order, as the look-back needs), or its blockIdx when
//     the caller gives k0;
//   * each thread reads its 32 keep bytes of each of the tile's four
//     8,192-element sub-tiles (two 16-byte loads where keep is aligned and
//     the sub-tile whole, byte loads otherwise) into a 32-bit mask, the
//     block scans the counts (a warp scan per sub-tile, then warp 0 over
//     the 32 (sub-tile, warp) sums), and warp 0 takes the tile's
//     exclusive offset from the decoupled look-back (lookback.cuh), or
//     reads it from k0[tile start] when the caller gives k0;
//   * warp 0 takes the offset while the other warps already stage the
//     first sub-tile's first plane: a kept element's place in the staging
//     buffer is its rank in the sub-tile, which does not depend on it;
//   * then sub-tile by sub-tile, every plane in the same launch: the
//     sub-tile is read with coalesced 16-byte loads where its address is
//     aligned (element loads otherwise, and in the last sub-tile), each
//     kept element is placed at its rank in shared memory, and the run
//     [excl, excl + count) goes out as aligned 16-byte stores, each
//     assembled from the staged words by a funnel shift, with element
//     stores at its two ends; runs of different sub-tiles are disjoint,
//     so every output element has one writer; when the caller wants k0,
//     the block writes its part of it (16-byte stores; the last tile the
//     total at k0[n]): K3's cumsum0 fused in;
//   * the blocks whose ticket comes after the last tile zero every plane's
//     tail [total, n): they read the total from k0[n] when given, else
//     wait for the last tile's inclusive prefix (every tile was handed out
//     before them, so this cannot deadlock).
// The look-back folds at most 32 predecessors an L2 round trip, so with a
// tile of 8,192 elements its front, not the memory, set the pace at the
// capacity (20,480 tiles); four sub-tiles a tile cut the steps fourfold
// while the staging buffer stays one sub-tile of the widest plane.  Chosen
// on the H100 over one and two sub-tiles a tile, 32 to 48 registers (more
// blocks, with spills), and the first plane's loads issued before the
// look-back.  A call is one launch, plus one memset of the tile counter and
// status words when k0 is not given; nothing survives from one call to the
// next.
//
// Expansion, output-driven, so every output slot is written exactly once
// by the kernel and the caller allocates without filling:
//   * the targets of the live lanes strictly increase (dead lanes' dist
//     is arbitrary and never enters the ordering), so cutting the input
//     into 2,048-lane tiles and taking each tile's first live target
//     (clamped to [0, out_cap]; out_cap for a tile with none), its suffix
//     minimum S is non-decreasing and tile b's live targets lie in
//     [S[b], S[b+1]) (from 0 for tile 0);
//   * a pre-pass computes S: a thread a tile reads the tile's first 16
//     live flags in one load and one dist; the tiles whose first 16
//     lanes are dead (runs of dead lanes, which must be read whole) are
//     read by all of the block's threads, 16 lanes a load; each block
//     takes the suffix minimum of its 256 tiles, and the last block to
//     finish (an atomic ticket, the scratch's last word, which the
//     caller zeroes) the suffix minimum over the blocks, so S[b] =
//     min(local[b], blocks[b / 256 + 1]) with no third launch;
//   * the expansion takes one output chunk of OC slots per block (OC as
//     large as fits 64 KB of shared memory over every plane and
//     `placed`), finds the tile owning its first slot by binary search
//     on S, zeroes the chunk in shared memory, walks the tiles whose
//     range meets the chunk (jumping over runs of empty tiles by one
//     more search), each thread taking eight consecutive lanes with
//     vector loads of live, dist and the first plane issued together,
//     scatters the hits into shared memory, and writes the whole chunk
//     with 16-byte stores;
//   * every plane (1, 4 or 8 bytes an element, mixed) moves in the same
//     launch, so live and dist are read once a call; `placed` is written
//     only when the caller asks for it.
// A tile that straddles two chunks is read by both (at most one tile per
// chunk end).  Chosen on the H100 over 4 and 16 lanes a thread, 16 to
// 128 KB chunks and 512-thread blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PLANES = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Planes {
  const uint8_t* in[MAX_PLANES];
  uint8_t* out[MAX_PLANES];
  int esz[MAX_PLANES];
  int count;
};

// ---------------------------------------------------------------------------
// compaction
// ---------------------------------------------------------------------------

constexpr int CITEMS = 32;                  // keep lanes a thread a sub-tile: one mask word
constexpr int CTILE = THREADS * CITEMS;     // 8,192 elements a sub-tile, the staging unit
constexpr int CSUB = 4;                     // sub-tiles a tile: one look-back for all of them
constexpr int CSUPER = CSUB * CTILE;        // 32,768 elements a tile, one status word
constexpr int CWARPS = THREADS / 32;
constexpr int CUNROLL = 4;                  // 16-byte plane loads in flight a thread
constexpr int CZSTEP = THREADS * 16;        // tail bytes a zero block stores a step
constexpr int64_t CZBLOCKS = 264;           // the most zero blocks
static_assert(CSUB * CWARPS <= 32, "warp 0 scans one (sub-tile, warp) count a lane");

template <int E> struct Elem;
template <> struct Elem<1> { using T = uint8_t; };
template <> struct Elem<4> { using T = uint32_t; };
template <> struct Elem<8> { using T = unsigned long long; };

// word k (of 32 bits) of a register array of uint4s
__device__ __forceinline__ uint32_t word(const uint4* buf, int k) {
  const uint4 v = buf[k / 4];
  return k % 4 == 0 ? v.x : k % 4 == 1 ? v.y : k % 4 == 2 ? v.z : v.w;
}

// element k of the 16 / E in a 16-byte word
template <int E>
__device__ __forceinline__ typename Elem<E>::T elem(const uint4& q, int k) {
  if constexpr (E == 1) return (uint8_t)(word(&q, k >> 2) >> (8 * (k & 3)));
  else if constexpr (E == 4) return word(&q, k);
  else return (unsigned long long)word(&q, 2 * k) | (unsigned long long)word(&q, 2 * k + 1) << 32;
}

// a sub-tile's keep masks and, for each 32-element group, the sub-tile's
// kept count before it (shared memory)
struct Ranks {
  const uint32_t* mask;
  const int32_t* before;

  __device__ __forceinline__ bool kept(int e) const { return mask[e >> 5] >> (e & 31) & 1u; }
  // the kept elements of the sub-tile before element e
  __device__ __forceinline__ int rank(int e) const {
    return before[e >> 5] + __popc(mask[e >> 5] & ((1u << (e & 31)) - 1u));
  }
};

// one plane of one sub-tile: its kept elements to their ranks in `st`
// (element r at st[r]), by the threads t0, t0 + stride, ...
template <int E>
__device__ __forceinline__ void stage_plane(const uint8_t* __restrict__ in, int64_t base, int sub_n,
                                            const Ranks& R, uint8_t* st, int t0, int stride) {
  using T = typename Elem<E>::T;
  constexpr int PER = 16 / E;        // elements a 16-byte word
  constexpr int NV = CTILE / PER;    // 16-byte words a sub-tile
  T* sp = reinterpret_cast<T*>(st);
  const T* src = reinterpret_cast<const T*>(in) + base;
  if (sub_n == CTILE && ((uintptr_t)src & 15) == 0) {  // a whole sub-tile, aligned: 16-byte loads
    const uint4* w = reinterpret_cast<const uint4*>(src);
    for (int i0 = t0; i0 < NV; i0 += stride * CUNROLL) {
      uint4 v[CUNROLL];
#pragma unroll
      for (int u = 0; u < CUNROLL; ++u)
        if (i0 + u * stride < NV) v[u] = __ldg(w + i0 + u * stride);
#pragma unroll
      for (int u = 0; u < CUNROLL; ++u) {
        const int i = i0 + u * stride;
        if (i >= NV) break;
        const int e0 = i * PER;
        const uint32_t m = R.mask[e0 >> 5] >> (e0 & 31);
        if (!(m & ((1u << PER) - 1u))) continue;
        int r = R.rank(e0);
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (m >> k & 1u) sp[r++] = elem<E>(v[u], k);
      }
    }
  } else {
    for (int e = t0; e < sub_n; e += stride)
      if (R.kept(e)) sp[R.rank(e)] = src[e];
  }
}

// the staged run st[0, count) to out[lo, lo + count): element stores up to
// the first 16-byte boundary of out and from the last, 16-byte stores
// between, each assembled from the staged words by a funnel shift (the
// run starts at any address mod 16)
template <int E>
__device__ __forceinline__ void write_run(uint8_t* __restrict__ out, int64_t lo, int count,
                                          const uint8_t* st, int tid) {
  using T = typename Elem<E>::T;
  const T* sp = reinterpret_cast<const T*>(st);
  T* o = reinterpret_cast<T*>(out);
  const int64_t lob = lo * E, hib = (lo + count) * E;
  const int64_t a16 = lob + ((16 - ((uintptr_t)(out + lob) & 15)) & 15);
  const int64_t b16 = hib - (int64_t)((uintptr_t)(out + hib) & 15);
  if (a16 >= b16) {
    for (int q = tid; q < count; q += THREADS) o[lo + q] = sp[q];
    return;
  }
  const int head = (int)((a16 - lob) / E), tail = (int)((hib - b16) / E);
  if (tid < head) o[lo + tid] = sp[tid];
  if (tid < tail) o[b16 / E + tid] = sp[(b16 - lob) / E + tid];
  const int d = (int)(a16 - lob);  // the staged byte of out's first aligned byte
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(st) + (d >> 2);
  const int sh = 8 * (d & 3);
  uint4* body = reinterpret_cast<uint4*>(out + a16);
  const int words = (int)((b16 - a16) >> 4);
  for (int i = tid; i < words; i += THREADS) {
    const uint32_t* w = sw + 4 * i;
    uint4 q;
    if (d == 0) {
      q = reinterpret_cast<const uint4*>(w)[0];
    } else {
      const uint32_t x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3], x4 = sh ? w[4] : 0u;
      q = make_uint4(__funnelshift_r(x0, x1, sh), __funnelshift_r(x1, x2, sh),
                     __funnelshift_r(x2, x3, sh), __funnelshift_r(x3, x4, sh));
    }
    body[i] = q;
  }
}

__global__ void __launch_bounds__(THREADS, 4)
compact_stream_tiles(const uint8_t* __restrict__ keep, const int32_t* __restrict__ k0_in, int64_t n,
                     int keep_vec, Planes P, int32_t* __restrict__ k0_out, int64_t ntiles, int64_t nz,
                     unsigned* __restrict__ counter, unsigned long long* __restrict__ status) {
  extern __shared__ uint4 stage4[];
  __shared__ uint32_t s_mask[CSUB][THREADS];
  __shared__ int32_t s_before[CSUB][THREADS];
  __shared__ int32_t s_part[32];  // inclusive kept counts over (sub-tile, warp), sub-tile major
  __shared__ int64_t s_excl;
  __shared__ int64_t s_tile;
  uint8_t* st = reinterpret_cast<uint8_t*>(stage4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile = counter != nullptr ? (int64_t)atomicAdd(counter, 1u) : (int64_t)blockIdx.x;
  __syncthreads();
  const int64_t tile = s_tile;

  if (tile >= ntiles) {  // a zero block: the total, then every plane's tail
    if (tid == 0) {
      int64_t total;
      if (k0_in != nullptr) {
        total = (int64_t)(uint32_t)__ldg(k0_in + n);
      } else {
        unsigned long long v;
        while (((v = lookback::load_status(status + ntiles - 1)) >> 32) != 2) __nanosleep(100);
        total = (int64_t)(uint32_t)v;
      }
      s_excl = total < n ? total : n;
    }
    __syncthreads();
    for (int p = 0; p < P.count; ++p)
      lookback::zero_tail<THREADS>(P.out[p], s_excl * P.esz[p], n * P.esz[p], tile - ntiles, nz, tid);
    return;
  }

  // this thread's 32 keep lanes of each sub-tile
  const int64_t base = tile * CSUPER;
  uint32_t mask[CSUB];
#pragma unroll
  for (int s = 0; s < CSUB; ++s) {
    const int64_t j0 = base + (int64_t)s * CTILE + (int64_t)tid * CITEMS;
    if (keep_vec && base + (int64_t)(s + 1) * CTILE <= n) {
      const uint4* kp = reinterpret_cast<const uint4*>(keep + j0);
      mask[s] = lookback::nonzero_bits16(__ldg(kp)) | lookback::nonzero_bits16(__ldg(kp + 1)) << 16;
    } else {
      mask[s] = 0;
      for (int k = 0; k < CITEMS && j0 + k < n; ++k)
        if (keep[j0 + k]) mask[s] |= 1u << k;
    }
  }

  // the counts across each warp, then across the (sub-tile, warp) pairs
  int32_t x[CSUB];
#pragma unroll
  for (int s = 0; s < CSUB; ++s) {
    s_mask[s][tid] = mask[s];
    x[s] = __popc(mask[s]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x[s], d);
      if (lane >= d) x[s] += y;
    }
    if (lane == 31) s_part[s * CWARPS + warp] = x[s];
  }
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < CSUB * CWARPS ? s_part[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < CSUB * CWARPS) s_part[lane] = w;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < CSUB; ++s) {  // each group's kept count before it in its sub-tile
    const int q = s * CWARPS + warp;
    const int32_t sub0 = s > 0 ? s_part[s * CWARPS - 1] : 0;
    s_before[s][tid] = (q > 0 ? s_part[q - 1] : 0) - sub0 + x[s] - __popc(mask[s]);
  }
  __syncthreads();

  // warp 0 takes the tile's offset (the look-back, or k0 at the tile's
  // start) while the other warps stage the first sub-tile's first plane,
  // whose ranks do not depend on it
  if (warp == 0) {
    if (k0_in != nullptr) {
      if (lane == 0) s_excl = (int64_t)(uint32_t)__ldg(k0_in + base);
    } else {
      const int32_t excl =
          lookback::publish_and_look_back<lookback::Sum>(status, tile, s_part[CSUB * CWARPS - 1], lane);
      if (lane == 0) s_excl = (int64_t)(uint32_t)excl;
    }
  }
  bool known = false;  // s_excl seen by every thread (after a barrier)
  for (int s = 0; s < CSUB; ++s) {
    const int64_t sb = base + (int64_t)s * CTILE;
    if (sb >= n) break;
    const int sub_n = (int)(n - sb < CTILE ? n - sb : CTILE);
    const int32_t sub0 = s > 0 ? s_part[s * CWARPS - 1] : 0;
    const int count = s_part[s * CWARPS + CWARPS - 1] - sub0;
    const Ranks R{s_mask[s], s_before[s]};
    for (int p = 0; p < P.count && count > 0; ++p) {
      const int e = P.esz[p];
      // until the offset is known, warp 0 is busy taking it
      const int t0 = known ? tid : tid - 32, stride = known ? THREADS : THREADS - 32;
      if (t0 >= 0) {
        if (e == 1) stage_plane<1>(P.in[p], sb, sub_n, R, st, t0, stride);
        else if (e == 4) stage_plane<4>(P.in[p], sb, sub_n, R, st, t0, stride);
        else stage_plane<8>(P.in[p], sb, sub_n, R, st, t0, stride);
      }
      __syncthreads();
      known = true;
      const int64_t lo = s_excl + sub0;
      if (e == 1) write_run<1>(P.out[p], lo, count, st, tid);
      else if (e == 4) write_run<4>(P.out[p], lo, count, st, tid);
      else write_run<8>(P.out[p], lo, count, st, tid);
      __syncthreads();  // before the next plane or sub-tile takes `st`
    }
    if (k0_out != nullptr) {  // k0 over the sub-tile
      if (!known) {
        __syncthreads();
        known = true;
      }
      int32_t* kd = k0_out + sb;
      const int32_t ex = (int32_t)(s_excl + sub0);
      if (sub_n == CTILE) {
        for (int i = tid; i < CTILE / 4; i += THREADS) {
          const int e = 4 * i;
          const uint32_t m = R.mask[e >> 5] >> (e & 31);
          int4 q;
          q.x = ex + R.rank(e);
          q.y = q.x + (int)(m & 1u);
          q.z = q.y + (int)(m >> 1 & 1u);
          q.w = q.z + (int)(m >> 2 & 1u);
          reinterpret_cast<int4*>(kd)[i] = q;
        }
      } else {
        for (int e = tid; e < sub_n; e += THREADS) kd[e] = ex + R.rank(e);
      }
    }
  }
  if (k0_out != nullptr && tile == ntiles - 1 && tid == 0) k0_out[n] = (int32_t)s_excl + s_part[CSUB * CWARPS - 1];
}

// ---------------------------------------------------------------------------
// expansion
// ---------------------------------------------------------------------------

constexpr int LANES = 8;                            // lanes a thread
constexpr int TILE = THREADS * LANES;               // lanes a tile
constexpr int TILES_PER_PRE = THREADS;              // tiles a pre-pass block (a thread each)
constexpr int EXPAND_SMEM = 65536;                  // chunk bytes a block
constexpr int SUFFIX_ITEMS = 16;                    // last block: entries a thread
constexpr int SCAN_UNROLL = 8;                      // pre-pass: loads in flight a thread

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// inclusive suffix minimum over the 32 lanes of a warp
__device__ __forceinline__ int64_t warp_suffix_min(int64_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = __shfl_down_sync(FULL, v, d);
    if (lane + d < 32) v = min64(v, o);
  }
  return v;
}

// bit i set where byte i of v is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((w[k] >> (8 * i)) & 0xffu) m |= 1u << (4 * k + i);
  return m;
}

// bit i set where byte i of the 16 at live + j0 is nonzero (bytes at or
// past n count as zero)
__device__ __forceinline__ unsigned live_bits16(const uint8_t* __restrict__ live,
                                                int64_t j0, int64_t n, bool vec) {
  if (vec && j0 + 16 <= n) return nonzero_bytes(__ldg((const uint4*)(live + j0)));
  unsigned m = 0;
  for (int i = 0; i < 16 && j0 + i < n; ++i)
    if (live[j0 + i]) m |= 1u << i;
  return m;
}

// Pre-pass: local[b] = the suffix minimum, within this block's tiles (a
// thread each), of each tile's first live target; blocks[k] of every
// block's minimum once the last block is done (blocks[nblk] = out_cap).
__global__ void __launch_bounds__(THREADS)
expand_firsts(const uint8_t* __restrict__ live, const int32_t* __restrict__ dist,
              int64_t n, int64_t out_cap, int64_t ntiles, int live_vec,
              int64_t* __restrict__ local, int64_t* __restrict__ block_min,
              int64_t* __restrict__ blocks, unsigned* __restrict__ ticket) {
  __shared__ int64_t agg[THREADS / 32];
  __shared__ unsigned long long scanned[TILES_PER_PRE];
  __shared__ int pending[TILES_PER_PRE];
  __shared__ int npending;
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) npending = 0;
  scanned[threadIdx.x] = ~0ull;
  __syncthreads();
  const int64_t tile0 = (int64_t)blockIdx.x * TILES_PER_PRE;
  const int64_t b = tile0 + threadIdx.x;
  const int64_t base = b * TILE;
  int64_t first = -1;
  bool scan = false;
  if (b < ntiles) {  // the tile's first 16 lanes, one load
    const unsigned m = live_bits16(live, base, n, live_vec != 0);
    if (m) first = base + __ffs(m) - 1;
    else scan = base + 16 < n;
  }
  if (scan) pending[atomicAdd(&npending, 1)] = threadIdx.x;
  __syncthreads();
  // the tiles whose first 16 lanes are dead (runs of dead lanes, which
  // must be read whole): the block's threads over their 16-lane units,
  // neighbours on neighbouring units, several loads in flight a thread
  const int units = npending * (TILE / 16);
  for (int u0 = threadIdx.x; u0 < units; u0 += THREADS * SCAN_UNROLL) {
    uint4 v[SCAN_UNROLL];  // all the loads first, then their flags
#pragma unroll
    for (int r = 0; r < SCAN_UNROLL; ++r) {
      const int u = u0 + r * THREADS;
      const int64_t j = (tile0 + pending[u < units ? u / (TILE / 16) : 0]) * TILE + 16 * (u % (TILE / 16));
      v[r] = u < units && live_vec && j + 16 <= n ? __ldg((const uint4*)(live + j)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < SCAN_UNROLL; ++r) {
      const int u = u0 + r * THREADS;
      if (u >= units) continue;
      const int owner = pending[u / (TILE / 16)];
      const int64_t j = (tile0 + owner) * TILE + 16 * (u % (TILE / 16));
      const unsigned m = live_vec && j + 16 <= n ? nonzero_bytes(v[r]) : live_bits16(live, j, n, false);
      if (m) atomicMin(&scanned[owner], (unsigned long long)(j + __ffs(m) - 1));
    }
  }
  __syncthreads();
  if (scan && scanned[threadIdx.x] != ~0ull) first = (int64_t)scanned[threadIdx.x];
  int64_t f = out_cap;
  if (first >= 0) {
    const int64_t t = first + (int64_t)dist[first];
    f = t < 0 ? 0 : (t > out_cap ? out_cap : t);
  }
  // suffix minimum over the block's tiles, threads in order
  const int64_t s = warp_suffix_min(f, lane);
  if (lane == 0) agg[warp] = s;
  __syncthreads();
  int64_t right = s;
  for (int w = warp + 1; w < THREADS / 32; ++w) right = min64(right, agg[w]);
  if (b < ntiles) local[b] = right;
  if (threadIdx.x == 0) {
    block_min[blockIdx.x] = right;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: blocks[k] = min(block_min[k..nblk)), from the right
  const int64_t nblk = gridDim.x;
  int64_t carry = out_cap;
  if (threadIdx.x == 0) blocks[nblk] = out_cap;
  for (int64_t end = nblk; end > 0; end -= (int64_t)THREADS * SUFFIX_ITEMS) {
    const int64_t lo = end - (int64_t)THREADS * SUFFIX_ITEMS;
    const int64_t mine = lo + (int64_t)threadIdx.x * SUFFIX_ITEMS;
    int64_t v[SUFFIX_ITEMS];
    int64_t acc = out_cap;
#pragma unroll
    for (int i = SUFFIX_ITEMS - 1; i >= 0; --i) {
      const int64_t k = mine + i;
      v[i] = (k >= 0 && k < end) ? __ldcg(block_min + k) : out_cap;
      acc = min64(acc, v[i]);
    }
    // suffix minimum of the threads' aggregates, threads in order
    int64_t s = warp_suffix_min(acc, lane);
    if (lane == 0) agg[warp] = s;
    __syncthreads();
    int64_t right = carry;
    for (int w = warp + 1; w < THREADS / 32; ++w) right = min64(right, agg[w]);
    const int64_t after = __shfl_down_sync(FULL, s, 1);
    if (lane < 31) right = min64(right, after);
    for (int i = SUFFIX_ITEMS - 1; i >= 0; --i) {
      right = min64(right, v[i]);
      const int64_t k = mine + i;
      if (k >= 0 && k < end) blocks[k] = right;
    }
    int64_t all = carry;
    for (int w = 0; w < THREADS / 32; ++w) all = min64(all, agg[w]);
    __syncthreads();
    carry = all;
  }
}

struct Starts {
  const int64_t* local;
  const int64_t* blocks;
  int64_t ntiles, out_cap;

  // S[b]: tile b's live targets lie in [S[b], S[b + 1])
  __device__ __forceinline__ int64_t operator()(int64_t b) const {
    if (b >= ntiles) return out_cap;
    return min64(__ldg(local + b), __ldg(blocks + b / TILES_PER_PRE + 1));
  }
  // the first tile from a on whose targets may lie below hi and that is
  // not empty, or -1
  __device__ int64_t next_tile(int64_t a, int64_t hi) const {
    while (a < ntiles) {
      const int64_t sa = (*this)(a);
      if (sa >= hi) return -1;
      if ((*this)(a + 1) != sa) return a;
      a = last_at_most(sa);  // past tile a and the empty ones after it
    }
    return -1;
  }
  // the last b in [0, ntiles] with S[b] <= v, or -1
  __device__ int64_t last_at_most(int64_t v) const {
    int64_t lo = 0, hi = ntiles + 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if ((*this)(mid) > v) hi = mid; else lo = mid + 1;
    }
    return lo - 1;
  }
};

__device__ __forceinline__ void put(uint8_t* sm, int e, int slot, const uint8_t* src) {
  if (e == 1) sm[slot] = *src;
  else if (e == 4) ((uint32_t*)sm)[slot] = *(const uint32_t*)src;
  else ((uint64_t*)sm)[slot] = *(const uint64_t*)src;
}

// LANES consecutive elements of e bytes from an address aligned to
// LANES * e (16 at most) into buf, with the widest loads that fit
__device__ __forceinline__ void load_lanes(uint4* buf, const uint8_t* src, int e) {
  const int bytes = LANES * e;
  if (bytes >= 16) {
#pragma unroll
    for (int k = 0; k < LANES * 8 / 16; ++k)
      if (k < bytes / 16) buf[k] = __ldg((const uint4*)src + k);
  } else if (bytes == 8) {
    const uint2 v = __ldg((const uint2*)src);
    buf[0].x = v.x;
    buf[0].y = v.y;
  } else {
    buf[0].x = __ldg((const uint32_t*)src);
  }
}

// the hit lanes of buf (LANES elements of e bytes) into their slots of dst
__device__ __forceinline__ void scatter_lanes(uint8_t* dst, int e, unsigned hit,
                                              const int* slot, const uint4* buf) {
  if (e == 1) {
#pragma unroll
    for (int i = 0; i < LANES; ++i)
      if (hit >> i & 1) dst[slot[i]] = (uint8_t)(word(buf, i / 4) >> (8 * (i % 4)));
  } else if (e == 4) {
#pragma unroll
    for (int i = 0; i < LANES; ++i)
      if (hit >> i & 1) ((uint32_t*)dst)[slot[i]] = word(buf, i);
  } else {
#pragma unroll
    for (int i = 0; i < LANES; ++i)
      if (hit >> i & 1)
        ((uint64_t*)dst)[slot[i]] = (uint64_t)word(buf, 2 * i) | (uint64_t)word(buf, 2 * i + 1) << 32;
  }
}

__host__ __device__ __forceinline__ int region(int64_t OC, int e) {
  return (int)((OC * e + 15) & ~(int64_t)15);
}

// a thread's LANES input lanes of one tile: live, dist and the first
// plane's elements, loaded together (vector loads where aligned)
struct Lanes {
  int64_t j0;
  bool wide;
  uint4 lb;
  uint4 db[LANES * 4 / 16];
  uint4 v0[LANES * 8 / 16];

  __device__ __forceinline__ void load(int64_t a, int tid, int64_t n, int vec,
                                       const uint8_t* __restrict__ live,
                                       const int32_t* __restrict__ dist,
                                       const uint8_t* __restrict__ in0, int e0) {
    j0 = a * TILE + (int64_t)tid * LANES;
    wide = vec && j0 + LANES <= n;
    if (!wide) return;
    load_lanes(&lb, live + j0, 1);
#pragma unroll
    for (int k = 0; k < LANES * 4 / 16; ++k) db[k] = __ldg((const uint4*)(dist + j0) + k);
    load_lanes(v0, in0 + j0 * e0, e0);
  }

  // the lanes whose targets lie in [o, hi) into their chunk slots
  __device__ __forceinline__ void scatter(int64_t o, int64_t hi, int64_t n,
                                          const uint8_t* __restrict__ live,
                                          const int32_t* __restrict__ dist,
                                          const Planes& P, uint8_t* sm, int placed_off,
                                          int64_t OC) const {
    if (j0 >= n) return;
    uint8_t lv[LANES];
    int32_t d[LANES];
    if (wide) {
#pragma unroll
      for (int i = 0; i < LANES; ++i) {
        lv[i] = (uint8_t)(word(&lb, i / 4) >> (8 * (i % 4)));
        d[i] = (int32_t)word(db, i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < LANES; ++i) {
        const bool in = j0 + i < n;
        lv[i] = in ? live[j0 + i] : 0;
        d[i] = in ? dist[j0 + i] : 0;
      }
    }
    unsigned hit = 0;
    int slot[LANES];
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const int64_t t = j0 + i + (int64_t)d[i];
      slot[i] = (int)(t - o);
      if (lv[i] && t >= o && t < hi) hit |= 1u << i;
    }
    if (!hit) return;
    int off = 0;
    for (int p = 0; p < P.count; ++p) {
      const int e = P.esz[p];
      uint8_t* dst = sm + off;
      off += region(OC, e);
      const uint8_t* in = P.in[p] + j0 * e;
      if (wide && p == 0) {
        scatter_lanes(dst, e, hit, slot, v0);
      } else if (wide) {
        uint4 buf[LANES * 8 / 16];
        load_lanes(buf, in, e);
        scatter_lanes(dst, e, hit, slot, buf);
      } else {
#pragma unroll
        for (int i = 0; i < LANES; ++i)
          if (hit >> i & 1) put(dst, e, slot[i], in + i * e);
      }
    }
    if (placed_off >= 0) {
#pragma unroll
      for (int i = 0; i < LANES; ++i)
        if (hit >> i & 1) sm[placed_off + slot[i]] = 1;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
expand_kernel(const uint8_t* __restrict__ live, const int32_t* __restrict__ dist,
              int64_t n, int64_t out_cap, Planes P, uint8_t* __restrict__ placed,
              Starts S, int64_t OC, int vec) {
  extern __shared__ uint4 smem4[];
  uint8_t* sm = (uint8_t*)smem4;
  __shared__ int64_t first_tile;
  const int tid = threadIdx.x;
  const int64_t o = (int64_t)blockIdx.x * OC;
  const int64_t hi = min64(o + OC, out_cap);
  int total = 0;  // the planes' regions, then placed's
  for (int p = 0; p < P.count; ++p) total += region(OC, P.esz[p]);
  const int placed_off = total;
  if (placed != nullptr) total += region(OC, 1);
  for (int k = tid; k < total / 16; k += THREADS) smem4[k] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    const int64_t b = S.last_at_most(o);
    first_tile = b < 0 ? 0 : b;
  }
  __syncthreads();
  const int e0 = P.esz[0];
  for (int64_t a = S.next_tile(first_tile, hi); a >= 0; a = S.next_tile(a + 1, hi)) {
    Lanes l;
    l.load(a, tid, n, vec, live, dist, P.in[0], e0);
    l.scatter(o, hi, n, live, dist, P, sm, placed != nullptr ? placed_off : -1, OC);
  }
  __syncthreads();
  const int64_t cnt = hi - o;
  int off = 0;
  for (int p = 0; p <= P.count; ++p) {
    uint8_t* out;
    int64_t bytes;
    if (p < P.count) {
      out = P.out[p] + o * P.esz[p];
      bytes = cnt * P.esz[p];
    } else {
      if (placed == nullptr) break;
      out = placed + o;
      bytes = cnt;
    }
    const uint8_t* src = sm + off;
    if (p < P.count) off += region(OC, P.esz[p]);
    for (int64_t k = (int64_t)tid * 16; k < bytes; k += (int64_t)THREADS * 16) {
      if (k + 16 <= bytes) {
        *(uint4*)(out + k) = *(const uint4*)(src + k);
      } else {
        for (int64_t i = k; i < bytes; ++i) out[i] = src[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// int64 words of scratch a compaction of n elements needs when the caller
// gives no k0: the tile counter, then a status word per tile
int64_t cs_compact_scratch_words(int64_t n) { return 1 + (n + CSUPER - 1) / CSUPER; }

// Move kept element j (keep[j] nonzero) of every plane to k0[j], zeros
// from k0[n] on.  keep: uint8[n]; k0_in: int32[n + 1], the exclusive
// prefix count of keep with the total at k0_in[n], or null, and then
// scratch holds cs_compact_scratch_words(n) int64 words, 8-byte aligned,
// which this call zeroes (one memset on the stream) before its launch;
// in/out: nplanes (0 to 8) pointers of n elements, esz their element bytes
// (1, 4 or 8; each pointer aligned to its element); k0_out: int32[n + 1],
// 16-byte aligned, written when not null (with k0_in null).
int cs_compact(const void* keep, const void* k0_in, int64_t n, int nplanes,
               const void* const* in, void* const* out, const int* esz, void* k0_out,
               void* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= ((int64_t)1 << 31) || nplanes < 0 || nplanes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  if (k0_in == nullptr && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)k0_out % 16) return (int)cudaErrorMisalignedAddress;
  Planes P;
  P.count = nplanes;
  int maxe = 1;
  int64_t bytes = 0;  // of every plane's element
  for (int p = 0; p < nplanes; ++p) {
    if (esz[p] != 1 && esz[p] != 4 && esz[p] != 8) return (int)cudaErrorInvalidValue;
    P.in[p] = (const uint8_t*)in[p];
    P.out[p] = (uint8_t*)out[p];
    P.esz[p] = esz[p];
    maxe = esz[p] > maxe ? esz[p] : maxe;
    bytes += esz[p];
  }
  const int64_t ntiles = (n + CSUPER - 1) / CSUPER;
  int64_t nz = (n * bytes + CZSTEP - 1) / CZSTEP;
  nz = nz < CZBLOCKS ? nz : CZBLOCKS;
  // a sub-tile's kept elements of the widest plane, and 16 bytes past them
  // (a funnel-shifted store reads one word beyond its run)
  const int smem = CTILE * maxe + 16;
  if (smem > 40 * 1024) {  // past the default with the static shared memory
    const cudaError_t e =
        cudaFuncSetAttribute(compact_stream_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool look_back = k0_in == nullptr;
  if (look_back) {  // the tile counter and the status words start at 0
    if ((uintptr_t)scratch % 8) return (int)cudaErrorMisalignedAddress;
    const cudaError_t e = cudaMemsetAsync(scratch, 0, 8 * (size_t)cs_compact_scratch_words(n),
                                          (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  compact_stream_tiles<<<(unsigned)(ntiles + nz), THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, (const int32_t*)k0_in, n, (uintptr_t)keep % 16 == 0, P, (int32_t*)k0_out,
      ntiles, nz, look_back ? (unsigned*)scratch : nullptr,
      look_back ? (unsigned long long*)scratch + 1 : nullptr);
  return (int)cudaGetLastError();
}

// int64 words of scratch cs_expand needs for n input lanes
int64_t cs_expand_scratch_words(int64_t n) {
  const int64_t ntiles = (n + TILE - 1) / TILE;
  const int64_t nblk = (ntiles + TILES_PER_PRE - 1) / TILES_PER_PRE;
  return ntiles + nblk + nblk + 1 + 1;  // local, block_min, blocks, ticket
}

// Move live lane j of every plane to j + dist[j] where that lies in
// [0, out_cap), zeros elsewhere; placed (may be null) gets 1 where a
// value landed, 0 elsewhere.  in/out: nplanes pointers, esz their element
// bytes (1, 4 or 8); out and placed must be 16-byte aligned.  scratch:
// cs_expand_scratch_words(n) int64 words, the last of them 0 (the
// pre-pass's ticket).
int cs_expand(const void* live, const void* dist, int64_t n, int64_t out_cap,
              int nplanes, const void* const* in, void* const* out,
              const int* esz, void* placed, void* scratch, void* stream) {
  if (out_cap <= 0) return (int)cudaGetLastError();
  if (nplanes < 1 || nplanes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Planes P;
  P.count = nplanes;
  int bytes_per_slot = placed != nullptr ? 1 : 0;
  bool vec = (uintptr_t)live % LANES == 0 && (uintptr_t)dist % (4 * LANES) == 0;
  for (int p = 0; p < nplanes; ++p) {
    if (esz[p] != 1 && esz[p] != 4 && esz[p] != 8) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out[p] % 16) return (int)cudaErrorMisalignedAddress;
    P.in[p] = (const uint8_t*)in[p];
    P.out[p] = (uint8_t*)out[p];
    P.esz[p] = esz[p];
    bytes_per_slot += esz[p];
    const int align = LANES * esz[p] < 16 ? LANES * esz[p] : 16;
    vec = vec && (uintptr_t)in[p] % align == 0;
  }
  if ((uintptr_t)placed % 16) return (int)cudaErrorMisalignedAddress;
  const int64_t OC = (int64_t)(EXPAND_SMEM / bytes_per_slot) & ~(int64_t)15;
  const int64_t ntiles = n > 0 ? (n + TILE - 1) / TILE : 0;
  const int64_t nblk = (ntiles + TILES_PER_PRE - 1) / TILES_PER_PRE;
  int64_t* local = (int64_t*)scratch;
  int64_t* block_min = local + ntiles;
  int64_t* blocks = block_min + nblk;
  unsigned* ticket = (unsigned*)(blocks + nblk + 1);
  if (ntiles > 0) {
    expand_firsts<<<(unsigned)nblk, THREADS, 0, s>>>(
        (const uint8_t*)live, (const int32_t*)dist, n, out_cap, ntiles,
        (uintptr_t)live % 16 == 0, local, block_min, blocks, ticket);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Starts S{local, blocks, ntiles, out_cap};
  // one chunk's shared memory: each region rounded up to 16 bytes
  int smem = placed != nullptr ? region(OC, 1) : 0;
  for (int p = 0; p < nplanes; ++p) smem += region(OC, esz[p]);
  if (smem > 47 * 1024) {  // with the static shared memory, past the default
    const cudaError_t e = cudaFuncSetAttribute(
        expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  expand_kernel<<<(unsigned)((out_cap + OC - 1) / OC), THREADS, smem, s>>>(
      (const uint8_t*)live, (const int32_t*)dist, n, out_cap, P,
      (uint8_t*)placed, S, OC, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
