// K4c / K4e: stable stream compaction and monotone stream expansion of
// flat planes (uint8, int32 or int64 elements).
//
// Replaces the TPU kernels custrings_tpu/ops/pallas_route.py::_compact_p
// (body _compact_kernel_factory, via compact_stream) and ::_expand_p (body
// _expand_kernel_factory, via expand_stream).
//
//   compact: out[k0[j]] = in[j] for every kept j, zeros from k0[n] on,
//            where k0 is the exclusive prefix count of keep (K3)
//   expand:  out[j + dist[j]] = in[j] for every live j whose target lies
//            in [0, out_cap); placed[t] = 1 where a value landed; zeros
//            elsewhere
//
// Bound on the H100: device-memory bytes.  Compaction reads keep (1 B),
// k0 (4 B) and the element, and writes the element; expansion reads live
// (1 B), dist (4 B) and the element, and writes the element and a placed
// byte.  At the 1M-row tier both run over the 167,772,160-byte capacity.
//
// The TPU version routes each 64K-element tile through log2(T) roll+select
// rounds in registers and stitches tiles through a VMEM ring buffer,
// because the TPU has no fast scatter and its grid runs in order.  On
// Hopper a store to any address is one instruction.
//
// Compaction: a grid-stride loop, one element per thread per step,
// coalesced reads of every input plane; the targets are monotone in j,
// so a warp's 32 stores land on a few neighbouring sectors.  It writes
// its own zero tail (every j from k0[n] on is a slot no kept element
// takes).
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

namespace {

constexpr int THREADS = 256;

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  // grid-stride beyond this: 132 SMs x 8 resident 256-thread blocks x 16
  return (unsigned)(blocks < 16896 ? (blocks > 0 ? blocks : 1) : 16896);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const uint8_t* __restrict__ keep, const int32_t* __restrict__ k0,
               const T* __restrict__ in, int64_t n, T* __restrict__ out) {
  const int64_t total = k0[n];
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < n;
       j += stride) {
    if (keep[j]) out[k0[j]] = in[j];
    if (j >= total) out[j] = (T)0;
  }
}

constexpr int LANES = 8;                            // lanes a thread
constexpr int TILE = THREADS * LANES;               // lanes a tile
constexpr int TILES_PER_PRE = THREADS;              // tiles a pre-pass block (a thread each)
constexpr int MAX_PLANES = 8;
constexpr int EXPAND_SMEM = 65536;                  // chunk bytes a block
constexpr int SUFFIX_ITEMS = 16;                    // last block: entries a thread
constexpr int SCAN_UNROLL = 8;                      // pre-pass: loads in flight a thread
constexpr unsigned FULL = 0xffffffffu;

struct Planes {
  const uint8_t* in[MAX_PLANES];
  uint8_t* out[MAX_PLANES];
  int esz[MAX_PLANES];
  int count;
};

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

// word k (of 32 bits) of a register array of uint4s
__device__ __forceinline__ uint32_t word(const uint4* buf, int k) {
  const uint4 v = buf[k / 4];
  return k % 4 == 0 ? v.x : k % 4 == 1 ? v.y : k % 4 == 2 ? v.z : v.w;
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

// elem_bytes: 1, 4 or 8
int cs_compact(const void* keep, const void* k0, const void* in, int64_t n,
               int elem_bytes, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* kp = (const uint8_t*)keep;
  const int32_t* k = (const int32_t*)k0;
  switch (elem_bytes) {
    case 1:
      compact_kernel<uint8_t><<<grid_for(n), THREADS, 0, s>>>(
          kp, k, (const uint8_t*)in, n, (uint8_t*)out);
      break;
    case 4:
      compact_kernel<uint32_t><<<grid_for(n), THREADS, 0, s>>>(
          kp, k, (const uint32_t*)in, n, (uint32_t*)out);
      break;
    case 8:
      compact_kernel<uint64_t><<<grid_for(n), THREADS, 0, s>>>(
          kp, k, (const uint64_t*)in, n, (uint64_t*)out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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
