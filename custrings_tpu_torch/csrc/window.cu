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
// Bound on the H100: device-memory bytes.  The bytes form reads, per
// row, its start, its length and the window's bytes inside the buffer
// (with lengths, only those inside the row), and writes rows*W output
// bytes (x4 for the int32 form), about one operation a byte.
// The TPU version spends one aligned 4 KB DMA per row plus a rotate,
// because Mosaic only slices aligned windows; Hopper has no such rule,
// so the per-row alignment machinery, the SMEM row chunking and the
// MXU packing all go.
//
// Design of the bytes form: threads over the flat [rows, W] output, one
// 16-element chunk a thread, so the grid follows the output and not the
// rows (a width-1 view of 1M rows is 65,536 threads, where a warp a row
// left 31 of 32 lanes idle) and the output is written with 16-byte
// stores, 512 contiguous bytes a warp store.  A thread finds its row with
// one 32-bit division and loads the row's start and length together.  A
// chunk inside one row reads nothing where it lies past the row's length
// (more than half of a tweet column's 320-byte window) and otherwise the
// aligned 4-byte words covering the bytes it keeps (at most five, with
// __ldg, alignment taken from the absolute address since data may be a
// view at any offset), moved into place with __funnelshift_r and cut at
// the length.  When W >= 16 a chunk that straddles a row end reads the
// next row's start and length as well and takes its two parts as two
// such word windows.  When W < 16 (every chunk spans two to seventeen
// rows) a second instantiation of the kernel, chosen at launch, loads the
// starts and lengths of all the rows the chunk enters, then all its
// bytes, each kind at once.  The int32 form expands each chunk's 16
// bytes into 64 output bytes; a lane's four 16-byte stores would lie 64
// bytes apart from its neighbours', so the warp's 32 chunks go through
// its 512-byte slice of shared memory and each lane stores four words of
// its neighbours' bytes instead, contiguous across the warp.  Kept small
// on purpose: the kernel waits on its dependent loads (row start and
// length, then data), so it needs many threads resident, and the wide
// instantiation's few registers keep a full 2,048 on each SM; two or
// four chunks a thread, or the narrow path's parallel loads inside the
// wide kernel, took about twice the registers or more and ran slower.
// A word that would reach before data or past cap is not read: those
// bytes are taken one by one (the allocation is not known to be padded).

// Design of the words form: threads over the flat [rows, Wq] output, four
// consecutive output words a thread (one 16-byte store), so every lane
// works at any Wq and a warp stores 512 contiguous bytes; the four words
// may straddle rows.  Each word is assembled from the two aligned 4-byte
// words that cover its window (alignment taken from the absolute address
// data + start, since data may be a view at any offset) with one
// __funnelshift_r and one __byte_perm for the byte swap; a thread whose
// four words lie in one row (every thread when Wq is a multiple of 4, as
// in the encode's key words and tails) takes five aligned loads, the
// others assemble word by word.  An aligned word that would
// reach before data or past cap is not read: that word's bytes are taken
// one by one (the allocation is not known to be padded).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// x / y, in 32 bits when both fit
__device__ __forceinline__ int64_t quotient(int64_t x, int64_t y) {
  if (((uint64_t)x | (uint64_t)y) >> 32 == 0) return (int64_t)((uint32_t)x / (uint32_t)y);
  return x / y;
}

constexpr int BYTE_THREADS = 256;
// window bytes a chunk: one 16-byte store of the uint8 output, four of
// the int32 output
constexpr int CHUNK = 16;

// ORs into b (16 bytes, little-endian) the bytes at positions [lo, hi)
// of the 16-byte window at data + rel, 0 <= lo < hi <= 16: from the
// aligned words covering positions [0, hi) (alignment taken from the
// absolute address, since data may be a view at any offset), moved into
// place with a funnel shift; a word that would reach before data or past
// cap is not read, and those bytes are taken one by one (the allocation
// is not known to be padded).
__device__ __forceinline__ void window16(const uint8_t* __restrict__ data, int64_t cap, int64_t rel,
                                         int lo, int hi, uint32_t (&b)[4]) {
  const int mis = (int)(((uintptr_t)data + (uintptr_t)rel) & 3);
  const int64_t base = rel - mis;  // data + base is 4-byte aligned
  const int nw = (mis + hi + 3) >> 2;
  uint32_t w[4];
  if (base >= 0 && base + 4 * nw <= cap) {
    const uint32_t* p = (const uint32_t*)(data + base);
    uint32_t a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) a[i] = i < nw ? __ldg(p + i) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __funnelshift_r(a[j], a[j + 1], 8 * mis);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0u;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int64_t g = rel + i;
      if (i >= lo && i < hi && g >= 0 && g < cap) w[i >> 2] |= (uint32_t)__ldg(data + g) << (8 * (i & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k0 = lo - 4 * j, k1 = hi - 4 * j;  // the bytes of word j to keep
    if (k1 <= 0 || k0 >= 4) continue;
    const uint32_t upto = k1 >= 4 ? 0xffffffffu : (1u << (8 * k1)) - 1u;
    const uint32_t from = k0 <= 0 ? 0xffffffffu : ~((1u << (8 * k0)) - 1u);
    b[j] |= w[j] & upto & from;
  }
}

// The 16 bytes of a chunk of a narrow window (W < 16, so the chunk
// covers parts of two to seventeen rows), packed little-endian into b:
// the start and length of each row it enters first, then its bytes, then
// the packing, so that each kind of load is issued for all its elements
// at once.  s and len are row r's.
__device__ __forceinline__ void narrow(const uint8_t* __restrict__ data, int64_t cap,
                                       const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ lens, int64_t total,
                                       int64_t W, int64_t f, int64_t r, int64_t k,
                                       int64_t s, int64_t len, uint32_t (&b)[4]) {
  int32_t rs[CHUNK], rl[CHUNK];
  int64_t kk = k, rr = r;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    if (kk == W) {
      kk = 0;
      ++rr;
      if (f + i < total) {
        rs[i] = __ldg(starts + rr);
        rl[i] = lens != nullptr ? __ldg(lens + rr) : 0;
      }
    }
    ++kk;
  }
  uint32_t v[CHUNK];
  kk = k;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    if (kk == W) {
      kk = 0;
      if (f + i < total) {
        s = rs[i];
        len = lens != nullptr ? (int64_t)rl[i] : W;
      }
    }
    const int64_t g = s + kk;
    v[i] = f + i < total && kk < len && g >= 0 && g < cap ? (uint32_t)__ldg(data + g) : 0u;
    ++kk;
  }
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) b[i >> 2] |= v[i] << (8 * (i & 3));
}

// NARROW: W < 16.  Otherwise a chunk lies in one row or straddles one
// row end: the part in row r and the part in row r + 1 are each read as
// a 16-byte window (the latter shifted back by the part before it), so a
// straddling chunk costs two window reads and not sixteen byte loads.
template <typename OutT, bool NARROW>
__global__ void __launch_bounds__(BYTE_THREADS)
window_bytes(const uint8_t* __restrict__ data, int64_t cap,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
             int64_t total, int64_t W, OutT* __restrict__ out) {
  const int64_t f = ((int64_t)blockIdx.x * BYTE_THREADS + threadIdx.x) * CHUNK;
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  if (f < total) {
    const int64_t r = quotient(f, W);
    const int64_t k = f - r * W;
    const int64_t m = W - k;  // the chunk's elements in row r
    // the rows' starts and lengths, loaded together
    const int64_t s = __ldg(starts + r);
    const int64_t len = lens != nullptr ? (int64_t)__ldg(lens + r) : W;
    if (NARROW) {
      narrow(data, cap, starts, lens, total, W, f, r, k, s, len, b);
    } else {
      const bool next = m < CHUNK && f + m < total;  // the chunk enters row r + 1
      int64_t s1 = 0, len1 = 0;
      if (next) {
        s1 = __ldg(starts + r + 1);
        len1 = lens != nullptr ? (int64_t)__ldg(lens + r + 1) : W;
      }
      // row r's part: positions [0, min(m, 16)), cut at its length
      const int64_t n0 = len - k < m ? len - k : m;
      if (n0 > 0) window16(data, cap, s + k, 0, n0 < CHUNK ? (int)n0 : CHUNK, b);
      // row r + 1's part: positions [m, 16), cut at its length; nothing
      // is read past either length (more than half of a tweet column's
      // 320-byte window lies past its row's length)
      if (next && len1 > 0) {
        const int64_t n1 = len1 < CHUNK - m ? len1 : CHUNK - m;
        window16(data, cap, s1 - m, (int)m, (int)(m + n1), b);
      }
    }
  }
  if constexpr (sizeof(OutT) == 1) {
    if (f + CHUNK <= total) {
      *(uint4*)(out + f) = make_uint4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (f + i < total) out[f + i] = (OutT)((b[i >> 2] >> (8 * (i & 3))) & 0xffu);
    }
  } else {
    // int32: the warp's 32 chunks (512 bytes) go through its slice of
    // shared memory, so that each of a lane's four 16-byte stores lands
    // beside its neighbours' (512 contiguous bytes a warp store)
    __shared__ uint4 stage[BYTE_THREADS];
    const int lane = threadIdx.x & 31;
    const int64_t f0 = f - (int64_t)lane * CHUNK;  // the warp's first element
    if (f0 >= total) return;
    stage[threadIdx.x] = make_uint4(b[0], b[1], b[2], b[3]);
    __syncwarp();
    const uint32_t* words = (const uint32_t*)(stage + (threadIdx.x & ~31));
#pragma unroll
    for (int j = 0; j < CHUNK / 4; ++j) {
      const uint32_t w = words[32 * j + lane];
      const int64_t e = f0 + 128 * j + 4 * lane;
      const int32_t v[4] = {(int32_t)__byte_perm(w, 0, 0x4440), (int32_t)__byte_perm(w, 0, 0x4441),
                            (int32_t)__byte_perm(w, 0, 0x4442), (int32_t)__byte_perm(w, 0, 0x4443)};
      if (e + 4 <= total) {
        *(int4*)(out + e) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e + i < total) out[e + i] = v[i];
      }
    }
  }
}

template <typename OutT>
void launch_bytes(const uint8_t* data, int64_t cap, const int32_t* starts, const int32_t* lens,
                  int64_t total, int64_t W, OutT* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((total + BYTE_THREADS * CHUNK - 1) / (BYTE_THREADS * CHUNK));
  if (W < CHUNK)
    window_bytes<OutT, true><<<grid, BYTE_THREADS, 0, s>>>(data, cap, starts, lens, total, W, out);
  else
    window_bytes<OutT, false><<<grid, BYTE_THREADS, 0, s>>>(data, cap, starts, lens, total, W, out);
}

constexpr int WORD_THREADS = 256;
constexpr int WORDS_PER_THREAD = 4;

// the big-endian word of bytes [rel, rel + 4) of data[0, cap), 0 outside
__device__ __forceinline__ uint32_t be_word(const uint8_t* __restrict__ data,
                                            int64_t cap, int64_t rel) {
  const int mis = (int)(((uintptr_t)data + (uintptr_t)rel) & 3);
  const int64_t lo = rel - mis;  // data + lo is 4-byte aligned
  if (lo >= 0 && lo + (mis ? 8 : 4) <= cap) {
    const uint32_t* p = (const uint32_t*)(data + lo);
    const uint32_t w0 = __ldg(p);
    const uint32_t w1 = mis ? __ldg(p + 1) : 0u;
    return __byte_perm(__funnelshift_r(w0, w1, 8 * mis), 0, 0x0123);
  }
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t g = rel + i;
    const uint32_t b = (g >= 0 && g < cap) ? (uint32_t)data[g] : 0u;
    w |= b << (24 - 8 * i);
  }
  return w;
}

__global__ void __launch_bounds__(WORD_THREADS)
window_words(const uint8_t* __restrict__ data, int64_t cap,
             const int32_t* __restrict__ starts, int64_t total, int64_t Wq,
             uint32_t* __restrict__ out) {
  const int64_t f = ((int64_t)blockIdx.x * WORD_THREADS + threadIdx.x) *
                    WORDS_PER_THREAD;
  if (f >= total) return;
  int64_t r = quotient(f, Wq);
  int64_t q = f - r * Wq;
  int64_t s = starts[r];
  uint32_t w[WORDS_PER_THREAD];
  const int64_t rel = s + 4 * q;
  const int mis = (int)(((uintptr_t)data + (uintptr_t)rel) & 3);
  const int64_t lo = rel - mis;
  if (q + WORDS_PER_THREAD <= Wq && lo >= 0 && lo + (mis ? 20 : 16) <= cap) {
    // the four words lie in one row, inside the buffer: five aligned
    // loads (four when the window is aligned)
    const uint32_t* p = (const uint32_t*)(data + lo);
    uint32_t a[WORDS_PER_THREAD + 1];
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i) a[i] = __ldg(p + i);
    a[WORDS_PER_THREAD] = mis ? __ldg(p + WORDS_PER_THREAD) : 0u;
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i)
      w[i] = __byte_perm(__funnelshift_r(a[i], a[i + 1], 8 * mis), 0, 0x0123);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i) {
      if (i > 0 && ++q == Wq) {
        q = 0;
        if (f + i < total) s = starts[++r];
      }
      w[i] = f + i < total ? be_word(data, cap, s + 4 * q) : 0u;
    }
  }
  if (f + WORDS_PER_THREAD <= total) {
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD; k += 4)
      *(uint4*)(out + f + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS_PER_THREAD; ++i)
      if (f + i < total) out[f + i] = w[i];
  }
}

}  // namespace

extern "C" {

// out_int32: 0 -> uint8 output, 1 -> int32 output (one byte per element);
// lens: int32[rows] row lengths to mask at, or null for no mask
int cs_window_bytes(const void* data, int64_t cap, const void* starts,
                    const void* lens, int64_t rows, int64_t W, int out_int32,
                    void* out, void* stream) {
  if (rows <= 0 || W <= 0) return (int)cudaGetLastError();
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  if (out_int32)
    launch_bytes((const uint8_t*)data, cap, (const int32_t*)starts, (const int32_t*)lens, rows * W, W,
                 (int32_t*)out, (cudaStream_t)stream);
  else
    launch_bytes((const uint8_t*)data, cap, (const int32_t*)starts, (const int32_t*)lens, rows * W, W,
                 (uint8_t*)out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int cs_window_words(const void* data, int64_t cap, const void* starts,
                    int64_t rows, int64_t Wq, void* out, void* stream) {
  if (rows <= 0 || Wq <= 0) return (int)cudaGetLastError();
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int64_t total = rows * Wq;
  const int64_t per_block = (int64_t)WORD_THREADS * WORDS_PER_THREAD;
  window_words<<<(unsigned)((total + per_block - 1) / per_block), WORD_THREADS,
                 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, cap, (const int32_t*)starts, total, Wq,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
