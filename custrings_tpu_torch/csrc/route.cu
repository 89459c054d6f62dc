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
// Hopper a store to any address is one instruction, and the targets are
// monotone in j, so a warp's 32 stores land on a few neighbouring
// sectors: the routing network becomes one scatter per element.  Design:
// a grid-stride loop, one element per thread per step, coalesced reads of
// every input plane.  The compaction writes its own zero tail (every j
// from k0[n] on is a slot no kept element takes); the expansion's wrapper
// zero-fills its outputs, since the slots no element reaches are not
// known without a search.

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
expand_kernel(const uint8_t* __restrict__ live, const int32_t* __restrict__ dist,
              const T* __restrict__ in, int64_t n, int64_t out_cap,
              T* __restrict__ out, uint8_t* __restrict__ placed) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < n;
       j += stride) {
    if (!live[j]) continue;
    const int64_t t = j + (int64_t)dist[j];
    if (t < 0 || t >= out_cap) continue;
    out[t] = in[j];
    if (placed != nullptr) placed[t] = 1;
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

// placed may be null (then only the values move); out and placed must be
// zero-filled by the caller
int cs_expand(const void* live, const void* dist, const void* in, int64_t n,
              int64_t out_cap, int elem_bytes, void* out, void* placed,
              void* stream) {
  if (n <= 0 || out_cap <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* lp = (const uint8_t*)live;
  const int32_t* d = (const int32_t*)dist;
  uint8_t* pl = (uint8_t*)placed;
  switch (elem_bytes) {
    case 1:
      expand_kernel<uint8_t><<<grid_for(n), THREADS, 0, s>>>(
          lp, d, (const uint8_t*)in, n, out_cap, (uint8_t*)out, pl);
      break;
    case 4:
      expand_kernel<uint32_t><<<grid_for(n), THREADS, 0, s>>>(
          lp, d, (const uint32_t*)in, n, out_cap, (uint32_t*)out, pl);
      break;
    case 8:
      expand_kernel<uint64_t><<<grid_for(n), THREADS, 0, s>>>(
          lp, d, (const uint64_t*)in, n, out_cap, (uint64_t*)out, pl);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
