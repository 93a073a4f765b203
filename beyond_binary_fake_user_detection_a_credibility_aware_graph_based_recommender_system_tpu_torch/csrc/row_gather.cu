// Row gather from a small slab, for Hopper (sm_90a).
//
//   out[i, :] = x[idx[i], :]      x: (S, D) fp32, idx: (N,) int32 in [0, S)
//
// Replaces the JAX package's Pallas probe kernel `kernel` behind `probe.call`
// in scripts/probe_vmem_gather.py:29-45 (P4): a grid of G steps, each
// gathering S rows with jnp.take_along_axis from the (S, D) slab held in
// VMEM.  That probe asked whether a gather from on-chip memory beats the
// HBM gather; on the H100 the same question has two answers, one route each:
//
//   * L2 (the wrapper's route): slabs of 0.5-4 MB, as in the probe, cannot
//     sit in one SM's shared memory but stay in the 50 MB L2; one warp per
//     output row reads the source row directly, float2 per lane (one
//     256-byte row per warp instruction at D = 64);
//   * shared memory (asked for by the probe only): every CTA stages the
//     whole slab in shared memory (one CTA per SM, the slab read once per
//     CTA from L2), then serves its share of the rows from there.  For
//     slabs up to SMEM_SLAB_BYTES (192 KiB: S <= 768 at D = 64), inside the
//     227 KB opt-in limit.  It measured no faster than the L2 route.
//
// What bounds it: bytes.  A copy: the slab read once, idx read once, out
// written once; no arithmetic.  The output write dominates (N*D*4 bytes).
// The kernel does not check idx: an index outside [0, S) reads outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemThreads = 1024;
constexpr int kSmemWarps = kSmemThreads / 32;

// copy one row of D floats with one warp; float2 when the rows allow it
template <bool VEC2>
__device__ __forceinline__ void copy_row(const float* __restrict__ s, float* __restrict__ d,
                                         int D, int lane) {
  if (VEC2) {
    const float2* s2 = reinterpret_cast<const float2*>(s);
    float2* d2 = reinterpret_cast<float2*>(d);
    for (int c = lane; c < D / 2; c += 32) d2[c] = s2[c];
  } else {
    for (int c = lane; c < D; c += 32) d[c] = s[c];
  }
}

template <bool VEC2>
__global__ void __launch_bounds__(kThreads)
gather_l2(const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
          int64_t N, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;
  copy_row<VEC2>(x + (int64_t)idx[i] * D, out + i * D, D, lane);
}

template <bool VEC2>
__global__ void __launch_bounds__(kSmemThreads)
gather_smem(const float* __restrict__ x, const int32_t* __restrict__ idx,
            float* __restrict__ out, int64_t N, int S, int D) {
  extern __shared__ float4 s_slab4[];
  float* s_slab = reinterpret_cast<float*>(s_slab4);
  const int64_t n = (int64_t)S * D;
  if (VEC2 && (n & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t k = threadIdx.x; k < n / 4; k += kSmemThreads) s_slab4[k] = x4[k];
  } else {
    for (int64_t k = threadIdx.x; k < n; k += kSmemThreads) s_slab[k] = x[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kSmemWarps;
  for (int64_t i = (int64_t)blockIdx.x * kSmemWarps + (threadIdx.x >> 5); i < N; i += stride)
    copy_row<VEC2>(s_slab + (int64_t)idx[i] * D, out + i * D, D, lane);
}

}  // namespace

// route: 0 = shared memory (the slab must fit the opt-in limit), 1 = L2.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int row_gather(const void* x, const void* idx, void* out, long long N, int S, int D,
                          int route, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec2 = (D % 2 == 0) && (reinterpret_cast<uintptr_t>(x) & 7) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  if (route == 1) {
    const unsigned grid = (unsigned)((N + kWarps - 1) / kWarps);
    if (vec2) gather_l2<true><<<grid, kThreads, 0, st>>>(xp, ip, op, N, D);
    else gather_l2<false><<<grid, kThreads, 0, st>>>(xp, ip, op, N, D);
    return (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)S * D * sizeof(float);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int64_t want = (N + kSmemWarps - 1) / kSmemWarps;
  const unsigned grid = (unsigned)(want < sms ? want : sms);
  if (vec2) {
    err = cudaFuncSetAttribute(gather_smem<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gather_smem<true><<<grid, kSmemThreads, bytes, st>>>(xp, ip, op, N, S, D);
  } else {
    err = cudaFuncSetAttribute(gather_smem<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gather_smem<false><<<grid, kSmemThreads, bytes, st>>>(xp, ip, op, N, S, D);
  }
  return (int)cudaGetLastError();
}
