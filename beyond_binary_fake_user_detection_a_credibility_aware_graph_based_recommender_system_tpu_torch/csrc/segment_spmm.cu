// Weighted segment-sum SpMM over a destination-sorted CSR, for Hopper (sm_90a).
//
//   y[d, :] = sum_{e in [indptr[d], indptr[d+1])} w[e] * x[src[e], :]
//
// Replaces the JAX package's Pallas kernels in ops/spmm_pallas.py:
// _segment_kernel (the plain block kernel) and _window_kernel (the same sum
// for high-degree destinations).  Those build a weighted one-hot (R x T) or
// (W x T) matrix per chunk of T dst-sorted edges and accumulate it against
// the gathered messages on the MXU.  Their R/T/W blocking is TPU VMEM and MXU
// layout; here the plan is just the CSR (indptr, src, w).
//
// What bounds it on an H100: bytes.  Per edge it reads one source row
// (D values), one int32 id and one fp32 weight and does 2*D flops, far below
// the ~20 flop/byte the fp32 units need to be the limit.  The least traffic
// is the referenced source rows, the edge arrays, indptr and one write of y.
//
// Design (a first, simple kernel):
//   * one warp per destination row, lanes across D (lane c owns columns
//     c, c+32, ...), so each source-row read is a coalesced 128-byte access
//     per 32 columns;
//   * the gather x[src[e]] happens here, inside the kernel;
//   * the warp loads 32 edge ids and weights with one coalesced load and
//     broadcasts them with shuffles, then walks the edges in CSR order;
//   * fp32 accumulation in a fixed per-row order, separate multiply and add
//     (no FMA contraction) and no atomics: two launches are bit-identical,
//     and the result equals a sequential sum of rounded products;
//   * every row is written, empty rows as exact zeros, so no memset;
//   * bf16 mode rounds the weight to bf16 as the Pallas kernel does
//     (onehot.astype(msg.dtype)); bf16 * bf16 is exact in fp32.
// Known limit: a hub row (21,252 edges at reference scale) serialises on one
// warp.  Splitting hub rows into fixed edge chunks reduced in a second pass
// in a fixed order is the first thing to fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_weight(float w, const float*) { return w; }
__device__ __forceinline__ float round_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TX, typename TY, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_spmm_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ src,
                    const float* __restrict__ w, const TX* __restrict__ x,
                    TY* __restrict__ y, int64_t num_dst, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_dst) return;  // warp-uniform: the whole warp leaves together

  float acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = 0.0f;

  const int64_t beg = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t base = beg; base < end; base += 32) {
    const int64_t e = base + lane;
    int32_t s = 0;
    float we = 0.0f;
    if (e < end) {
      s = src[e];
      we = round_weight(w[e], x);
    }
    const int64_t rem = end - base;
    const int n = rem < 32 ? (int)rem : 32;
    for (int k = 0; k < n; ++k) {
      const int32_t sk = __shfl_sync(0xffffffffu, s, k);
      const float wk = __shfl_sync(0xffffffffu, we, k);
      const TX* xr = x + (int64_t)sk * D;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int c = lane + 32 * j;
        if (c < D) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_float(xr[c])));
      }
    }
  }

  TY* yr = y + row * (int64_t)D;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    if (c < D) store(yr + c, acc[j]);
  }
}

template <typename TX, typename TY>
cudaError_t launch(const int64_t* indptr, const int32_t* src, const float* w, const void* x,
                   void* y, int64_t num_dst, int D, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
  if (D <= 32) {
    segment_spmm_kernel<TX, TY, 1><<<grid, block, 0, stream>>>(indptr, src, w, xt, yt, num_dst, D);
  } else if (D <= 64) {
    segment_spmm_kernel<TX, TY, 2><<<grid, block, 0, stream>>>(indptr, src, w, xt, yt, num_dst, D);
  } else if (D <= 128) {
    segment_spmm_kernel<TX, TY, 4><<<grid, block, 0, stream>>>(indptr, src, w, xt, yt, num_dst, D);
  } else if (D <= 256) {
    segment_spmm_kernel<TX, TY, 8><<<grid, block, 0, stream>>>(indptr, src, w, xt, yt, num_dst, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x_bf16 / y_bf16 select bf16 (1) or fp32 (0) for the table and the output.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int segment_spmm(const void* indptr, const void* src, const void* w, const void* x,
                            void* y, long long num_dst, int D, int x_bf16, int y_bf16,
                            void* stream) {
  const int64_t* ip = static_cast<const int64_t*>(indptr);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const float* wp = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_dst <= 0) return 0;
  if (x_bf16 && y_bf16) return (int)launch<__nv_bfloat16, __nv_bfloat16>(ip, sp, wp, x, y, num_dst, D, st);
  if (x_bf16) return (int)launch<__nv_bfloat16, float>(ip, sp, wp, x, y, num_dst, D, st);
  if (y_bf16) return (int)launch<float, __nv_bfloat16>(ip, sp, wp, x, y, num_dst, D, st);
  return (int)launch<float, float>(ip, sp, wp, x, y, num_dst, D, st);
}
