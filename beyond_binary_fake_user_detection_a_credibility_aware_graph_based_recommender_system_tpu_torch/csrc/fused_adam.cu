// Fused Adam update of one fp32 parameter leaf, for Hopper (sm_90a).
//
//   m2 = B1*m + (1-B1)*g;  v2 = B2*v + (1-B2)*g*g;
//   p -= a*m2 / (sqrt(v2)*b + EPS),   a = lr/(1-B1^t),  b = 1/sqrt(1-B2^t)
//
// Replaces the Pallas kernel _adam_kernel behind pallas_adam_leaf
// (scripts/probe_fused_adam.py:60-86), which streams (R, D) blocks of p, g,
// m and v through VMEM and writes p, m and v.  Here there is no block plan:
// the leaf is a flat array of N*D floats.
//
// What bounds it on an H100: bytes.  Each element reads p, g, m, v and
// writes p, m, v (28 bytes) for about a dozen flops, far below the ~20
// flop/byte the fp32 units need to be the limit.  The least time is 28*N*D
// bytes over the HBM rate.
//
// Design (a first, simple kernel):
//   * one pass: each element is read once and written once, in place;
//   * 16-byte (float4) loads and stores when all four arrays are 16-byte
//     aligned, a scalar tail for N*D % 4, a scalar loop otherwise;
//   * a grid-stride loop over a capped grid, so any N*D takes one launch;
//   * separate rounded multiply, add, divide and square root (__fmul_rn,
//     __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc contracts no FMA, so the
//     result equals the plain PyTorch version (one op at a time) bit for bit
//     and two launches are bit-identical;
//   * a and b are computed on the host in fp32, as the probe does, and
//     passed by value.
// The constants are JAX's: Python doubles rounded to fp32, 1-0.9 -> 0.1f and
// 1-0.999 -> 0.001f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = 0.1f;
constexpr float kOneMinusB2 = 0.001f;
constexpr float kEps = 1e-8f;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, float a,
                                          float b) {
  const float m2 = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  const float v2 = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float den = __fadd_rn(__fmul_rn(__fsqrt_rn(v2), b), kEps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a, m2), den));
  m = m2;
  v = v2;
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, int64_t n, float a, float b, int vec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {  // uniform across the grid
    const int64_t n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      adam_elem(pp.x, gg.x, mm.x, vv.x, a, b);
      adam_elem(pp.y, gg.y, mm.y, vv.y, a, b);
      adam_elem(pp.z, gg.z, mm.z, vv.z, a, b);
      adam_elem(pp.w, gg.w, mm.w, vv.w, a, b);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_elem(pp, g[i], mm, vv, a, b);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// Updates p, m and v (n floats each, device pointers) in place on `stream`.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int fused_adam(void* p, const void* g, void* m, void* v, long long n, float a,
                          float b, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  const int vec = (any % 16 == 0) ? 1 : 0;
  const int64_t work = vec ? (n >> 2) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_adam_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), (int64_t)n, a, b, vec);
  return (int)cudaGetLastError();
}
