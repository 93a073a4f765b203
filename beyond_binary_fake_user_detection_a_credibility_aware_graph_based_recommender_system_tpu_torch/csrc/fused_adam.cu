// Fused Adam update of a list of fp32 parameter leaves in one launch, for
// Hopper (sm_90a).
//
//   m2 = B1*m + (1-B1)*g;  v2 = B2*v + (1-B2)*g*g;
//   p -= a*m2 / (sqrt(v2)*b + EPS),   a = lr/(1-B1^t),  b = 1/sqrt(1-B2^t)
//
// Replaces the Pallas kernel _adam_kernel behind pallas_adam_leaf
// (scripts/probe_fused_adam.py:60-86), which streams (R, D) blocks of p, g,
// m and v through VMEM and writes p, m and v, one pallas_call a leaf inside
// one jitted step (step_pallas, :89-99).  Here one launch covers every leaf
// of a step: the CUDA form of that one program.
//
// What bounds it on an H100: bytes for a large leaf, the launch for small
// ones.  Each element reads p, g, m, v and writes p, m, v (28 bytes) for
// about a dozen flops, far below the ~20 flop/byte the fp32 units need to be
// the limit: the least time is 28 * elements bytes over the HBM rate.  A
// Stage-A step updates ten leaves of 17,281 elements in all, where one
// launch a leaf cost ten launches' host issue for no device work.
//
// Design:
//   * a leaf table passed by value as a __grid_constant__ parameter (up to
//     kMaxLeaves leaves, ~1.8 KB of the 4 KB parameter space): pointers,
//     length, whether the leaf is 16-byte aligned, and a prefix of block
//     counts; the caller splits longer lists into several launches;
//   * each block owns one fixed chunk of kChunk = 4096 floats of one leaf
//     and finds its leaf by scanning the prefix (uniform across the block,
//     read from the constant bank);
//   * a 16-byte aligned leaf takes the float4 body: each thread issues all
//     of its loads (4 float4 of each of p, g, m, v: 16 independent 16-byte
//     loads) before any arithmetic, then its stores; the leaf's last block
//     also does the scalar tail of n % 4; a misaligned leaf takes the scalar
//     body (16 elements a thread, loads first) in the same launch;
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
constexpr int kVecPerThread = 4;                               // float4s a thread
constexpr int kChunk = kThreads * kVecPerThread * 4;           // floats a block
constexpr int kScalarPerThread = kChunk / kThreads;            // 16
constexpr int kMaxLeaves = 32;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int vec;  // all four pointers 16-byte aligned
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int64_t first_block[kMaxLeaves + 1];  // prefix of the leaves' block counts
  int num;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, float a,
                                          float b) {
  const float m2 = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  const float v2 = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float den = __fadd_rn(__fmul_rn(__fsqrt_rn(v2), b), kEps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a, m2), den));
  m = m2;
  v = v2;
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g, float4& m, float4& v,
                                         float a, float b) {
  adam_elem(p.x, g.x, m.x, v.x, a, b);
  adam_elem(p.y, g.y, m.y, v.y, a, b);
  adam_elem(p.z, g.z, m.z, v.z, a, b);
  adam_elem(p.w, g.w, m.w, v.w, a, b);
}

__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ LeafTable table, float a, float b) {
  const int64_t blk = blockIdx.x;
  int l = 0;
  while (l + 1 < table.num && table.first_block[l + 1] <= blk) ++l;
  const Leaf& lf = table.leaf[l];
  const int64_t start = (blk - table.first_block[l]) * kChunk;  // first float of the chunk
  const int t = threadIdx.x;
  if (lf.vec) {
    const int64_t n4 = lf.n >> 2;
    const int64_t base = start >> 2;
    float4* p4 = reinterpret_cast<float4*>(lf.p);
    const float4* g4 = reinterpret_cast<const float4*>(lf.g);
    float4* m4 = reinterpret_cast<float4*>(lf.m);
    float4* v4 = reinterpret_cast<float4*>(lf.v);
    float4 pp[kVecPerThread], gg[kVecPerThread], mm[kVecPerThread], vv[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int64_t i = base + k * kThreads + t;
      if (i < n4) {
        pp[k] = p4[i];
        gg[k] = __ldg(g4 + i);
        mm[k] = m4[i];
        vv[k] = v4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int64_t i = base + k * kThreads + t;
      if (i < n4) {
        adam_vec(pp[k], gg[k], mm[k], vv[k], a, b);
        p4[i] = pp[k];
        m4[i] = mm[k];
        v4[i] = vv[k];
      }
    }
    // the scalar tail (n % 4 floats) lies in the leaf's last chunk
    const int64_t i = (n4 << 2) + t;
    if (start + kChunk >= lf.n && i < lf.n) {
      float p = lf.p[i], m = lf.m[i], v = lf.v[i];
      adam_elem(p, lf.g[i], m, v, a, b);
      lf.p[i] = p;
      lf.m[i] = m;
      lf.v[i] = v;
    }
    return;
  }
  float pp[kScalarPerThread], gg[kScalarPerThread], mm[kScalarPerThread],
      vv[kScalarPerThread];
#pragma unroll
  for (int k = 0; k < kScalarPerThread; ++k) {
    const int64_t i = start + k * kThreads + t;
    if (i < lf.n) {
      pp[k] = lf.p[i];
      gg[k] = lf.g[i];
      mm[k] = lf.m[i];
      vv[k] = lf.v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kScalarPerThread; ++k) {
    const int64_t i = start + k * kThreads + t;
    if (i < lf.n) {
      adam_elem(pp[k], gg[k], mm[k], vv[k], a, b);
      lf.p[i] = pp[k];
      lf.m[i] = mm[k];
      lf.v[i] = vv[k];
    }
  }
}

}  // namespace

// One leaf as the caller passes it: device pointers and length in floats.
struct LeafArg {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long n;
};

// Updates every leaf's p, m and v in place on `stream` (of device `device`)
// in one launch.  At most kMaxLeaves leaves, each with n > 0.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int fused_adam_multi(const LeafArg* leaves, int num_leaves, float a, float b,
                                int device, void* stream) {
  if (num_leaves <= 0 || num_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable table;
  table.num = num_leaves;
  table.first_block[0] = 0;
  for (int i = 0; i < num_leaves; ++i) {
    const LeafArg& in = leaves[i];
    if (in.n <= 0) return (int)cudaErrorInvalidValue;
    const uintptr_t any = reinterpret_cast<uintptr_t>(in.p) | reinterpret_cast<uintptr_t>(in.g) |
                          reinterpret_cast<uintptr_t>(in.m) | reinterpret_cast<uintptr_t>(in.v);
    table.leaf[i] = Leaf{static_cast<float*>(in.p), static_cast<const float*>(in.g),
                         static_cast<float*>(in.m), static_cast<float*>(in.v),
                         (int64_t)in.n, (any % 16 == 0) ? 1 : 0};
    table.first_block[i + 1] = table.first_block[i] + (in.n + kChunk - 1) / kChunk;
  }
  const int64_t blocks = table.first_block[num_leaves];
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  fused_adam_multi_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, a, b);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
