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
//   * L2 (route 1): the rows are read where they are; a slab of 0.1-4 MB
//     stays in the 50 MB L2 after its first touch;
//   * shared memory (route 0), for slabs up to kMaxSmemSlabBytes (192 KiB:
//     S <= 768 at D = 64): every CTA holds the whole slab in its shared
//     memory and serves its rows from there.  The CTAs run as thread-block
//     clusters of 1, 2, 4 or 8: each CTA of a cluster issues a 1/cluster
//     share of the slab as 1-D bulk copies multicast to every CTA of the
//     cluster (cp.async.bulk ... .multicast::cluster), and waits on an
//     mbarrier that expects the whole slab's bytes, so the L2 serves the
//     slab once per cluster, not once per CTA.  A slab that is not 16-byte
//     aligned (address or size) is loaded by the CTA's threads instead, in
//     the same kernel: the caller says which (ops/row_gather_cuda.py
//     smem_load), and a bulk load asked for a misaligned slab is refused.
//
// What bounds it: bytes.  A copy: the slab read once, idx read once, out
// written once; no arithmetic.  The output write dominates (N*D*4 bytes,
// 8-268 MB at the probe's sizes).  Both routes:
//   * a persistent grid (two CTAs a SM for L2; one a SM, or as many
//     clusters as fit at once, for shared memory), each warp walking chunks
//     of 32 output rows;
//   * a chunk's 32 ids read by one coalesced load, one per lane, and handed
//     to the lanes that copy each row with __shfl_sync;
//   * rows moved as float4 when D is 4, 8, ..., 128 and the pointers allow:
//     D/4 lanes a row, 32/(D/4) rows a warp instruction (two at D = 64), four
//     such steps issued before their stores; otherwise a warp a row, scalar;
//   * the output written with streaming stores (st.global.cs), so it does
//     not push the slab out of L2.
// The per-device set-up (SM count, the shared-memory opt-in, how many
// clusters of each size fit at once) runs once per device, not per launch.
// The kernel does not check idx: an index outside [0, S) reads outside x.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kL2Threads = 512;
constexpr int kL2BlocksPerSm = 2;
constexpr int kSmemThreads = 1024;
constexpr int kChunkRows = 32;                      // a warp's rows per id load
constexpr int kMaxSmemSlabBytes = 192 * 1024;
constexpr uint32_t kBulkPiece = 32 * 1024;          // bytes per bulk copy
constexpr int kClusterSizes[4] = {1, 2, 4, 8};
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <bool kShared, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// out rows [i0, i0 + cnt), cnt <= 32, each D = 4*VPR floats; VPR divides 32
template <int VPR, bool kShared>
__device__ __forceinline__ void copy_chunk_vec(const float4* src, const int32_t* __restrict__ idx,
                                               float4* __restrict__ out, int64_t i0, int cnt,
                                               int lane) {
  constexpr int kRowsPerStep = 32 / VPR;
  constexpr int kSteps = kChunkRows / kRowsPerStep;
  constexpr int kUnroll = kSteps < 4 ? kSteps : 4;
  const int my = lane < cnt ? __ldcs(idx + i0 + lane) : 0;
  const int sub = lane / VPR;
  const int c = lane % VPR;
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kUnroll) {
    float4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = (s0 + u) * kRowsPerStep + sub;
      const int id = __shfl_sync(kFull, my, r & 31);
      if (r < cnt) buf[u] = load<kShared>(src + (int64_t)id * VPR + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = (s0 + u) * kRowsPerStep + sub;
      if (r < cnt) __stcs(out + (i0 + r) * VPR + c, buf[u]);
    }
  }
}

// the same with a warp a row, scalar: any D and alignment
template <bool kShared>
__device__ __forceinline__ void copy_chunk_scalar(const float* src, const int32_t* __restrict__ idx,
                                                  float* __restrict__ out, int64_t i0, int cnt,
                                                  int D, int lane) {
  const int my = lane < cnt ? __ldcs(idx + i0 + lane) : 0;
  for (int r = 0; r < cnt; ++r) {  // cnt is the same across the warp
    const int id = __shfl_sync(kFull, my, r);
    const float* s = src + (int64_t)id * D;
    float* d = out + (i0 + r) * D;
    for (int c = lane; c < D; c += 32) __stcs(d + c, load<kShared>(s + c));
  }
}

// every chunk of 32 output rows from `warp` on, `warps` apart
template <int VPR, bool kShared>
__device__ __forceinline__ void gather_chunks(const float* src, const int32_t* __restrict__ idx,
                                              float* __restrict__ out, int64_t N, int D,
                                              int64_t warp, int64_t warps, int lane) {
  const int64_t chunks = (N + kChunkRows - 1) / kChunkRows;
  for (int64_t ch = warp; ch < chunks; ch += warps) {
    const int64_t i0 = ch * kChunkRows;
    const int cnt = (int)(N - i0 < kChunkRows ? N - i0 : kChunkRows);
    if constexpr (VPR > 0)
      copy_chunk_vec<VPR, kShared>(reinterpret_cast<const float4*>(src), idx,
                                   reinterpret_cast<float4*>(out), i0, cnt, lane);
    else
      copy_chunk_scalar<kShared>(src, idx, out, i0, cnt, D, lane);
  }
}

template <int VPR>
__global__ void __launch_bounds__(kL2Threads, kL2BlocksPerSm)
gather_l2(const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
          int64_t N, int D) {
  constexpr int kWarps = kL2Threads / 32;
  gather_chunks<VPR, false>(x, idx, out, N, D, (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5),
                            (int64_t)gridDim.x * kWarps, threadIdx.x & 31);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// bulk != 0: x and S*D*4 are 16-byte aligned, and the slab arrives by bulk
// copies multicast across the cluster; otherwise each CTA loads it itself
template <int VPR>
__global__ void __launch_bounds__(kSmemThreads, 1)
gather_smem(const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
            int64_t N, int S, int D, int bulk) {
  extern __shared__ __align__(128) float4 slab4[];
  __shared__ __align__(8) uint64_t bar;
  float* slab = reinterpret_cast<float*>(slab4);
  const int64_t n = (int64_t)S * D;
  if (bulk) {
    const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();  // every CTA's barrier is set up before any copy lands on it
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)(n * 4);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr),
                   "r"(bytes)
                   : "memory");
      const uint32_t ncta = cluster_size();
      const uint32_t share = (bytes / 16 + ncta - 1) / ncta * 16;
      const uint32_t lo = min(bytes, cluster_rank() * share);
      const uint32_t hi = min(bytes, lo + share);
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slab);
      const char* src = reinterpret_cast<const char*>(x);
      const uint16_t mask = (uint16_t)((1u << ncta) - 1);
      for (uint32_t off = lo; off < hi; off += kBulkPiece) {
        const uint32_t len = min(kBulkPiece, hi - off);
        if (ncta == 1)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];" ::"r"(dst + off),
              "l"(src + off), "r"(len), "r"(bar_addr)
              : "memory");
        else
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
              ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst + off),
              "l"(src + off), "r"(len), "r"(bar_addr), "h"(mask)
              : "memory");
      }
    }
    mbarrier_wait(bar_addr, 0);
  } else {
    for (int64_t k = threadIdx.x; k < n; k += kSmemThreads) slab[k] = x[k];
    __syncthreads();
  }
  constexpr int kWarps = kSmemThreads / 32;
  gather_chunks<VPR, true>(slab, idx, out, N, D, (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5),
                           (int64_t)gridDim.x * kWarps, threadIdx.x & 31);
  cluster_sync();  // no CTA leaves while a peer of its cluster may still use it
}

struct DeviceSetup {
  int sms = 0;
  int smem_clusters[4] = {0, 0, 0, 0};  // clusters of each size that fit at once
  cudaError_t err = cudaSuccess;
};

DeviceSetup g_setup[kMaxDevices];
std::atomic<bool> g_ready[kMaxDevices];
std::mutex g_setup_mutex;

template <int VPR>
cudaError_t allow_slab_smem() {
  return cudaFuncSetAttribute(gather_smem<VPR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmemSlabBytes);
}

// once per device (the caller has made it current)
const DeviceSetup& device_setup(int device) {
  if (g_ready[device].load(std::memory_order_acquire)) return g_setup[device];
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  DeviceSetup& s = g_setup[device];
  if (g_ready[device].load(std::memory_order_relaxed)) return s;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess && optin < kMaxSmemSlabBytes + 64) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = allow_slab_smem<0>();
  if (err == cudaSuccess) err = allow_slab_smem<1>();
  if (err == cudaSuccess) err = allow_slab_smem<2>();
  if (err == cudaSuccess) err = allow_slab_smem<4>();
  if (err == cudaSuccess) err = allow_slab_smem<8>();
  if (err == cudaSuccess) err = allow_slab_smem<16>();
  if (err == cudaSuccess) err = allow_slab_smem<32>();
  for (int c = 0; c < 4 && err == cudaSuccess; ++c) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterSizes[c];
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kClusterSizes[c] * s.sms);
    cfg.blockDim = dim3(kSmemThreads);
    cfg.dynamicSmemBytes = kMaxSmemSlabBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&s.smem_clusters[c], gather_smem<16>, &cfg);
  }
  s.err = err;
  g_ready[device].store(true, std::memory_order_release);
  return s;
}

template <int VPR>
cudaError_t launch(const float* x, const int32_t* idx, float* out, int64_t N, int S, int D,
                   int route, int cluster, int bulk, const DeviceSetup& s, cudaStream_t st) {
  const int64_t chunks = (N + kChunkRows - 1) / kChunkRows;
  if (route == 1) {
    constexpr int kWarps = kL2Threads / 32;
    int64_t grid = (chunks + kWarps - 1) / kWarps;
    if (grid > (int64_t)kL2BlocksPerSm * s.sms) grid = (int64_t)kL2BlocksPerSm * s.sms;
    gather_l2<VPR><<<(unsigned)grid, kL2Threads, 0, st>>>(x, idx, out, N, D);
    return cudaGetLastError();
  }
  int c = 0;
  while (c < 4 && kClusterSizes[c] != cluster) ++c;
  if (c == 4) return cudaErrorInvalidValue;
  const int64_t fit = (int64_t)s.smem_clusters[c];
  if (fit <= 0) return cudaErrorInvalidConfiguration;
  constexpr int kWarps = kSmemThreads / 32;
  int64_t clusters = ((chunks + kWarps - 1) / kWarps + cluster - 1) / cluster;
  if (clusters > fit) clusters = fit;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(kSmemThreads);
  cfg.dynamicSmemBytes = ((size_t)S * D * 4 + 15) / 16 * 16;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gather_smem<VPR>, x, idx, out, N, S, D, bulk);
}

}  // namespace

// route: 0 = shared memory (the slab within kMaxSmemSlabBytes; cluster 1, 2,
// 4 or 8; bulk = 1: the slab by multicast bulk copies, which needs x and
// S*D*4 16-byte aligned, bulk = 0: by the CTA's threads), 1 = L2 (cluster
// and bulk ignored).  Launches on `stream` of `device`.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int row_gather(const void* x, const void* idx, void* out, long long N, int S, int D,
                          int route, int cluster, int bulk, int device, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || D <= 0 || (route != 0 && route != 1) || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int64_t bytes = (int64_t)S * D * 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (route == 0 && (bytes > kMaxSmemSlabBytes || (bulk && (xa % 16 != 0 || bytes % 16 != 0))))
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const DeviceSetup& s = device_setup(device);
  err = s.err;
  if (err == cudaSuccess) {
    const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
    // float4 rows: D/4 lanes a row must divide the warp; a shared-memory
    // slab is aligned whatever x is
    const int vpr = D / 4;
    const bool vec = D % 4 == 0 && vpr <= 32 && (32 % vpr) == 0 && oa % 16 == 0 &&
                     (route == 0 || xa % 16 == 0);
    const float* xp = static_cast<const float*>(x);
    const int32_t* ip = static_cast<const int32_t*>(idx);
    float* op = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (vec ? vpr : 0) {
      case 1: err = launch<1>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      case 2: err = launch<2>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      case 4: err = launch<4>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      case 8: err = launch<8>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      case 16: err = launch<16>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      case 32: err = launch<32>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
      default: err = launch<0>(xp, ip, op, N, S, D, route, cluster, bulk, s, st); break;
    }
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
