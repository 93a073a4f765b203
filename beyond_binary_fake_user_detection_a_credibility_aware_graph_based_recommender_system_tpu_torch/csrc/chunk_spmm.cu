// Edge-chunked weighted segment-sum SpMM over a block/chunk plan, for Hopper
// (sm_90a).
//
//   out[b*R + ws + lid[e], :] += w[e] * x[src[e], :]   for every real edge e
//
// over the plan of ops/segment_plan.py: destination rows cut into blocks of
// R rows, each block's dst-sorted edges cut into chunks of T edges (a window
// plan confines a chunk's rows to W rows from an 8-aligned win_start).  The
// output is the whole (num_blocks*R, D) fp32 block space.  The table x is
// fp32 or, for P1 and P3, bf16 (the JAX package's msg_dtype="bfloat16",
// ops/spmm_pallas.py:459-460): then the weight is rounded to bf16 too
// (onehot.astype(msg.dtype), :423), each product bf16(w) * bf16(x) is exact
// in fp32 and the sums are fp32, as the MXU's fp32 accumulation.
//
// Replaces the JAX package's Pallas probe kernels that run such plans:
//   chunk_spmm_block  (P3) apply_nopad_trunc, scripts/probe_kernel_grid.py:128
//                     (body _segment_kernel, ops/spmm_pallas.py:406), and the
//                     "base" variant of the window probe;
//   chunk_spmm_window (P1) apply_window, scripts/probe_window_kernel.py:127
//                     (body _window_kernel :109);
//   chunk_spmm_i16    (P2) apply_i16, scripts/probe_window_kernel.py:182
//                     (body _i16_kernel :166): the same sum reading a 2-byte
//                     local-id stream.
// There each chunk builds a weighted (R x T) or (W x T) one-hot and adds
// onehot @ msg into the block's VMEM accumulator on the MXU, one chunk per
// sequential grid step.
//
// What bounds it on an H100: bytes.  Per edge it reads one source row, a
// source id, a weight and a local id, and does 2*D flops; the least traffic
// is the referenced source rows, the plan arrays and one write of the block
// space (at item<-user, D = 64: ~86 MB, 67 MB of it the block space, 70% of
// whose rows are empty and written as zeros).
//
// Why not tensor cores: a one-hot product does R (or W) times the flops the
// sum needs, and runs in TF32, which would break the fp32 edge-order sum
// that the plain version (ops/chunk_spmm.py) and its tests hold the kernel
// to bit for bit.
//
// All three entries run chunk_staged_kernel, one template (WINDOW, TL the
// local-id type: int32_t, or int16_t for P2, and XT the table's type: float,
// or __nv_bfloat16 for P1 and P3), one launch per application.
//   * A persistent grid (the SMs times the CTAs that fit on one: three at
//     T = 256) walks items, (chunk g = blockIdx.x + k*gridDim.x, column tile
//     of CW fp32).  While a CTA sums one item, the next item's source rows
//     are in flight into a second buffer, and the plan of the chunk after
//     next (local ids, source ids, weights, its meta row) arrives by
//     cp.async.bulk on an mbarrier into a second stage, so neither the
//     gather nor the plan load waits in line, and the CTA's launch and
//     set-up are paid once.  A bulk copy moves whole 16-byte words, so a
//     T whose ids do not fill them (T % 4 for int32 ids, T % 8 for int16
//     ones) has its plan loaded by the threads.
//   * P2's int16 ids only shrink a chunk's plan by 2*T bytes (about 1% of
//     the traffic at item<-user): on the TPU they also narrowed the one-hot
//     compare, which has no counterpart here.  In the stage the ids come
//     first, padded to 16 bytes, so what follows them stays aligned.
//   * The chunk's dst-sorted edges are split into row runs (ballot and a
//     prefix count in shared memory).
//   * Its real source rows x[src[e]] are staged in shared memory by all 256
//     threads with cp.async: 16-byte copies through L1 (a popular source row
//     is read again from there), or 4-byte copies for a table that is not
//     16-byte aligned or a D that is not a multiple of 4 (the wrapper
//     decides, the C entry refuses a wrong choice); the pad tail is never
//     read.  A buffer is 32 KB: CW = 32 at T = 256 (D = 64 in two tiles),
//     at most 64, at least 8 (T = 1024), so any D <= 256 fits.  A bf16 table
//     is staged as it is, in half the bytes (8-byte copies of 4 columns, or
//     plain 2-byte loads when D % 4 or the table is not 8-byte aligned), and
//     each value is widened to fp32 (exact) where the sums read it.
//   * Threads map to (run, 16-byte column run) pairs: at CW = 32, 8 threads
//     a run and 32 runs at a time.  Each sums its run in edge order from 0
//     with __fmul_rn / __fadd_rn from shared memory: a 256-edge hub run is
//     256 shared-memory reads, not 32 round trips to device memory.  Runs
//     are never split, so the order is the plain version's.
//   * Every block-space row is written once: run sums by 16-byte streaming
//     stores; the rows between runs, before a block's first row and after
//     its last (a chunk owns the rows from its first row, or its block's
//     first, to the next chunk's first row) by bulk stores of a shared
//     buffer of zeros, a thread a gap, which the copy engine writes while
//     the CTA goes on (4-byte stores when D % 4).
//   * A row that runs across chunks (its span, from the chunk whose last
//     run opens it to the last chunk whose first run holds it) is summed in
//     parts: each chunk writes its part to a (2G, D) buffer, fences, and
//     adds one to the span's integer counter (zeroed by the C entry before
//     each launch); the CTA that brings the last part sums the span's parts
//     in chunk order from 0, read through L2 (ld.global.cg), and writes the
//     row.  The spans come from the plan (SegmentPlan.chunk_meta, built once
//     per plan), so no CTA searches the parts.  No float atomics: two
//     launches are bit-identical and equal the plain version.
//   * Pad edges (local id == R, or == W in a window plan) are skipped, never
//     multiplied by their zero weight: b*R + ws + lid would alias them into
//     a real row, and 0 * inf is NaN.  The chunk's pad edges must form its
//     tail (the planner's layout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 1024;            // chunk edges one CTA's masks cover
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBufFloats = 8192;       // one buffer of staged rows: 32 KB
constexpr int kMaxDevices = 64;
constexpr int kMeta = 8;               // ints of a chunk's meta row
constexpr int kZeroBytes = 2048;       // shared zeros a bulk store copies

// column tile of the staged rows: a multiple of 4 in [8, 64], at most
// kBufFloats / T, and no wider than D needs
inline int column_tile(int T, int D) {
  int cw = (kBufFloats / T) & ~3;
  if (cw > 64) cw = 64;
  if (cw < 8) cw = 8;
  const int d4 = (D + 3) & ~3;
  return d4 < cw ? d4 : cw;
}

// A chunk's plan stage in shared memory: its T local ids of tl bytes each,
// padded to 16 bytes, then T source ids, T weights and its meta row; a
// stage is a multiple of 16 bytes, so the second one is aligned too.
__host__ __device__ constexpr int lid_bytes(int T, int tl) { return (T * tl + 15) & ~15; }
__host__ __device__ constexpr int stage_bytes(int T, int tl) {
  return (lid_bytes(T, tl) + 8 * T + kMeta * 4 + 15) & ~15;
}

// dynamic shared memory: two buffers of staged rows (T x CW values of xs
// bytes each), two plan stages, the run starts
inline size_t staged_smem_bytes(int T, int CW, int tl, int xs) {
  return 2 * (size_t)T * CW * xs + 2 * (size_t)stage_bytes(T, tl) + ((size_t)T + 1) * 4;
}
constexpr size_t kMaxBufFloats = kBufFloats > 8 * kMaxT ? kBufFloats : 8 * kMaxT;
constexpr size_t kMaxStagedSmem =
    2 * kMaxBufFloats * 4 + 2 * (size_t)stage_bytes(kMaxT, 4) + (kMaxT + 1) * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async8(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
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

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The per-chunk arrays the kernel reads: source ids, weights, local ids
// (TL) and the meta rows (ops/segment_plan.py chunk_meta: block, first
// block-space row of its window, the row that ends its rows, first | last
// << 1 | cont_in << 2 | opens << 3, the first chunk and length of the span
// its first run continues, the length of the span its last run opens, 0).
template <typename TL>
struct Plan {
  const int32_t* src;
  const float* w;
  const TL* lid;
  const int32_t* meta;
};

// one plan stage, laid out as lid_bytes / stage_bytes say
template <typename TL>
struct Stage {
  unsigned char* p;
  int lb;  // lid_bytes(T, sizeof(TL))
  int T;
  __device__ __forceinline__ TL* lid() const { return reinterpret_cast<TL*>(p); }
  __device__ __forceinline__ int32_t* src() const { return reinterpret_cast<int32_t*>(p + lb); }
  __device__ __forceinline__ float* w() const { return reinterpret_cast<float*>(p + lb + 4 * T); }
  __device__ __forceinline__ int32_t* meta() const {
    return reinterpret_cast<int32_t*>(p + lb + 8 * T);
  }
};

template <typename TL>
__device__ __forceinline__ Stage<TL> stage_at(unsigned char* s_plan, int st, int T) {
  return {s_plan + st * stage_bytes(T, sizeof(TL)), lid_bytes(T, sizeof(TL)), T};
}

// chunk g's plan into a stage: one thread issues bulk copies on the
// stage's mbarrier (bulk: then T * sizeof(TL) is a multiple of 16 and the
// ids fill their part of the stage), or all threads load it (then a
// barrier)
template <typename TL>
__device__ __forceinline__ void load_plan(bool bulk, uint32_t bar, const Stage<TL>& st,
                                          const Plan<TL>& p, int64_t g, int T) {
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)T * 4;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(st.lb + 2 * bytes + kMeta * 4)
                   : "memory");
      const uint32_t dst = smem_addr(st.p);
      bulk_copy(dst, p.lid + g * T, st.lb, bar);
      bulk_copy(dst + st.lb, p.src + g * T, bytes, bar);
      bulk_copy(dst + st.lb + bytes, p.w + g * T, bytes, bar);
      bulk_copy(dst + st.lb + 2 * bytes, p.meta + g * kMeta, kMeta * 4, bar);
    }
    return;
  }
  TL* lid = st.lid();
  int32_t* src = st.src();
  int32_t* w = reinterpret_cast<int32_t*>(st.w());
  for (int e = threadIdx.x; e < T; e += kThreads) {
    lid[e] = p.lid[g * T + e];
    src[e] = p.src[g * T + e];
    w[e] = reinterpret_cast<const int32_t*>(p.w)[g * T + e];
  }
  if (threadIdx.x < kMeta) st.meta()[threadIdx.x] = p.meta[g * kMeta + threadIdx.x];
}

// chunk g's plan is in its stage (the n-th use of the stage waits for
// phase n & 1)
__device__ __forceinline__ void plan_ready(bool bulk, uint32_t bar, int use) {
  if (bulk) mbar_wait(bar, (uint32_t)use & 1u);
  else __syncthreads();
}

// bytes (a multiple of 16) of zeros from shared memory to dst (16-byte
// aligned), by the copy engine: the thread goes on at once
__device__ __forceinline__ void bulk_zero(char* dst, int64_t bytes, const void* zeros) {
  for (int64_t off = 0; off < bytes; off += kZeroBytes) {
    const uint32_t n = (uint32_t)(bytes - off < kZeroBytes ? bytes - off : kZeroBytes);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst + off),
                 "r"(smem_addr(zeros)), "r"(n)
                 : "memory");
  }
}

// n <= 4 columns of a row (n == 4 and 16-byte aligned when vec)
__device__ __forceinline__ void store_cols(float* out, float4 v, int n, bool vec, bool stream) {
  if (vec) {
    if (stream) __stcs(reinterpret_cast<float4*>(out), v);
    else __stcg(reinterpret_cast<float4*>(out), v);
    return;
  }
  if (n > 0) stream ? __stcs(out, v.x) : __stcg(out, v.x);
  if (n > 1) stream ? __stcs(out + 1, v.y) : __stcg(out + 1, v.y);
  if (n > 2) stream ? __stcs(out + 2, v.z) : __stcg(out + 2, v.z);
  if (n > 3) stream ? __stcs(out + 3, v.w) : __stcg(out + 3, v.w);
}

// four staged values from 4 * i on (16-byte aligned for fp32, 8 for bf16),
// as fp32
__device__ __forceinline__ float4 load4(const float* buf, int i) {
  return reinterpret_cast<const float4*>(buf)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* buf, int i) {
  const uint2 r = reinterpret_cast<const uint2*>(buf)[i];
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// an edge's weight as the sum multiplies it: rounded to bf16 for a bf16 table
__device__ __forceinline__ float msg_weight(float w, const float*) { return w; }
__device__ __forceinline__ float msg_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// column tile [c0, c0 + cw) of chunk's real source rows into a buffer
template <bool XVEC, typename TL, typename XT>
__device__ __forceinline__ void stage_rows(XT* buf, const TL* s_lid, const int32_t* s_src,
                                           const XT* __restrict__ x, int T, int limit, int D,
                                           int CW, int c0) {
  const int cw = D - c0 < CW ? D - c0 : CW;
  // a thread keeps one 16-byte column run (or column) of every per-th edge
  const int n = XVEC ? cw >> 2 : cw;
  const int per = kThreads / n;
  const int e0 = threadIdx.x / n, q = threadIdx.x - e0 * n;
  if (e0 >= per) return;
  for (int e = e0; e < T; e += per) {
    if (s_lid[e] >= limit) break;  // the pad tail
    const XT* from = x + (int64_t)s_src[e] * D + c0;
    if constexpr (sizeof(XT) == 2) {
      if (XVEC) cp_async8(buf + e * CW + 4 * q, from + 4 * q);
      else buf[e * CW + q] = from[q];
    } else {
    if (XVEC) cp_async16(buf + e * CW + 4 * q, from + 4 * q);
    else cp_async4(buf + e * CW + q, from + q);
    }
  }
}

// The CTA that completed a span: the row's parts in chunk order from 0,
// the opener's (its second slot) first, then each later chunk's first slot,
// read through L2.  One thread a 16-byte column run (a column when D % 4).
__device__ __forceinline__ void reduce_span(const float* carry_val, float* y, int64_t ga, int len,
                                            int64_t row, int D, bool ovec) {
  const int n = ovec ? D / 4 : D;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    if (ovec) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        const int64_t slot = i == 0 ? 2 * ga + 1 : 2 * (ga + i);
        const float4 v = __ldcg(reinterpret_cast<const float4*>(carry_val + slot * D) + c);
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      __stcs(reinterpret_cast<float4*>(y + row * D) + c, acc);
    } else {
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        const int64_t slot = i == 0 ? 2 * ga + 1 : 2 * (ga + i);
        acc = __fadd_rn(acc, __ldcg(carry_val + slot * D + c));
      }
      __stcs(y + row * D + c, acc);
    }
  }
}

// XVEC: x is 16-byte aligned (8 for bf16) and D % 4 == 0 (staging copies of
// 4 columns);
// y and carry_val are 16-byte aligned, so rows are stored 16 bytes at a
// time whenever D % 4 == 0.  bulk: T * sizeof(TL) % 16 == 0 and the plan
// arrays are 16-byte aligned (the plan arrives by bulk copies).
//
// A CTA walks items (chunk g = blockIdx.x + k*gridDim.x, column tile j) in
// order.  While it sums item i from one buffer, item i+1's source rows are
// in flight into the other; the plan of chunk k+2 is fetched when chunk k
// is done.
template <bool WINDOW, bool XVEC, typename TL, typename XT>
__global__ void __launch_bounds__(kThreads, 3)
chunk_staged_kernel(Plan<TL> plan, const XT* __restrict__ x, float* y, float* carry_val,
                    int32_t* counter, int G, int T, int R, int W, int D, int CW, int bulk) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  XT* s_buf = reinterpret_cast<XT*>(s_raw);                       // 2 x T x CW
  unsigned char* s_plan = s_raw + 2 * (size_t)T * CW * sizeof(XT);  // 2 stages
  int* s_start = reinterpret_cast<int*>(s_plan + 2 * stage_bytes(T, sizeof(TL)));  // T + 1
  __shared__ unsigned s_mask[kMaxT / 32];
  __shared__ int s_off[kMaxT / 32];
  __shared__ int s_valid[kMaxT / 32];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_nr, s_nvalid, s_done;
  __shared__ __align__(16) float4 s_zero[kZeroBytes / 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int limit = WINDOW ? W : R;
  const bool ovec = D % 4 == 0;
  const int cq = CW / 4;
  const int ntile = (D + CW - 1) / CW;
  const int64_t stride = gridDim.x;
  const uint32_t bar[2] = {smem_addr(&s_bar[0]), smem_addr(&s_bar[1])};
  if ((int64_t)blockIdx.x >= G) return;
  for (int i = tid; i < kZeroBytes / 16; i += kThreads) s_zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the copy engine
  __syncthreads();
  if (bulk) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar[0]) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar[1]) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // prologue: the plans of the CTA's first two chunks, the first item's rows
  const Stage<TL> st0 = stage_at<TL>(s_plan, 0, T);
  load_plan(bulk, bar[0], st0, plan, blockIdx.x, T);
  if (bulk && blockIdx.x + stride < G)
    load_plan(true, bar[1], stage_at<TL>(s_plan, 1, T), plan, blockIdx.x + stride, T);
  plan_ready(bulk, bar[0], 0);
  stage_rows<XVEC>(s_buf, st0.lid(), st0.src(), x, T, limit, D, CW, 0);
  cp_async_commit();

  int item = 0;
  int k = 0;
  for (int64_t g = blockIdx.x; g < G; g += stride, ++k) {
    const Stage<TL> stg = stage_at<TL>(s_plan, k & 1, T);
    const TL* s_lid = stg.lid();
    const float* s_w = stg.w();
    const int32_t* s_meta = stg.meta();
    const int b = s_meta[0];
    const int64_t base = s_meta[1];
    const int64_t hi = s_meta[2];
    const int flags = s_meta[3];
    const bool first = flags & 1;
    const bool cont_in = (flags >> 2) & 1;
    const bool opens = (flags >> 3) & 1;
    const int64_t blk_lo = (int64_t)b * R;

    // run starts: a real edge whose local id differs from the edge before
    const int nwords = (T + 31) / 32;
    for (int q = warp; q < nwords; q += kWarps) {
      const int e = q * 32 + lane;
      const bool valid = e < T && s_lid[e] < limit;
      const bool start = valid && (e == 0 || s_lid[e - 1] != s_lid[e]);
      const unsigned sm = __ballot_sync(kFull, start);
      const unsigned vm = __ballot_sync(kFull, valid);
      if (lane == 0) {
        s_mask[q] = sm;
        s_valid[q] = __popc(vm);
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int cnt = lane < nwords ? __popc(s_mask[lane]) : 0;
      int inc = cnt;
      int vc = lane < nwords ? s_valid[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
        vc += __shfl_xor_sync(kFull, vc, o);
      }
      if (lane < nwords) s_off[lane] = inc - cnt;
      if (lane == 31) s_nr = inc;
      if (lane == 0) s_nvalid = vc;
    }
    __syncthreads();
    for (int q = warp; q < nwords; q += kWarps) {
      const unsigned sm = s_mask[q];
      if ((sm >> lane) & 1u) s_start[s_off[q] + __popc(sm & ((1u << lane) - 1u))] = q * 32 + lane;
    }
    __syncthreads();
    const int nr = s_nr;
    const int nvalid = s_nvalid;
    const int64_t lo = first ? blk_lo : base + s_lid[s_start[0]];
    // zero the chunk's rows in [lo, hi) that no run of it covers
    const int nin = (nr > 0 && base + s_lid[s_start[nr - 1]] >= hi) ? nr - 1 : nr;
    if (ovec) {
      // the gaps before, between and after its runs, a thread a gap, by
      // bulk stores of shared zeros (D % 4 == 0: whole rows are 16-byte
      // multiples)
      bool zeroed = false;
      for (int a = tid; a <= nin; a += kThreads) {
        const int64_t r0 = a ? base + s_lid[s_start[a - 1]] + 1 : lo;
        const int64_t r1 = a < nin ? base + s_lid[s_start[a]] : hi;
        if (r1 > r0) {
          bulk_zero(reinterpret_cast<char*>(y + r0 * D), (r1 - r0) * D * 4, s_zero);
          zeroed = true;
        }
      }
      if (zeroed) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    } else {
      // the z-th such row lies past the runs whose row - lo - k is <= z
      const int64_t Z = hi - lo - nin;
      const int per = kThreads / D;
      const int slot = tid / D, part = tid - slot * D;
      if (slot < per) {
        int a = 0;
        for (int64_t z = slot; z < Z; z += per) {
          while (a < nin && base + s_lid[s_start[a]] - lo - a <= z) ++a;
          __stcs(y + (lo + z + a) * D + part, 0.0f);
        }
      }
    }

    for (int j = 0; j < ntile; ++j, ++item) {
      const int c0 = j * CW;
      const int cw = D - c0 < CW ? D - c0 : CW;
      const int nq = (cw + 3) >> 2;
      // the next item's rows into the other buffer (its chunk's plan first)
      XT* nbuf = s_buf + (size_t)((item + 1) & 1) * T * CW;
      if (j + 1 < ntile) {
        stage_rows<XVEC>(nbuf, s_lid, stg.src(), x, T, limit, D, CW, c0 + CW);
      } else if (g + stride < G) {
        const Stage<TL> nstg = stage_at<TL>(s_plan, (k + 1) & 1, T);
        if (!bulk) load_plan(false, 0, nstg, plan, g + stride, T);
        plan_ready(bulk, bar[(k + 1) & 1], (k + 1) >> 1);
        stage_rows<XVEC>(nbuf, nstg.lid(), nstg.src(), x, T, limit, D, CW, 0);
      }
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      const XT* s_x = s_buf + (size_t)(item & 1) * T * CW;
      const int rper = kThreads / nq;
      const int r0 = tid / nq, q = tid - r0 * nq;
      for (int r = r0; r < nr && r0 < rper; r += rper) {
        const int beg = s_start[r];
        const int end = r + 1 < nr ? s_start[r + 1] : nvalid;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const XT* xs = s_x + 4 * q;
#pragma unroll 4
        for (int e = beg; e < end; ++e) {
          const float wv = msg_weight(s_w[e], xs);
          const float4 v = load4(xs, e * cq);
          acc.x = __fadd_rn(acc.x, __fmul_rn(wv, v.x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(wv, v.y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(wv, v.z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(wv, v.w));
        }
        // a run that continues a span is its first slot; one that opens a
        // span, its second; any other row is whole here
        const bool in = r == 0 && cont_in;
        const bool carry = in || (r == nr - 1 && opens);
        float* out = carry ? carry_val + (2 * g + (in ? 0 : 1)) * D
                           : y + (base + s_lid[beg]) * D;
        store_cols(out + c0 + 4 * q, acc, cw - 4 * q, ovec, !carry);
      }
      __syncthreads();  // this buffer is refilled two items on
    }

    if (cont_in || opens) {
      // each span this chunk holds a part of counts its parts; the CTA that
      // adds the last sums the row (fenced: the barrier orders the CTA's
      // slot stores before thread 0's fence and count)
      const int64_t ga = s_meta[4];
      const int len_in = s_meta[5];
      const int len_out = s_meta[6];
      if (tid == 0) {
        __threadfence();
        int done = 0;
        if (cont_in && atomicAdd(counter + ga, 1) == len_in - 1) done |= 1;
        if (opens && atomicAdd(counter + g, 1) == len_out - 1) done |= 2;
        __threadfence();
        s_done = done;
      }
      __syncthreads();
      const int done = s_done;
      if (done & 1) reduce_span(carry_val, y, ga, len_in, base + s_lid[s_start[0]], D, ovec);
      if (done & 2) reduce_span(carry_val, y, g, len_out, base + s_lid[s_start[nr - 1]], D, ovec);
    }
    __syncthreads();  // the run starts and the scan's words are reused
    // chunk k's stage is free only once every thread is past the barrier
    // (the span sums read its local ids): the plan of chunk k + 2
    if (bulk && g + 2 * stride < G)
      load_plan(true, bar[k & 1], stg, plan, g + 2 * stride, T);
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // this thread's zero stores
}

struct DeviceSetup {
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

DeviceSetup g_setup[kMaxDevices];
std::atomic<bool> g_ready[kMaxDevices];
std::mutex g_mutex;
std::map<std::tuple<int, const void*, size_t>, int> g_fit;  // CTAs a SM by (device, kernel, smem)

template <bool WINDOW, bool XVEC, typename TL, typename XT>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(chunk_staged_kernel<WINDOW, XVEC, TL, XT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxStagedSmem);
}

// once per device (the caller has made it current)
const DeviceSetup& device_setup(int device) {
  if (g_ready[device].load(std::memory_order_acquire)) return g_setup[device];
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceSetup& s = g_setup[device];
  if (g_ready[device].load(std::memory_order_relaxed)) return s;
  cudaError_t err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem<false, false, int32_t, float>();
  if (err == cudaSuccess) err = allow_smem<false, true, int32_t, float>();
  if (err == cudaSuccess) err = allow_smem<true, false, int32_t, float>();
  if (err == cudaSuccess) err = allow_smem<true, true, int32_t, float>();
  if (err == cudaSuccess) err = allow_smem<false, false, int16_t, float>();
  if (err == cudaSuccess) err = allow_smem<false, true, int16_t, float>();
  if (err == cudaSuccess) err = allow_smem<false, false, int32_t, __nv_bfloat16>();
  if (err == cudaSuccess) err = allow_smem<false, true, int32_t, __nv_bfloat16>();
  if (err == cudaSuccess) err = allow_smem<true, false, int32_t, __nv_bfloat16>();
  if (err == cudaSuccess) err = allow_smem<true, true, int32_t, __nv_bfloat16>();
  s.err = err;
  g_ready[device].store(true, std::memory_order_release);
  return s;
}

template <typename K>
cudaError_t ctas_per_sm(int device, K kernel, size_t smem, int* fit) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(kernel), smem);
  auto it = g_fit.find(key);
  if (it != g_fit.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fit, kernel, kThreads, smem);
  if (err == cudaSuccess) g_fit[key] = *fit;
  return err;
}

template <bool WINDOW, bool XVEC, typename TL, typename XT>
cudaError_t launch_staged(const Plan<TL>& plan, const XT* x, float* y, float* carry_val,
                          int32_t* counter, int G, int T, int R, int W, int D, int bulk,
                          int device, const DeviceSetup& s, cudaStream_t st) {
  const int CW = column_tile(T, D);
  const size_t smem = staged_smem_bytes(T, CW, sizeof(TL), sizeof(XT));
  auto kernel = chunk_staged_kernel<WINDOW, XVEC, TL, XT>;
  int fit = 0;
  cudaError_t err = ctas_per_sm(device, kernel, smem, &fit);
  if (err != cudaSuccess) return err;
  if (fit <= 0) return cudaErrorInvalidConfiguration;
  int64_t grid = (int64_t)fit * s.sms;
  if (grid > G) grid = G;
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(plan, x, y, carry_val, counter, G, T, R, W, D,
                                                  CW, bulk);
  return cudaGetLastError();
}

// the launch for a plan's id type: window plans have int32 ids
template <typename TL, typename XT>
cudaError_t launch_plan(const Plan<TL>& plan, const XT* x, float* y, float* carry_val,
                        int32_t* counter, int G, int T, int R, int W, int D, int vec, int bulk,
                        int device, const DeviceSetup& s, cudaStream_t st) {
  if constexpr (sizeof(TL) == 4) {
    if (W > 0)
      return vec ? launch_staged<true, true>(plan, x, y, carry_val, counter, G, T, R, W, D, bulk,
                                             device, s, st)
                 : launch_staged<true, false>(plan, x, y, carry_val, counter, G, T, R, W, D, bulk,
                                              device, s, st);
  }
  return vec ? launch_staged<false, true>(plan, x, y, carry_val, counter, G, T, R, 0, D, bulk,
                                          device, s, st)
             : launch_staged<false, false>(plan, x, y, carry_val, counter, G, T, R, 0, D, bulk,
                                           device, s, st);
}

// the entry of P1 (W > 0), P2 (int16 ids: tl == 2) and P3: checks, the
// device, the counters, one launch; bf16: x is a bf16 table (P1 and P3)
int staged_entry(bool window, int tl, const void* src, const void* w, const void* lid,
                 const void* meta, const void* x, void* y, void* carry_val, void* counter, int G,
                 int T, int R, int W, int D, int vec, int bf16, int device, void* stream) {
  if (G <= 0 || T <= 0 || T > kMaxT || D <= 0 || D > 256 || R <= 0 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (window ? (W <= 0 || W >= R) : (W != 0)) return (int)cudaErrorInvalidValue;
  // int16 ids: full-block plans whose pad id R fits
  if (tl != 4 && (tl != 2 || window || R > INT16_MAX || bf16)) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // a 4-column load path asked for a table it cannot read is refused
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % (bf16 ? 8 : 16) == 0;
  if (vec && (D % 4 != 0 || !x_aligned)) return (int)cudaErrorInvalidValue;
  if (D % 4 == 0 && !(aligned(y) && aligned(carry_val))) return (int)cudaErrorInvalidValue;
  const int bulk =
      T * tl % 16 == 0 && aligned(src) && aligned(w) && aligned(lid) && aligned(meta);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const DeviceSetup& s = device_setup(device);
  err = s.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, (size_t)G * 4, st);
  if (err == cudaSuccess) {
    const int32_t* sp = static_cast<const int32_t*>(src);
    const float* wp = static_cast<const float*>(w);
    const int32_t* mp = static_cast<const int32_t*>(meta);
    float* yp = static_cast<float*>(y);
    float* cv = static_cast<float*>(carry_val);
    int32_t* cn = static_cast<int32_t*>(counter);
    const Plan<int32_t> p32{sp, wp, static_cast<const int32_t*>(lid), mp};
    if (tl == 2)
      err = launch_plan(Plan<int16_t>{sp, wp, static_cast<const int16_t*>(lid), mp},
                        static_cast<const float*>(x), yp, cv, cn, G, T, R, 0, D, vec, bulk,
                        device, s, st);
    else if (bf16)
      err = launch_plan(p32, static_cast<const __nv_bfloat16*>(x), yp, cv, cn, G, T, R, W, D, vec,
                        bulk, device, s, st);
    else
      err = launch_plan(p32, static_cast<const float*>(x), yp, cv, cn, G, T, R, W, D, vec, bulk,
                        device, s, st);
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

// P3: one launch of chunk_staged_kernel on `stream` of `device` (the
// counters zeroed before it).  lid is the plan's int32 local ids, meta the
// (G, 8) int32 chunk table of ops/segment_plan.py chunk_meta; carry_val
// (2G, D) fp32 and counter (G,) int32 are scratch; y is the
// (num_blocks*R, D) fp32 block space.  bf16 = 1: x is a bf16 table.
// vec = 1: x is 16-byte aligned (8 for bf16) and D % 4 == 0 (refused
// otherwise).  Returns the first error (0 = launched).
extern "C" int chunk_spmm_block(const void* src, const void* w, const void* lid, const void* meta,
                                const void* x, void* y, void* carry_val, void* counter, int G,
                                int T, int R, int D, int vec, int bf16, int device,
                                void* stream) {
  return staged_entry(false, 4, src, w, lid, meta, x, y, carry_val, counter, G, T, R, 0, D, vec,
                      bf16, device, stream);
}

// P1: the same for window chunks of W rows
extern "C" int chunk_spmm_window(const void* src, const void* w, const void* lid,
                                 const void* meta, const void* x, void* y, void* carry_val,
                                 void* counter, int G, int T, int R, int W, int D, int vec,
                                 int bf16, int device, void* stream) {
  return staged_entry(true, 4, src, w, lid, meta, x, y, carry_val, counter, G, T, R, W, D, vec,
                      bf16, device, stream);
}

// P2: the same as P3 with int16 local ids (R <= 32767), fp32 tables only
// (bf16 must be 0)
extern "C" int chunk_spmm_i16(const void* src, const void* w, const void* lid, const void* meta,
                              const void* x, void* y, void* carry_val, void* counter, int G,
                              int T, int R, int D, int vec, int bf16, int device, void* stream) {
  return staged_entry(false, 2, src, w, lid, meta, x, y, carry_val, counter, G, T, R, 0, D, vec,
                      bf16, device, stream);
}
