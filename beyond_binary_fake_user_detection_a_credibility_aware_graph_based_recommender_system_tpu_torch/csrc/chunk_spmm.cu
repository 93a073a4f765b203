// Edge-chunked weighted segment-sum SpMM over a block/chunk plan, for Hopper
// (sm_90a).
//
//   out[b*R + ws + lid[e], :] += w[e] * x[src[e], :]   for every real edge e
//
// over the plan of ops/segment_plan.py: destination rows cut into blocks of
// R rows, each block's dst-sorted edges cut into chunks of T edges (a window
// plan confines a chunk's rows to W rows from an 8-aligned win_start).  The
// output is the whole (num_blocks*R, D) fp32 block space.
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
// onehot @ msg into the block's VMEM accumulator, one chunk per grid step.
//
// What bounds it on an H100: bytes.  Per edge it reads one source row, a
// source id, a weight and a local id, and does 2*D flops; the least traffic
// is the referenced source rows, the plan arrays and one write of the block
// space.
//
// Design:
//   * balanced by edges, not blocks: one CTA per chunk (a hub block's many
//     chunks run on many SMs, where the Pallas grid walked them in order);
//   * the CTA splits its chunk's dst-sorted edges into row runs (ballot and
//     a prefix count in shared memory); a warp sums each run in edge order,
//     lanes across D, with __fmul_rn/__fadd_rn (no FMA contraction), keeping
//     up to 8 source rows in flight; the gather x[src[e]] happens here;
//   * a run strictly inside its block's edge range is a whole row and is
//     stored once; a chunk's first run (unless the chunk opens its block)
//     and last run (unless it closes it) may continue into the neighbouring
//     chunk, and go as partial sums to a (G, 2, D) carry buffer with their
//     row ids; a second kernel adds each row's carries in chunk order from
//     0.  No atomics: two launches are bit-identical and equal the plain
//     version's order (ops/chunk_spmm.py);
//   * pad edges (local id == R, or == W in a window plan) are skipped, never
//     multiplied by their zero weight: b*R + ws + lid would alias them into
//     a real row, and 0 * inf is NaN;
//   * every row of the block space is written once: the rows between runs,
//     before a block's first row and after its last, are zeroed by the chunk
//     around them (an empty block's one chunk zeroes all R rows).
// The chunk's pad edges must form its tail (the planner's layout).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 1024;            // chunk edges one CTA's masks cover
constexpr unsigned kFull = 0xffffffffu;

template <int VPL>
__device__ __forceinline__ void zero_rows(float* y, int64_t r0, int64_t r1, int D, int lane) {
  for (int64_t r = r0; r < r1; ++r) {
    float* yr = y + r * D;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < D) yr[c] = 0.0f;
    }
  }
}

template <typename TL, int VPL, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const int32_t* __restrict__ src, const float* __restrict__ w,
             const TL* __restrict__ lid, const int32_t* __restrict__ block_id,
             const int32_t* __restrict__ first_chunk, const int32_t* __restrict__ win_start,
             const float* __restrict__ x, float* __restrict__ y,
             float* __restrict__ carry_val, int32_t* __restrict__ carry_row,
             int G, int T, int R, int W, int D) {
  // edges whose source rows one warp keeps in flight
  constexpr int kBatch = VPL <= 2 ? 8 : (VPL <= 4 ? 4 : 2);
  extern __shared__ int s_dyn[];
  int* s_lid = s_dyn;          // T local ids
  int* s_start = s_dyn + T;    // first edge of each run
  __shared__ unsigned s_mask[kMaxT / 32];
  __shared__ int s_off[kMaxT / 32];
  __shared__ int s_valid[kMaxT / 32];
  __shared__ int s_nr, s_nvalid;

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int limit = WINDOW ? W : R;
  const int64_t e0 = (int64_t)g * T;
  for (int e = threadIdx.x; e < T; e += kThreads) s_lid[e] = (int)lid[e0 + e];
  __syncthreads();

  // run starts: a real edge whose local id differs from the edge before it
  const int nwords = (T + 31) / 32;
  for (int k = warp; k < nwords; k += kWarps) {
    const int e = k * 32 + lane;
    const bool valid = e < T && s_lid[e] < limit;
    const bool start = valid && (e == 0 || s_lid[e - 1] != s_lid[e]);
    const unsigned sm = __ballot_sync(kFull, start);
    const unsigned vm = __ballot_sync(kFull, valid);
    if (lane == 0) {
      s_mask[k] = sm;
      s_valid[k] = __popc(vm);
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
  for (int k = warp; k < nwords; k += kWarps) {
    const unsigned sm = s_mask[k];
    if ((sm >> lane) & 1u) s_start[s_off[k] + __popc(sm & ((1u << lane) - 1u))] = k * 32 + lane;
  }
  __syncthreads();

  const int nr = s_nr;
  const int nvalid = s_nvalid;
  const int b = block_id[g];
  const int64_t blk_lo = (int64_t)b * R;
  const int64_t base_row = blk_lo + (WINDOW ? win_start[g] : 0);
  const bool first = first_chunk[g] != 0;
  const bool last = (g + 1 == G) || block_id[g + 1] != b;
  // the first row of the block's next chunk ends this chunk's zero range
  int64_t next_row = blk_lo + R;
  if (!last) next_row = blk_lo + (WINDOW ? win_start[g + 1] : 0) + (int)lid[e0 + T];

  if (threadIdx.x == 0) {
    const bool c0 = nr > 0 && (!first || (nr == 1 && !last));
    const bool c1 = nr > 1 && !last;
    carry_row[2 * (int64_t)g] = c0 ? (int32_t)(base_row + s_lid[s_start[0]]) : -1;
    carry_row[2 * (int64_t)g + 1] = c1 ? (int32_t)(base_row + s_lid[s_start[nr - 1]]) : -1;
  }
  if (warp == 0 && first) zero_rows<VPL>(y, blk_lo, nr ? base_row + s_lid[s_start[0]] : next_row, D, lane);

  for (int k = warp; k < nr; k += kWarps) {
    const int beg = s_start[k];
    const int end = k + 1 < nr ? s_start[k + 1] : nvalid;
    const int64_t row = base_row + s_lid[beg];
    float acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = 0.0f;
    for (int b0 = beg; b0 < end; b0 += 32) {
      const int e = b0 + lane;
      int32_t s = 0;
      float we = 0.0f;
      if (e < end) {
        s = src[e0 + e];
        we = w[e0 + e];
      }
      const int n = end - b0 < 32 ? end - b0 : 32;
      for (int k0 = 0; k0 < n; k0 += kBatch) {
        float v[kBatch][VPL];
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) {
          const int i = k0 + kk;
          const int32_t sk = __shfl_sync(kFull, s, i & 31);
          const float wk = __shfl_sync(kFull, we, i & 31);
          const float* xr = x + (int64_t)sk * D;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int c = lane + 32 * j;
            v[kk][j] = (i < n && c < D) ? __fmul_rn(wk, xr[c]) : 0.0f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) {
          if (k0 + kk < n) {
#pragma unroll
            for (int j = 0; j < VPL; ++j) acc[j] = __fadd_rn(acc[j], v[kk][j]);
          }
        }
      }
    }
    const bool carry = (k == 0 && !first) || (k == nr - 1 && !last);
    float* out = carry ? carry_val + (2 * (int64_t)g + (k == 0 ? 0 : 1)) * D : y + row * D;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < D) out[c] = acc[j];
    }
    zero_rows<VPL>(y, row + 1, k + 1 < nr ? base_row + s_lid[s_start[k + 1]] : next_row, D, lane);
  }
}

// One warp per carry slot: the first slot of a row sums all of that row's
// slots in chunk order, from 0, and writes the row.  It reads 32 slot row
// ids at a time and keeps up to kBatch partial rows in flight (a hub row has
// one slot per chunk it spans).
template <int VPL>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const float* __restrict__ carry_val, const int32_t* __restrict__ carry_row,
             float* __restrict__ y, int64_t nslots, int D) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= nslots) return;
  const int32_t row = carry_row[slot];
  if (row < 0) return;
  int64_t p = slot - 1;
  while (p >= 0 && carry_row[p] < 0) --p;
  if (p >= 0 && carry_row[p] == row) return;
  float acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = 0.0f;
  for (int64_t q = slot;; q += 32) {
    const int64_t qq = q + lane;
    const int32_t rq = qq < nslots ? carry_row[qq] : -2;
    // the row's slots end at the first slot of another row, or at the end
    const unsigned stop = __ballot_sync(kFull, rq != row && rq != -1);
    const unsigned mine = stop ? (1u << (__ffs(stop) - 1)) - 1u : kFull;
    unsigned take = __ballot_sync(kFull, rq == row) & mine;
    while (take) {
      int k[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        k[b] = take ? __ffs(take) - 1 : -1;
        take &= take - 1u;
      }
      float v[kBatch][VPL];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float* cv = carry_val + (q + (k[b] < 0 ? 0 : k[b])) * D;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int c = lane + 32 * j;
          v[b][j] = (k[b] >= 0 && c < D) ? cv[c] : 0.0f;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k[b] >= 0) {
#pragma unroll
          for (int j = 0; j < VPL; ++j) acc[j] = __fadd_rn(acc[j], v[b][j]);
        }
      }
    }
    if (stop) break;
  }
  float* yr = y + (int64_t)row * D;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    if (c < D) yr[c] = acc[j];
  }
}

template <typename TL, int VPL, bool WINDOW>
cudaError_t launch_vpl(const int32_t* src, const float* w, const TL* lid, const int32_t* block_id,
                       const int32_t* first_chunk, const int32_t* win_start, const float* x,
                       float* y, float* carry_val, int32_t* carry_row, int G, int T, int R,
                       int W, int D, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)T * sizeof(int);
  chunk_kernel<TL, VPL, WINDOW><<<G, kThreads, smem, stream>>>(
      src, w, lid, block_id, first_chunk, win_start, x, y, carry_val, carry_row, G, T, R, W, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t nslots = 2 * (int64_t)G;
  const unsigned grid = (unsigned)((nslots + kWarps - 1) / kWarps);
  carry_kernel<VPL><<<grid, kThreads, 0, stream>>>(carry_val, carry_row, y, nslots, D);
  return cudaGetLastError();
}

template <typename TL, bool WINDOW>
int launch(const void* src, const void* w, const void* lid, const void* block_id,
           const void* first_chunk, const void* win_start, const void* x, void* y,
           void* carry_val, void* carry_row, int G, int T, int R, int W, int D, void* stream) {
  if (G <= 0 || T <= 0 || T > kMaxT || D <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  if (WINDOW && (W <= 0 || W >= R || win_start == nullptr)) return (int)cudaErrorInvalidValue;
  const int32_t* sp = static_cast<const int32_t*>(src);
  const float* wp = static_cast<const float*>(w);
  const TL* lp = static_cast<const TL*>(lid);
  const int32_t* bp = static_cast<const int32_t*>(block_id);
  const int32_t* fp = static_cast<const int32_t*>(first_chunk);
  const int32_t* ws = static_cast<const int32_t*>(win_start);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* cv = static_cast<float*>(carry_val);
  int32_t* cr = static_cast<int32_t*>(carry_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_vpl<TL, 1, WINDOW>(sp, wp, lp, bp, fp, ws, xp, yp, cv, cr, G, T, R, W, D, st);
  if (D <= 64) return (int)launch_vpl<TL, 2, WINDOW>(sp, wp, lp, bp, fp, ws, xp, yp, cv, cr, G, T, R, W, D, st);
  if (D <= 128) return (int)launch_vpl<TL, 4, WINDOW>(sp, wp, lp, bp, fp, ws, xp, yp, cv, cr, G, T, R, W, D, st);
  if (D <= 256) return (int)launch_vpl<TL, 8, WINDOW>(sp, wp, lp, bp, fp, ws, xp, yp, cv, cr, G, T, R, W, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry launches the chunk kernel and the carry kernel on `stream` and
// returns the first launch error (0 = launched).  carry_val is (2G, D) fp32
// and carry_row (2G,) int32 scratch; y is (num_blocks*R, D) fp32.
extern "C" int chunk_spmm_block(const void* src, const void* w, const void* lid,
                                const void* block_id, const void* first_chunk, const void* x,
                                void* y, void* carry_val, void* carry_row, int G, int T, int R,
                                int D, void* stream) {
  return launch<int32_t, false>(src, w, lid, block_id, first_chunk, nullptr, x, y, carry_val,
                                carry_row, G, T, R, 0, D, stream);
}

extern "C" int chunk_spmm_i16(const void* src, const void* w, const void* lid,
                              const void* block_id, const void* first_chunk, const void* x,
                              void* y, void* carry_val, void* carry_row, int G, int T, int R,
                              int D, void* stream) {
  return launch<int16_t, false>(src, w, lid, block_id, first_chunk, nullptr, x, y, carry_val,
                                carry_row, G, T, R, 0, D, stream);
}

extern "C" int chunk_spmm_window(const void* src, const void* w, const void* lid,
                                 const void* block_id, const void* first_chunk,
                                 const void* win_start, const void* x, void* y, void* carry_val,
                                 void* carry_row, int G, int T, int R, int W, int D,
                                 void* stream) {
  return launch<int32_t, true>(src, w, lid, block_id, first_chunk, win_start, x, y, carry_val,
                               carry_row, G, T, R, W, D, stream);
}
