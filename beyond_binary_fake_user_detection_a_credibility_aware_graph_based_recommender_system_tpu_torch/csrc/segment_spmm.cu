// Weighted segment-sum SpMM over a destination-sorted CSR, for Hopper (sm_90a).
//
//   y[d, :] = sum_{e in [indptr[d], indptr[d+1])} w[e] * x[src[e], :]
//
// Replaces the JAX package's Pallas kernels in ops/spmm_pallas.py, driven by
// _apply_padded_blocks (:446, pallas_call at :500): _segment_kernel (:406,
// K1, the plain block kernel) and _window_kernel (:427, K2, the same sum for
// high-degree destinations).  Those build a weighted one-hot (R x T) or
// (W x T) matrix per chunk of T dst-sorted edges and accumulate it against
// the gathered messages on the MXU, one chunk per sequential grid step.
// Their R/T/W blocking is TPU VMEM and MXU layout; here the plan is the CSR
// (indptr, src, w) and a table of long-row pieces built once on the host.
//
// What bounds it on an H100: bytes.  Per edge it reads one source row
// (D values), one int32 id and one fp32 weight and does 2*D flops, far below
// the ~20 flop/byte the fp32 units need to be the limit.  The least traffic
// is the referenced source rows, the edge arrays, indptr and one write of y
// (probes/_timing.py csr_bound_ms); the piece table and the fp32 partials
// are not compulsory and are left out of the bound.
//
// Design:
//   * long rows become fixed edge pieces: a row with more than L edges is
//     cut from its first edge into pieces of L edges (the last may be
//     shorter).  Blocks run in parallel and in no order, so one lane group
//     sums each piece in edge order from 0 into an fp32 partial row
//     (scratch of shape (pieces, D)), and a second small kernel sums each
//     long row's partials in piece order from 0 and writes the row.  The
//     21,252-edge hub of the reference graph thus runs on 333 groups at
//     L=64 instead of one warp.  The pieces take the lowest block indices,
//     so they start in the first wave;
//   * every other row is summed by one lane group in edge order from 0 and
//     written once; a long row is left to the second kernel, which stages
//     the row's contiguous partials in shared memory (all 256 threads load,
//     one thread a column sums) so that the hub's hundreds of partials cost
//     a few rounds of loads, not one dependent chain;
//   * a group is the lanes that cover one row with 16-byte runs (float4 of
//     fp32, 8 bf16), kRunsPerLane runs a lane: 4 lanes per fp32 row at
//     D=64 with 4 runs each (8 rows a warp).  Fewer lanes a row keep more
//     rows in flight on an SM; of 1, 2 and 4 runs a lane, 4 was the fastest
//     on the hub-shaped direction at L=64 on the H100 (PERF.md, Findings).
//     Widths that are not a multiple of 4 (fp32) or 8 (bf16), or a table
//     that is not 16-byte aligned, take the scalar path (one element a run);
//   * the group keeps kBatch source rows in flight (about kRawBudget
//     registers of raw row data a lane, at least 2 rows: 2 at D=64 fp32),
//     and loads the next batch's ids and weights while the current batch's
//     gathers are out, then adds the batch in edge order;
//   * empty rows are written as exact zeros with the same 16-byte stores,
//     so no memset;
//   * fp32 accumulation with separate multiply and add (__fmul_rn /
//     __fadd_rn, no FMA contraction) and no atomics: two launches are
//     bit-identical, and the result equals the plain version's ordered CPU
//     sums (ops/spmm_cuda.py segment_spmm_reference) bit for bit;
//   * bf16 mode rounds the weight to bf16 as the Pallas kernel does
//     (onehot.astype(msg.dtype)); bf16 * bf16 is exact in fp32, and the sum
//     is rounded to the output dtype once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Registers of raw source-row data one lane keeps in flight: it sets the
// batch of source rows a group gathers at once (at least 2: 2 at D=64 fp32
// with 4 runs a lane).  Fewer registers a lane keep more rows resident on
// an SM.  Larger budgets were tried on the H100; none was faster on both
// reference directions (PERF.md, Findings).
constexpr int kRawBudget = 16;
// 16-byte column runs of a row one lane sums (at most 8 a lane, 32 lanes a
// row): 4 puts 4 lanes on a D=64 fp32 row.
constexpr int kRunsPerLane = 4;
// Partials the reduction stages in shared memory per round (48 KB, the most
// a block may hold statically: the hub's 333 partials of 64 fp32 at L=64
// take 2 rounds).
constexpr int kStageFloats = 12288;

// The 16-byte (or scalar) view of a table element run: Raw is what one lane
// loads, unpack turns it into VEC floats.
template <typename T, int VEC>
struct Lane;

template <>
struct Lane<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

template <>
struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);             // low half: element 2i
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Lane<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __uint_as_float((uint32_t)r << 16);
  }
};

__device__ __forceinline__ float round_weight(float w, const float*) { return w; }
__device__ __forceinline__ float round_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Store VEC consecutive values: 16-byte stores for fp32, 8 or 16 for bf16.
template <int VEC>
__device__ __forceinline__ void store_run(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<uint2*>(p + i) =
          make_uint2(bf16_bits(v[i]) | (bf16_bits(v[i + 1]) << 16),
                     bf16_bits(v[i + 2]) | (bf16_bits(v[i + 3]) << 16));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// A lane group of 2^lpr_log2 lanes covers one row; a lane owns the column
// runs col[c] = (sub + c * lanes) * VEC (c < CPL) of VEC columns each.
// Group item < num_pieces sums long-row piece `item` into partial[item];
// item num_pieces + r sums row r into y[r] unless row r is long.  The group
// walks its edges in batches of kBatch: the gathers of one batch are in
// flight while the next batch's ids and weights are loaded, then the batch
// is added in edge order.
template <typename TX, typename TY, int VEC, int CPL>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ src,
            const float* __restrict__ w, const TX* __restrict__ x, TY* __restrict__ y,
            float* __restrict__ partial, const int64_t* __restrict__ piece_start,
            const int32_t* __restrict__ piece_row, int64_t num_pieces, int64_t num_dst,
            int D, int L, int lpr_log2) {
  using LaneT = Lane<TX, VEC>;
  constexpr int kRaw = (int)(sizeof(typename LaneT::Raw) + 3) / 4 * CPL;
  constexpr int kFit = kRawBudget / kRaw;
  constexpr int kBatch = kFit > 8 ? 8 : (kFit < 2 ? 2 : kFit);
  const int lanes = 1 << lpr_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t item = (int64_t)blockIdx.x * (kThreads >> lpr_log2) + (threadIdx.x >> lpr_log2);
  const bool is_piece = item < num_pieces;
  int64_t beg, end, row = 0;
  if (is_piece) {
    beg = piece_start[item];
    const int64_t row_end = indptr[(int64_t)piece_row[item] + 1];
    end = beg + L < row_end ? beg + L : row_end;
  } else {
    row = item - num_pieces;
    if (row >= num_dst) return;
    beg = indptr[row];
    end = indptr[row + 1];
    if (end - beg > L) return;  // a long row: its pieces' partials are summed later
  }
  const int nruns = D / VEC;
  int col[CPL];
  bool own[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    col[c] = (sub + c * lanes) * VEC;
    own[c] = sub + c * lanes < nruns;
  }
  float acc[CPL][VEC];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[c][t] = 0.0f;

  int32_t s[kBatch];
  float wk[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int64_t e = beg + k;
    s[k] = e < end ? __ldg(src + e) : 0;
    wk[k] = e < end ? round_weight(__ldg(w + e), x) : 0.0f;
  }
  for (int64_t b0 = beg; b0 < end; b0 += kBatch) {
    typename LaneT::Raw v[kBatch][CPL];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const TX* xr = x + (int64_t)s[k] * D;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        v[k][c] = {};
        if (b0 + k < end && own[c]) v[k][c] = LaneT::load(xr + col[c]);
      }
    }
    // the next batch's ids and weights, while this batch's rows are in flight
    float w2[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t e = b0 + kBatch + k;
      s[k] = e < end ? __ldg(src + e) : 0;
      w2[k] = e < end ? round_weight(__ldg(w + e), x) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (b0 + k < end) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float f[VEC];
          LaneT::unpack(v[k][c], f);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[c][t] = __fadd_rn(acc[c][t], __fmul_rn(wk[k], f[t]));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) wk[k] = w2[k];
  }

  // an empty row stores its zeros here too
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (!own[c]) continue;
    if (is_piece)
      store_run<VEC>(partial + item * D + col[c], acc[c]);
    else
      store_run<VEC>(y + row * D + col[c], acc[c]);
  }
}

// One block per long row: the row's partials (slots long_first[i] ..
// long_first[i+1], contiguous) are staged in shared memory by all threads,
// kStageFloats at a time, and thread c < D sums column c of them in piece
// order from 0; the row is written to y once.
template <typename TY>
__global__ void __launch_bounds__(kThreads)
long_rows_kernel(const float* __restrict__ partial, const int32_t* __restrict__ long_rows,
                 const int32_t* __restrict__ long_first, TY* __restrict__ y, int D) {
  __shared__ float stage[kStageFloats];
  const int c = threadIdx.x;
  const int i = blockIdx.x;
  const int32_t s0 = long_first[i], s1 = long_first[i + 1];
  const int per_round = kStageFloats / D;
  float acc = 0.0f;
  for (int32_t b0 = s0; b0 < s1; b0 += per_round) {
    const int n = (s1 - b0 < per_round ? s1 - b0 : per_round) * D;
    const float* from = partial + (int64_t)b0 * D;
#pragma unroll 8
    for (int t = c; t < n; t += kThreads) stage[t] = from[t];
    __syncthreads();
    // unrolled so that the shared-memory loads run ahead of the add chain
    if (c < D) {
#pragma unroll 16
      for (int t = c; t < n; t += D) acc = __fadd_rn(acc, stage[t]);
    }
    __syncthreads();
  }
  if (c < D) {
    float out[1] = {acc};
    store_run<1>(y + (int64_t)long_rows[i] * D + c, out);
  }
}

struct Args {
  const int64_t* indptr;
  const int32_t* src;
  const float* w;
  const void* x;
  void* y;
  float* partial;
  const int64_t* piece_start;
  const int32_t* piece_row;
  const int32_t* long_rows;
  const int32_t* long_first;
  int64_t num_pieces, num_dst;
  int num_long, D, L;
  cudaStream_t stream;
};

int ceil_log2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

template <typename TX, typename TY, int VEC, int CPL>
cudaError_t launch_rows(const Args& a, int lpr_log2) {
  const int64_t items = a.num_pieces + a.num_dst;
  const int64_t per_block = kThreads >> lpr_log2;
  const unsigned grid = (unsigned)((items + per_block - 1) / per_block);
  rows_kernel<TX, TY, VEC, CPL><<<grid, kThreads, 0, a.stream>>>(
      a.indptr, a.src, a.w, static_cast<const TX*>(a.x), static_cast<TY*>(a.y), a.partial,
      a.piece_start, a.piece_row, a.num_pieces, a.num_dst, a.D, a.L, lpr_log2);
  return cudaGetLastError();
}

// A row's nruns runs (16 bytes each on the vector path, one element each on
// the scalar path) go to 2^lpr_log2 <= 32 lanes with cpl runs a lane, cpl
// as close to kRunsPerLane as 32 lanes allow.
template <typename TX, typename TY>
cudaError_t launch(const Args& a) {
  constexpr int kVec = 16 / (int)sizeof(TX);
  const bool vec = a.D % kVec == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int nruns = vec ? a.D / kVec : a.D;
  int lanes = (nruns + kRunsPerLane - 1) / kRunsPerLane;
  if (lanes < (nruns + 7) / 8) lanes = (nruns + 7) / 8;  // at most 8 runs a lane
  const int lpr_log2 = ceil_log2(lanes < 32 ? lanes : 32);
  const int cpl = (nruns + (1 << lpr_log2) - 1) >> lpr_log2;
  cudaError_t err;
  if (vec) {
    err = cpl == 1   ? launch_rows<TX, TY, kVec, 1>(a, lpr_log2)
          : cpl == 2 ? launch_rows<TX, TY, kVec, 2>(a, lpr_log2)
          : cpl <= 4 ? launch_rows<TX, TY, kVec, 4>(a, lpr_log2)
                     : launch_rows<TX, TY, kVec, 8>(a, lpr_log2);
  } else {
    err = cpl == 1   ? launch_rows<TX, TY, 1, 1>(a, lpr_log2)
          : cpl == 2 ? launch_rows<TX, TY, 1, 2>(a, lpr_log2)
          : cpl <= 4 ? launch_rows<TX, TY, 1, 4>(a, lpr_log2)
                     : launch_rows<TX, TY, 1, 8>(a, lpr_log2);
  }
  if (err != cudaSuccess || a.num_long == 0) return err;
  long_rows_kernel<TY><<<(unsigned)a.num_long, kThreads, 0, a.stream>>>(
      a.partial, a.long_rows, a.long_first, static_cast<TY*>(a.y), a.D);
  return cudaGetLastError();
}

}  // namespace

// x_bf16 / y_bf16 select bf16 (1) or fp32 (0) for the table and the output.
// piece_start (int64), piece_row (int32): the num_pieces pieces of rows with
// more than L edges; long_rows (int32, num_long) and long_first (int32,
// num_long + 1): each long row and its first partial slot; partial: fp32
// scratch of (num_pieces, D).  Launches the row kernel and, when a row is
// long, the reduction of the partials, on `stream`.  Returns the first
// launch's cudaError_t (0 = launched).
extern "C" int segment_spmm(const void* indptr, const void* src, const void* w, const void* x,
                            void* y, long long num_dst, int D, int x_bf16, int y_bf16,
                            const void* piece_start, const void* piece_row,
                            const void* long_rows, const void* long_first, void* partial,
                            long long num_pieces, int num_long, int L, void* stream) {
  if (num_dst <= 0) return 0;
  if (D <= 0 || D > 256 || L <= 0 || num_pieces < 0 || num_long < 0 ||
      (num_long > 0) != (num_pieces > 0))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(src),
               static_cast<const float*>(w), x, y, static_cast<float*>(partial),
               static_cast<const int64_t*>(piece_start), static_cast<const int32_t*>(piece_row),
               static_cast<const int32_t*>(long_rows), static_cast<const int32_t*>(long_first),
               (int64_t)num_pieces, (int64_t)num_dst, num_long, D, L,
               static_cast<cudaStream_t>(stream)};
  if (x_bf16 && y_bf16) return (int)launch<__nv_bfloat16, __nv_bfloat16>(a);
  if (x_bf16) return (int)launch<__nv_bfloat16, float>(a);
  if (y_bf16) return (int)launch<float, __nv_bfloat16>(a);
  return (int)launch<float, float>(a);
}
