// Exact top-k of every row of a row-major fp32 score matrix, for Hopper
// (sm_90a), in one read of the scores.
//
//   values[b, :], ids[b, :] = the k largest scores[b, i] with their i, in
//   descending order; equal scores in ascending i
//
// Replaces a stock op, not a Pallas kernel: torch.topk on the port's
// single-device ranking path (eval/ranking.py _full_batch, eval/retrieval.py
// topk_for_users).  The JAX package ranks there with XLA's lax.top_k
// (eval/ranking.py:203), whose rule for equal scores this kernel keeps: the
// lower index first, as a stable descending sort cut to k does
// (ops/topk_select.py topk_select_reference, the plain version).
//
// What bounds it: bytes.  Every score is read once, rows * cols * 4 bytes
// (2.048 GB for 512 x 1,000,000: 0.611 ms at 3.35 TB/s); the candidates'
// scratch and the output are rows * k words.  torch.topk is a radix select
// that reads each row once per digit pass and once more to gather.
//
// The design (warp select):
//   * each score becomes a 64-bit key: the order-preserving uint32 image of
//     the fp32 value (-0.0 folded onto +0.0, every NaN onto one NaN above
//     +inf, as torch.sort orders them) in the high half, 0xFFFFFFFF - id in
//     the low half.  Keys are distinct, and a larger key is a larger score
//     or an equal score at a lower id;
//   * kernel 1, topk_select_chunks_kernel: a CTA a (row, chunk), the row cut
//     into `chunks` slices by the wrapper.  The CTA streams its slice with
//     16-byte loads (kUnroll in flight a thread), peeling to 16-byte
//     alignment when cols % 4 != 0.  Each warp keeps the best K = 32 * R
//     keys it has seen in registers, sorted across lanes (lane-strided:
//     element e = r * 32 + lane), and its k-th key as a threshold, held as
//     a float too.  A score below the float threshold is dropped by one
//     compare; when no lane of the warp has a score at or above it in a
//     load step (nearly always, once the queue has filled), the step costs
//     16 compares and one vote.  Otherwise each passing key that beats the
//     threshold goes into its lane's thread queue (R slots); when any
//     lane's queue is full the warp merges the thread queues into the warp
//     queue and raises the threshold.  With keys in more than kFewLanes
//     lanes (a queue filling up) it sorts the thread queues (a bitonic sort
//     of K keys in registers and shuffles), keeps the better of them
//     against the warp queue (elementwise max of the descending queue and
//     the ascending new keys, a bitonic sequence) and sorts that with a
//     bitonic merge; with fewer (the steady state, where a key gets in now
//     and then) it puts each key at its rank by a ballot and a shift.  Any
//     warp's k-th key bounds the row's top k, so after a step that let keys
//     in, a warp raises a CTA-wide threshold in shared memory to its own,
//     and every warp filters by the higher of the two.  At the end of the
//     slice the CTA's warps leave their k best in shared memory, warp 0
//     selects the CTA's k best from them and writes them to the scratch;
//   * kernel 2, topk_select_merge_kernel: a warp a row selects the k best of
//     the row's chunks * k candidates the same way and writes the values
//     (read back from the scores at the selected ids, so they are the
//     scores' own bits) and the int64 ids, in descending key order.
// R = 1 for k <= 32, 2 for k <= 64, 4 for k <= 128, 8 for k <= 256 (R = 8
// keeps 16 keys a thread in registers and may spill under the 4-CTA launch
// bound; the main path's k = 20 takes R = 1).  Template flag kCount (never set on the
// main path) counts the thread-queue insertions of kernel 1 into a 64-bit
// counter: the share of scores that got past the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;                     // kernel 1: 8 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;                     // CTAs an SM: ops/topk_select_cuda.CTAS_PER_SM
constexpr int kUnroll = 4;                        // 16-byte loads in flight a thread
constexpr int kStep = kUnroll * 4;                // scores a thread a load step
constexpr int kMergeThreads = 128;                // kernel 2: a warp a row
constexpr int kFewLanes = 4;                      // up to this many lanes' keys go in one by one
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ordered(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;                           // -0.0 ranks as +0.0
  if ((b & 0x7fffffffu) > 0x7f800000u) b = 0x7fc00000u;   // NaN above +inf
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float x, int64_t id) {
  return ((u64)ordered(x) << 32) | (u64)(0xffffffffu - (uint32_t)id);
}

// the score of a key's high half (key 0, the empty slot, lets every score by)
__device__ __forceinline__ float key_score(u64 key) {
  if (key == 0ull) return -__int_as_float(0x7f800000);
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// One warp's best K = 32 * R keys.  Every call is made by the whole warp.
template <int R>
struct WarpSelect {
  u64 q[R];        // warp queue, descending over e = r * 32 + lane
  u64 t[R];        // this lane's thread queue, the newest first; 0 = empty
  int n;           // keys in t
  int k;
  u64 thr;         // the warp queue's k-th key
  float thr_f;     // its score: a score below it cannot enter

  __device__ __forceinline__ explicit WarpSelect(int k_) : n(0), k(k_), thr(0ull) {
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = t[r] = 0ull;
    thr_f = key_score(0ull);
  }

  // sorts t ascending over e = r * 32 + lane
  __device__ __forceinline__ void sort_thread_queues(int lane) {
#pragma unroll
    for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (stride >= 32) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int rp = r ^ (stride >> 5);
            if (r < rp) {
              const bool up = (((r << 5) + lane) & size) == 0;
              const u64 lo = kmin(t[r], t[rp]), hi = kmax(t[r], t[rp]);
              t[r] = up ? lo : hi;
              t[rp] = up ? hi : lo;
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const u64 other = __shfl_xor_sync(kFull, t[r], stride);
            const bool up = (((r << 5) + lane) & size) == 0;
            const bool lower = (lane & stride) == 0;
            t[r] = (lower == up) ? kmin(t[r], other) : kmax(t[r], other);
          }
        }
      }
    }
  }

  // puts one key (the same in every lane) at its rank in q; the last drops out
  __device__ __forceinline__ void insert(u64 key, int lane) {
    int pos = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) pos += __popc(__ballot_sync(kFull, q[r] > key));
    u64 prev = 0ull;  // the old q[r - 1] of lane 31, for lane 0 of q[r]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u64 up = __shfl_up_sync(kFull, q[r], 1);
      if (lane == 0) up = prev;
      prev = __shfl_sync(kFull, q[r], 31);
      const int e = (r << 5) + lane;
      q[r] = e < pos ? q[r] : (e == pos ? key : up);
    }
  }

  // the K best of q and t into q, descending; empties t
  __device__ __forceinline__ void merge(int lane) {
    unsigned pending = __ballot_sync(kFull, n > 0);
    if (__popc(pending) <= kFewLanes) {
      // a few keys (the steady state): one at a time, from the lowest lane
      while (pending) {
        const int src = __ffs(pending) - 1;
        insert(__shfl_sync(kFull, t[0], src), lane);
        if (lane == src) {
#pragma unroll
          for (int r = 0; r + 1 < R; ++r) t[r] = t[r + 1];
          t[R - 1] = 0ull;
          --n;
        }
        pending = __ballot_sync(kFull, n > 0);
      }
    } else {
      sort_thread_queues(lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        q[r] = kmax(q[r], t[r]);  // descending vs ascending: a bitonic sequence
        t[r] = 0ull;
      }
#pragma unroll
      for (int stride = 16 * R; stride > 0; stride >>= 1) {
        if (stride >= 32) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int rp = r ^ (stride >> 5);
            if (r < rp) {
              const u64 lo = kmin(q[r], q[rp]), hi = kmax(q[r], q[rp]);
              q[r] = hi;
              q[rp] = lo;
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const u64 other = __shfl_xor_sync(kFull, q[r], stride);
            q[r] = (lane & stride) == 0 ? kmax(q[r], other) : kmin(q[r], other);
          }
        }
      }
      n = 0;
    }
    const int kr = (k - 1) >> 5;
    u64 mine = q[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      if (r == kr) mine = q[r];
    thr = __shfl_sync(kFull, mine, (k - 1) & 31);
    thr_f = key_score(thr);
  }

  // offers one key a lane (0 offers nothing); true if it entered the thread queue
  __device__ __forceinline__ bool add(u64 key, int lane) {
    const bool in = key > thr;
    if (in) {
#pragma unroll
      for (int r = R - 1; r > 0; --r) t[r] = t[r - 1];
      t[0] = key;
      ++n;
    }
    if (__any_sync(kFull, n == R)) merge(lane);
    return in;
  }

  __device__ __forceinline__ void flush(int lane) {
    if (__any_sync(kFull, n > 0)) merge(lane);
  }
};

template <int R, bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_select_chunks_kernel(const float* __restrict__ scores, int64_t cols, int chunks, int k,
                          u64* __restrict__ cand, u64* __restrict__ counter) {
  __shared__ float stage[kStep * kThreads];       // a thread's load step, on the slow path
  __shared__ u64 best[kWarps * 32 * R];           // each warp's k best
  __shared__ u64 cta_thr;                         // the highest of the warps' k-th keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) cta_thr = 0ull;
  __syncthreads();
  const int64_t row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - (int)(row * chunks);
  const int64_t per = (cols + chunks - 1) / chunks;
  const int64_t lo = chunk * per < cols ? chunk * per : cols;
  const int64_t hi = lo + per < cols ? lo + per : cols;
  const float* rowp = scores + row * cols;
  // the 16-byte aligned body [a0, a0 + 4 * n4) and at most 3 + 3 scores around it
  const int mis = (int)((reinterpret_cast<uintptr_t>(rowp + lo) >> 2) & 3);
  int64_t a0 = lo + ((4 - mis) & 3);
  if (a0 > hi) a0 = hi;
  const int64_t n4 = (hi - a0) >> 2;
  const int64_t a1 = a0 + 4 * n4;
  const float4* body = reinterpret_cast<const float4*>(rowp + a0);

  WarpSelect<R> ws(k);
  unsigned inserted = 0;
  for (int64_t base = 0; base < n4; base += (int64_t)kThreads * kUnroll) {
    // any warp's k-th key bounds the row's top k: take the CTA's highest
    const u64 shared_thr = *reinterpret_cast<volatile u64*>(&cta_thr);
    if (shared_thr > ws.thr) {
      ws.thr = shared_thr;
      ws.thr_f = key_score(shared_thr);
    }
    float4 v[kUnroll];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + tid;
      v[u] = i < n4 ? __ldcs(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      any |= (i < n4) & (!(v[u].x < ws.thr_f) | !(v[u].y < ws.thr_f)
                         | !(v[u].z < ws.thr_f) | !(v[u].w < ws.thr_f));
    }
    if (!__any_sync(kFull, any)) continue;
    // slow path: some lane has a score at or above the threshold
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      stage[(4 * u + 0) * kThreads + tid] = v[u].x;
      stage[(4 * u + 1) * kThreads + tid] = v[u].y;
      stage[(4 * u + 2) * kThreads + tid] = v[u].z;
      stage[(4 * u + 3) * kThreads + tid] = v[u].w;
    }
#pragma unroll 1
    for (int e = 0; e < kStep; ++e) {
      const int64_t i = base + (e >> 2) * kThreads + tid;
      const float x = stage[e * kThreads + tid];
      const bool pass = i < n4 && !(x < ws.thr_f);
      inserted += ws.add(pass ? make_key(x, a0 + 4 * i + (e & 3)) : 0ull, lane);
    }
    if (lane == 0) atomicMax(&cta_thr, ws.thr);
  }
  {  // the unaligned head [lo, a0) and tail [a1, hi), a score a thread
    const int nh = (int)(a0 - lo), nt = (int)(hi - a1);
    const int64_t id = tid < nh ? lo + tid : a1 + (tid - nh);
    const bool valid = tid < nh + nt;
    inserted += ws.add(valid ? make_key(rowp[id], id) : 0ull, lane);
  }
  ws.flush(lane);
  if (kCount) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) inserted += __shfl_xor_sync(kFull, inserted, s);
    if (lane == 0) atomicAdd(counter, (u64)inserted);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (r << 5) + lane;
    if (e < k) best[warp * k + e] = ws.q[r];
  }
  __syncthreads();
  if (warp != 0) return;
  WarpSelect<R> cta(k);
  for (int base = 0; base < kWarps * k; base += 32) {
    const int i = base + lane;
    cta.add(i < kWarps * k ? best[i] : 0ull, lane);
  }
  cta.flush(lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (r << 5) + lane;
    if (e < k) cand[(int64_t)blockIdx.x * k + e] = cta.q[r];
  }
}

template <int R>
__global__ void __launch_bounds__(kMergeThreads)
topk_select_merge_kernel(const float* __restrict__ scores, const u64* __restrict__ cand,
                         int64_t rows, int64_t cols, int chunks, int k,
                         float* __restrict__ values, int64_t* __restrict__ ids) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int n = chunks * k;
  const u64* c = cand + row * n;
  WarpSelect<R> ws(k);
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    ws.add(i < n ? c[i] : 0ull, lane);
  }
  ws.flush(lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (r << 5) + lane;
    if (e < k) {
      const int64_t id = (int64_t)(0xffffffffu - (uint32_t)ws.q[r]);
      ids[row * k + e] = id;
      values[row * k + e] = scores[row * cols + id];
    }
  }
}

template <int R, bool kCount>
cudaError_t launch(const float* scores, int64_t rows, int64_t cols, int k, int chunks,
                   u64* cand, float* values, int64_t* ids, u64* counter, cudaStream_t stream) {
  topk_select_chunks_kernel<R, kCount><<<(unsigned)(rows * chunks), kThreads, 0, stream>>>(
      scores, cols, chunks, k, cand, counter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = kMergeThreads / 32;
  topk_select_merge_kernel<R><<<(unsigned)((rows + per_block - 1) / per_block), kMergeThreads, 0,
                                stream>>>(scores, cand, rows, cols, chunks, k, values, ids);
  return cudaGetLastError();
}

}  // namespace

// scores: (rows, cols) fp32 row-major; cand: rows * chunks * k words of
// scratch; values (rows, k) fp32 and ids (rows, k) int64 out; counter: one
// 64-bit word that kernel 1's thread-queue insertions are added to, or null
// (the main path).  Launches both kernels on `stream` of `device`.  The
// caller checks the shape (ops/topk_select_cuda.shape_error: rows >= 1,
// 1 <= k <= 256, k <= cols < 2**31, rows * chunks < 2**31).  Returns the
// launches' cudaError_t (0 = launched).
extern "C" int topk_select(const float* scores, long long rows, long long cols, int k,
                           int chunks, void* cand, float* values, long long* ids,
                           void* counter, int device, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(cand);
  u64* cnt = static_cast<u64*>(counter);
  int64_t* out = reinterpret_cast<int64_t*>(ids);
  if (k <= 32)
    err = cnt ? launch<1, true>(scores, rows, cols, k, chunks, c, values, out, cnt, s)
              : launch<1, false>(scores, rows, cols, k, chunks, c, values, out, cnt, s);
  else if (k <= 64)
    err = cnt ? launch<2, true>(scores, rows, cols, k, chunks, c, values, out, cnt, s)
              : launch<2, false>(scores, rows, cols, k, chunks, c, values, out, cnt, s);
  else if (k <= 128)
    err = cnt ? launch<4, true>(scores, rows, cols, k, chunks, c, values, out, cnt, s)
              : launch<4, false>(scores, rows, cols, k, chunks, c, values, out, cnt, s);
  else
    err = cnt ? launch<8, true>(scores, rows, cols, k, chunks, c, values, out, cnt, s)
              : launch<8, false>(scores, rows, cols, k, chunks, c, values, out, cnt, s);
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
