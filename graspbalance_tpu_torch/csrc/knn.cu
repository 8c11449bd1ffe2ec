// Exact k nearest neighbours, query (B, Q, 3) x ref (B, R, 3) f32 ->
// dist (B, Q, k) f32 euclidean, ascending, and idx (B, Q, k) int32.
//
// Replaces graspbalance_tpu/ops/pallas/knn_kernel.py:knn_pallas (the DSN
// point transformer's k = 16 neighbour search).
//
// Semantics: d2 = (dx*dx + dy*dy) + dz*dz with d = q - r, every product and
// sum rounded on its own; the k smallest (d2, index) pairs in lexicographic
// order, so ties go to the lower index; dist = sqrt(max(d2, 0)).
//
// What bounds it on the H100: neither bytes nor FLOPs at the DSN's shapes.
// (4, 2048) x (4, 2048) is 16.8 M pairs, 134 MFLOP (2 us at the FP32 peak),
// against 0.2 MB of input and 1 MB of output. The cost is the selection.
//
// Design: a filtered warp-select (after FAISS's WarpSelect: Johnson, Douze
// and Jegou, "Billion-scale similarity search with GPUs", 2017). One warp
// per query, 16 queries of one batch row per block; the block streams the
// references through shared memory in tiles, read straight from (B, R, 3).
//   - A candidate is one 64-bit key: the bits of d2 (>= 0, so they order as
//     the floats do) above the index. Keys are unique, and their order is
//     the lexicographic (d2, index) order, so ties go to the lower index
//     whatever the lane order.
//   - The warp holds its sorted best 32 keys, lane l the l-th; the k-th
//     (lane k - 1) is the threshold. The first 32 candidates are sorted by
//     a bitonic network of shuffles.
//   - Each later round tests 32 candidates, one a lane, against the
//     threshold with one ballot (full rounds without a bounds check). Most
//     rounds end there. Each candidate that passed, lowest lane first, is
//     tested again against the threshold as it now stands and inserted: its
//     slot is the first lane whose key is larger (a ballot), the lanes from
//     there take their left neighbour's key (one shuffle), and the
//     threshold is read again.
//   - The counting instantiation (a stats pointer) adds its rounds, the
//     rounds in which a candidate passed, and its insertions.
// The TPU kernel's masked-argmin passes over a (Q, R) distance tile were a
// TPU layout; here only candidates below the threshold cost more than a
// compare.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;   // queries per block
constexpr int kTile = 2048;  // references per shared-memory tile (32 KB)
constexpr unsigned kFull = 0xffffffffu;

using Key = unsigned long long;
constexpr Key kNone = ~0ull;  // after every real key

__device__ __forceinline__ Key make_key(float d2, int i) {
  return (static_cast<Key>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(i);
}

// Sorts one key a lane ascending over the warp (bitonic network).
__device__ __forceinline__ Key warp_sort(Key v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key other = __shfl_xor_sync(kFull, v, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = (lower == ascending) ? (other < v ? other : v) : (other > v ? other : v);
    }
  }
  return v;
}

// One round: lane l's candidate is reference i0 + l of the tile (none past
// len when kGuard). The candidates below the threshold are inserted, lowest
// lane first, each tested again against the threshold as it then stands.
template <bool kGuard, bool kStats>
__device__ __forceinline__ void scan_round(const float4* s_ref, int i0, int len, int base, float qx, float qy,
                                      float qz, int k, int lane, Key& list, Key& thr, unsigned* counts) {
  Key c = kNone;
  if (!kGuard || i0 + lane < len) {
    const float4 r = s_ref[i0 + lane];
    const float dx = __fsub_rn(qx, r.x);
    const float dy = __fsub_rn(qy, r.y);
    const float dz = __fsub_rn(qz, r.z);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    c = make_key(d2, base + i0 + lane);
  }
  unsigned mask = __ballot_sync(kFull, c < thr);
  if constexpr (kStats) {
    ++counts[0];
    counts[1] += mask != 0;
  }
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const Key x = __shfl_sync(kFull, c, src);
    if (x >= thr) continue;  // warp-uniform: an earlier insert raised the bar
    const int pos = __ffs(__ballot_sync(kFull, x < list)) - 1;  // <= k - 1, as x < thr
    const Key up = __shfl_up_sync(kFull, list, 1);
    if (lane == pos) list = x;
    else if (lane > pos) list = up;
    thr = __shfl_sync(kFull, list, k - 1);
    if constexpr (kStats) ++counts[2];
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ ref, int q_n, int r_n, int k,
               float* __restrict__ dist, int32_t* __restrict__ idx, unsigned long long* __restrict__ stats) {
  __shared__ float4 s_ref[kTile];

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = q < q_n;  // inactive warps still help load the tiles

  const float* rb = ref + static_cast<size_t>(b) * r_n * 3;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * q_n + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }

  Key list = kNone;  // lane l: the l-th smallest key so far
  Key thr = kNone;   // the k-th smallest (lane k - 1)
  unsigned counts[3] = {0, 0, 0};  // rounds after the first, rounds with a pass, insertions
  for (int t0 = 0; t0 < r_n; t0 += kTile) {
    const int len = min(kTile, r_n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kWarps * 32) {
      const float* r = rb + static_cast<size_t>(t0 + i) * 3;
      s_ref[i] = make_float4(r[0], r[1], r[2], 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    int i0 = 0;
    if (t0 == 0) {  // the first 32 candidates, sorted, start the list
      Key c = kNone;
      if (lane < len) {
        const float4 r = s_ref[lane];
        const float dx = __fsub_rn(qx, r.x);
        const float dy = __fsub_rn(qy, r.y);
        const float dz = __fsub_rn(qz, r.z);
        c = make_key(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), lane);
      }
      list = warp_sort(c, lane);
      thr = __shfl_sync(kFull, list, k - 1);
      i0 = 32;
    }
    for (; i0 + 32 <= len; i0 += 32)
      scan_round<false, kStats>(s_ref, i0, len, t0, qx, qy, qz, k, lane, list, thr, counts);
    if (i0 < len) scan_round<true, kStats>(s_ref, i0, len, t0, qx, qy, qz, k, lane, list, thr, counts);
  }
  if (!active) return;
  if (lane < k) {
    const size_t o = (static_cast<size_t>(b) * q_n + q) * k + lane;
    dist[o] = sqrtf(fmaxf(__uint_as_float(static_cast<unsigned>(list >> 32)), 0.0f));
    idx[o] = static_cast<int32_t>(list & 0xffffffffu);
  }
  if constexpr (kStats) {
    if (lane == 0)
      for (int j = 0; j < 3; ++j) atomicAdd(stats + j, static_cast<unsigned long long>(counts[j]));
  }
}

}  // namespace

// query: (B, Q, 3) f32; ref: (B, R, 3) f32; dist: (B, Q, k) f32; idx:
// (B, Q, k) int32. 1 <= k <= 32 and k <= R. stats: null, or three uint64
// that the kernel adds its rounds after the first, the rounds in which a
// candidate passed the threshold, and the insertions to.
extern "C" int gb_knn(const float* query, const float* ref, float* dist, int32_t* idx,
                      unsigned long long* stats, int b, int q_n, int r_n, int k, void* stream) {
  if (b < 1 || q_n < 1 || k < 1 || k > 32 || k > r_n) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((q_n + kWarps - 1) / kWarps, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats == nullptr) knn_kernel<false><<<grid, kWarps * 32, 0, s>>>(query, ref, q_n, r_n, k, dist, idx, stats);
  else knn_kernel<true><<<grid, kWarps * 32, 0, s>>>(query, ref, q_n, r_n, k, dist, idx, stats);
  return static_cast<int>(cudaGetLastError());
}
