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
// against 0.2 MB of input and 1 MB of output. The cost is the selection:
// each candidate is compared against a sorted list in registers.
//
// Design: one warp per query, eight queries of one batch row per block. The
// block streams the reference cloud through shared memory in tiles; lane l
// scans the tile's references l, l + 32, ... and keeps a sorted private
// top-K of (d2, index) pairs in registers (K a template parameter, unrolled
// so the list never leaves registers). The warp then merges the 32 lists in
// k rounds: a lexicographic (d2, index) warp-min over the lists' heads, and
// the winning lane pops its head. Index order, not lane order, breaks ties,
// so the result does not depend on how the scan was split over lanes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 1024;  // references per shared-memory tile

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// (d, i) before (od, oi): smaller distance, then lower index.
__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ ref_planes, int q_n,
               int r_n, int k, float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ float s_z[kTile];

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool active = q < q_n;  // inactive warps still help load the tiles

  const float* rx = ref_planes + static_cast<size_t>(b) * 3 * r_n;
  const float* ry = rx + r_n;
  const float* rz = ry + r_n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * q_n + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = inf();
    bi[s] = INT_MAX;
  }

  for (int t0 = 0; t0 < r_n; t0 += kTile) {
    const int len = min(kTile, r_n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_x[i] = rx[t0 + i];
      s_y[i] = ry[t0 + i];
      s_z[i] = rz[t0 + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = lane; i < len; i += 32) {
      const float dx = __fsub_rn(qx, s_x[i]);
      const float dy = __fsub_rn(qy, s_y[i]);
      const float dz = __fsub_rn(qz, s_z[i]);
      float cd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      int ci = t0 + i;
      if (!before(cd, ci, bd[K - 1], bi[K - 1])) continue;
      // insertion into the sorted list: the candidate bubbles down, each
      // displaced entry moves one slot back
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (before(cd, ci, bd[s], bi[s])) {
          const float td = bd[s];
          const int ti = bi[s];
          bd[s] = cd;
          bi[s] = ci;
          cd = td;
          ci = ti;
        }
      }
    }
  }
  if (!active) return;

  // merge: k rounds of a warp-wide lexicographic min over the lists' heads
  float od = 0.0f;
  int oi = 0;
  for (int r = 0; r < k; ++r) {
    float wd = bd[0];
    int wi = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float xd = __shfl_xor_sync(0xffffffffu, wd, off);
      const int xi = __shfl_xor_sync(0xffffffffu, wi, off);
      if (before(xd, xi, wd, wi)) {
        wd = xd;
        wi = xi;
      }
    }
    if (bi[0] == wi) {  // indices are unique across lanes: one lane pops
#pragma unroll
      for (int s = 0; s < K - 1; ++s) {
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
      }
      bd[K - 1] = inf();
      bi[K - 1] = INT_MAX;
    }
    if (lane == r) {
      od = wd;
      oi = wi;
    }
  }
  if (lane < k) {
    const size_t o = (static_cast<size_t>(b) * q_n + q) * k + lane;
    dist[o] = sqrtf(fmaxf(od, 0.0f));
    idx[o] = oi;
  }
}

template <int K>
cudaError_t launch(const float* query, const float* ref_planes, float* dist, int32_t* idx, int b,
                   int q_n, int r_n, int k, cudaStream_t stream) {
  const dim3 grid((q_n + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  knn_kernel<K><<<grid, kWarpsPerBlock * 32, 0, stream>>>(query, ref_planes, q_n, r_n, k, dist, idx);
  return cudaGetLastError();
}

}  // namespace

// query: (B, Q, 3) f32; ref_planes: (B, 3, R) f32; dist: (B, Q, k) f32;
// idx: (B, Q, k) int32. 1 <= k <= 32 and k <= R.
extern "C" int gb_knn(const float* query, const float* ref_planes, float* dist, int32_t* idx,
                      int b, int q_n, int r_n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k < 1 || k > r_n) err = cudaErrorInvalidValue;
  else if (k <= 8) err = launch<8>(query, ref_planes, dist, idx, b, q_n, r_n, k, s);
  else if (k <= 16) err = launch<16>(query, ref_planes, dist, idx, b, q_n, r_n, k, s);
  else if (k <= 32) err = launch<32>(query, ref_planes, dist, idx, b, q_n, r_n, k, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
