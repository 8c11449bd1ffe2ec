// Greedy furthest point sampling, (B, N, 3) f32 -> (B, m) int32, and its
// masked mode over per-row valid subsets.
//
// Replaces graspbalance_tpu/ops/pallas/fps_kernel.py:fps_pallas_2d_batched,
// and with it the same function in the older layouts fps_pallas_2d and
// fps_pallas; the masked mode (gb_fps_masked) replaces
// fps_pallas_2d_batched_masked, OBS's per-object FPS.
//
// Semantics: idx[0] = 0; the running distance starts at 1e10; a point with
// |p|^2 <= 1e-3 is never selected (its distance starts at -1, and
// min(-1, d) stays -1); each step takes the point with the largest running
// distance, the lowest index on a tie. The wrapper passes the initial
// distances (validity folded in, as the TPU kernel folds it).
//
// What bounds it on the H100: latency, not bytes or FLOPs. Each of the m-1
// steps is a min + argmax over the whole cloud whose winner the next step
// needs, so the steps cannot overlap; a (4, 20000) cloud is 240 KB per batch
// row, and the work per step is ~20k distance updates.
//
// Design: one block per cloud, 1024 threads. Thread t owns points
// t, t + 1024, ... and keeps their running distances in registers; the
// coordinates stay in the (B, 3, N) planes and are read through L1 (they do
// not fit in shared memory beside anything else at N = 20000). Each step
// reduces (value, index) pairs: warp shuffles, then one warp over the 32
// warp winners in shared memory. The comparison prefers the lower index on
// equal values, so the result does not depend on thread or warp order. The
// distance is written with __fmul_rn/__fadd_rn so that nvcc cannot contract
// it into an FMA: the plain version rounds every product, and one flipped
// last bit on a near-tie changes every later index. The planes are not
// marked __restrict__: with it, nvcc kept more values live across the step
// loop and spilled at the 64-register cap of a 1024-thread block (12.0 ms
// against 7.6 ms at (4, 20000) -> 2048 on an NVIDIA H100 80GB HBM3, 700 W).
//
// Masked mode: the initial-distance plane carries validity (-1 for an
// invalid point, as above); the seed is each row's first valid index (index
// 0 for a row with none), and the step count is read from a device int32,
// max_needed, clamped to [1, m], so that OBS launches without a host sync.
// Slots from max_needed on are written as 0 (the caller promises not to read
// them). OBS runs S = B x 16 rows of N = 4096 compacted points: one
// 512-thread block per row, 8 distances per thread, so that each step's
// reduction spans 16 warps rather than 32.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;       // main path: (4, 20000)
constexpr int kMaskedThreads = 512;  // OBS: (64, 4096)

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower index.
__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    keep_better(v, i, ov, oi);
  }
}

template <int T, int P, bool MASKED>
__global__ void __launch_bounds__(T, 1)
    fps_kernel(const float* planes, const float* __restrict__ dist0, int n, int m,
               const int32_t* __restrict__ needed, int32_t* __restrict__ out) {
  constexpr int kWarps = T / 32;
  const float* px = planes + static_cast<size_t>(blockIdx.x) * 3 * n;
  const float* d0 = dist0 + static_cast<size_t>(blockIdx.x) * n;
  const float* py = px + n;
  const float* pz = py + n;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_best;

  float dist[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = t + p * T;
    dist[p] = i < n ? d0[i] : -1.0f;
  }

  int seed = 0;
  int steps = m;
  if (MASKED) {
    // seed: the first valid index (0 when the row has none)
    int first = INT_MAX;
#pragma unroll
    for (int p = P - 1; p >= 0; --p) {
      if (dist[p] > 0.0f) first = t + p * T;
    }
    if (t == 0) s_best = INT_MAX;
    __syncthreads();
    if (first != INT_MAX) atomicMin(&s_best, first);
    __syncthreads();
    seed = s_best == INT_MAX ? 0 : s_best;
    steps = min(max(*needed, 1), m);
    for (int j = steps + t; j < m; j += T) o[j] = 0;
  }
  if (t == 0) o[0] = seed;

  float lx = px[seed], ly = py[seed], lz = pz[seed];
  for (int j = 1; j < steps; ++j) {
    float bv = -2.0f;  // below every running distance (>= -1)
    int bi = INT_MAX;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = t + p * T;
      if (i < n) {
        const float d = sq3(__fsub_rn(px[i], lx), __fsub_rn(py[i], ly),
                            __fsub_rn(pz[i], lz));
        const float nd = fminf(dist[p], d);
        dist[p] = nd;
        if (nd > bv) {  // i rises with p: strict > keeps the lowest index
          bv = nd;
          bi = i;
        }
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : -2.0f;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        s_best = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    const int best = s_best;
    lx = __ldg(px + best);
    ly = __ldg(py + best);
    lz = __ldg(pz + best);
  }
}

template <int T, int P, bool MASKED>
cudaError_t launch(const float* planes, const float* dist0, const int32_t* needed, int32_t* out,
                   int b, int n, int m, cudaStream_t stream) {
  fps_kernel<T, P, MASKED><<<b, T, 0, stream>>>(planes, dist0, n, m, needed, out);
  return cudaGetLastError();
}

}  // namespace

// planes: (B, 3, N) f32; dist0: (B, N) f32 initial distances (1e10, or -1
// for a point never to be selected); out: (B, m) int32. N <= 32768.
extern "C" int gb_fps(const float* planes, const float* dist0, int32_t* out, int b, int n, int m,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_thread = (n + kThreads - 1) / kThreads;
  constexpr int T = kThreads;
  cudaError_t err;
  if (per_thread <= 1) err = launch<T, 1, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 2) err = launch<T, 2, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 4) err = launch<T, 4, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 8) err = launch<T, 8, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 16) err = launch<T, 16, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 20) err = launch<T, 20, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 24) err = launch<T, 24, false>(planes, dist0, nullptr, out, b, n, m, s);
  else if (per_thread <= 32) err = launch<T, 32, false>(planes, dist0, nullptr, out, b, n, m, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Masked mode. planes: (S, 3, N) f32; dist0: (S, N) f32 (1e10 for a valid
// point, -1 otherwise); needed: one device int32, the number of leading
// slots the caller reads; out: (S, m) int32. N <= 32768 (rows past 16384
// points take the main path's 1024-thread blocks).
extern "C" int gb_fps_masked(const float* planes, const float* dist0, const int32_t* needed,
                             int32_t* out, int b, int n, int m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_thread = (n + kMaskedThreads - 1) / kMaskedThreads;
  constexpr int T = kMaskedThreads;
  cudaError_t err;
  if (per_thread <= 1) err = launch<T, 1, true>(planes, dist0, needed, out, b, n, m, s);
  else if (per_thread <= 2) err = launch<T, 2, true>(planes, dist0, needed, out, b, n, m, s);
  else if (per_thread <= 4) err = launch<T, 4, true>(planes, dist0, needed, out, b, n, m, s);
  else if (per_thread <= 8) err = launch<T, 8, true>(planes, dist0, needed, out, b, n, m, s);
  else if (per_thread <= 16) err = launch<T, 16, true>(planes, dist0, needed, out, b, n, m, s);
  else if (per_thread <= 32) err = launch<T, 32, true>(planes, dist0, needed, out, b, n, m, s);
  else if (n <= 20 * kThreads) err = launch<kThreads, 20, true>(planes, dist0, needed, out, b, n, m, s);
  else if (n <= 32 * kThreads) err = launch<kThreads, 32, true>(planes, dist0, needed, out, b, n, m, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
