// Box-occupancy counts of the collision filter: for every grasp and every
// valid scene point, the point's gripper-frame coordinates, the eight box
// tests and six counts [left, right, bottom, shifting, overall, inner].
// points (B, 3, N) f32 planes, valid (B, N) uint8, params (B, G, 24) f32 ->
// counts (B, G, 6) int32 (the caller zeroes it and converts to f32).
//
// Replaces graspbalance_tpu/ops/pallas/collision_kernel.py:
// collision_counts_pallas (parameter layout of its pack_grasp_params).
//
// Semantics: with d_j = p_j - t_j, x = (d0*rx0 + d1*rx1) + d2*rx2 and y, z
// alike (the Pallas kernel's association, every product and sum rounded on
// its own: __fmul_rn/__fadd_rn keep nvcc from contracting into FMAs, which
// could move a point across a box face); the comparisons are those of
// graspbalance_tpu/eval/collision.py, all on float32 values.
//
// What bounds it on the H100: operations. At bs=4 x 1024 grasps x ~12k
// valid voxel centroids it is ~50 M grasp-point pairs of ~34 FP32 operations
// each (1.7 G operations, ~0.03 ms at the 67 TFLOP/s FP32 peak), against
// under 1 MB of input.
//
// Design: one thread per grasp keeps the grasp's 20 parameters and six
// integer counters in registers. Scene points stream through shared memory
// in tiles that every thread of the block reads by broadcast. The grid
// splits N as well as G and B (B x G/128 x N/kChunk blocks), so that four
// scenes of 1024 grasps fill the 132 SMs; each block adds its partial
// counts with integer atomicAdd, which is exact in any order. A tile of
// points past the last valid one is skipped as a whole (the voxel-
// downsampled scene keeps its valid centroids in the leading slots).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // grasps per block
constexpr int kTile = 512;     // points per shared-memory tile
constexpr int kChunk = 2048;   // points per block
constexpr int kParams = 24;

__global__ void __launch_bounds__(kThreads)
    collision_kernel(const float* __restrict__ planes, const uint8_t* __restrict__ valid,
                     const float* __restrict__ params, int n, int g_n,
                     int32_t* __restrict__ counts) {
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ float s_z[kTile];
  __shared__ uint8_t s_v[kTile];
  __shared__ int s_any;

  const int b = blockIdx.z;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool active = g < g_n;
  const float* px = planes + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const uint8_t* vb = valid + static_cast<size_t>(b) * n;

  float prm[20];
#pragma unroll
  for (int c = 0; c < 20; ++c) {
    prm[c] = active ? params[(static_cast<size_t>(b) * g_n + g) * kParams + c] : 0.0f;
  }
  const float zlo = prm[12], zhi = prm[13], dep = prm[14], dfl = prm[15];
  const float dflw = prm[16], dflwa = prm[17], w2 = prm[18], w2fw = prm[19];
  const float nw2 = -w2, nw2fw = -w2fw;

  int c_left = 0, c_right = 0, c_bottom = 0, c_shift = 0, c_overall = 0, c_inner = 0;

  const int lo = blockIdx.y * kChunk;
  const int hi = min(n, lo + kChunk);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int len = min(kTile, hi - t0);
    __syncthreads();
    if (threadIdx.x == 0) s_any = 0;
    __syncthreads();
    int any = 0;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      s_x[i] = px[t0 + i];
      s_y[i] = py[t0 + i];
      s_z[i] = pz[t0 + i];
      s_v[i] = vb[t0 + i];
      any |= vb[t0 + i];
    }
    if (any) s_any = 1;
    __syncthreads();
    if (!s_any) continue;  // block-uniform: no valid point in this tile
    if (!active) continue;
    for (int i = 0; i < len; ++i) {
      if (!s_v[i]) continue;
      const float d0 = __fsub_rn(s_x[i], prm[9]);
      const float d1 = __fsub_rn(s_y[i], prm[10]);
      const float d2 = __fsub_rn(s_z[i], prm[11]);
      const float x = __fadd_rn(__fadd_rn(__fmul_rn(d0, prm[0]), __fmul_rn(d1, prm[1])),
                                __fmul_rn(d2, prm[2]));
      const float y = __fadd_rn(__fadd_rn(__fmul_rn(d0, prm[3]), __fmul_rn(d1, prm[4])),
                                __fmul_rn(d2, prm[5]));
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(d0, prm[6]), __fmul_rn(d1, prm[7])),
                                __fmul_rn(d2, prm[8]));
      const bool m_h = (z > zlo) & (z < zhi);
      const bool m_d = (x > dfl) & (x < dep);
      const bool m_lo = y > nw2fw;
      const bool m_li = y < nw2;
      const bool m_ro = y < w2fw;
      const bool m_ri = y > w2;
      const bool m_b = (x <= dfl) & (x > dflw);
      const bool m_s = (x <= dflw) & (x > dflwa);
      const bool left = m_h & m_d & m_lo & m_li;
      const bool right = m_h & m_d & m_ro & m_ri;
      const bool bottom = m_h & m_lo & m_ro & m_b;
      const bool shifting = m_h & m_lo & m_ro & m_s;
      c_left += left;
      c_right += right;
      c_bottom += bottom;
      c_shift += shifting;
      c_overall += left | right | bottom | shifting;
      c_inner += m_h & m_d & !m_li & !m_ri;
    }
  }
  if (!active) return;
  int32_t* o = counts + (static_cast<size_t>(b) * g_n + g) * 6;
  if (c_left) atomicAdd(o + 0, c_left);
  if (c_right) atomicAdd(o + 1, c_right);
  if (c_bottom) atomicAdd(o + 2, c_bottom);
  if (c_shift) atomicAdd(o + 3, c_shift);
  if (c_overall) atomicAdd(o + 4, c_overall);
  if (c_inner) atomicAdd(o + 5, c_inner);
}

}  // namespace

// planes: (B, 3, N) f32; valid: (B, N) uint8 (0 or 1); params: (B, G, 24)
// f32; counts: (B, G, 6) int32, zeroed by the caller.
extern "C" int gb_collision(const float* planes, const uint8_t* valid, const float* params,
                            int32_t* counts, int b, int n, int g_n, void* stream) {
  if (b < 1 || n < 1 || g_n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g_n + kThreads - 1) / kThreads, (n + kChunk - 1) / kChunk, b);
  collision_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, valid, params, n, g_n, counts);
  return static_cast<int>(cudaGetLastError());
}
