// All (radius, depth) cylinder queries of the grasp head in one pass over the
// cloud: first-k-by-index neighbour indices for every combo, and optionally
// the neighbours' coordinates in the gripper frame.
//
// Replaces graspbalance_tpu/ops/pallas/multicyl_kernel.py:multi_cylinder_group.
//
// Semantics (the reference cylinder query): p' = R^T (p - c); a point hits
// combo (r, h) iff y'^2 + z'^2 < r^2, x' > hmin and x' < hmax[h], all strict.
// The first k hits in index order are kept; slots past the hit count repeat
// the first hit; a seed with no hit gets index 0 everywhere and the rotated
// coordinates of point 0. No -1 is ever written: the gather after it assumes
// in-bounds indices. Combos are radius-major: combo = ri * n_h + hi.
//
// What bounds it on the H100: instruction issue. Every seed tests every
// point for every combo until all combos hold k hits, which for the
// smallest cylinder usually means the whole cloud: 4 x 1024 seeds x 20000
// points x 16 combos at the main path's shapes. The cloud (240 KB per batch
// row) stays in L1/L2; the output is 16 x 64 indices per seed.
//
// Design: one warp per (batch, seed), eight seeds per block. The warp walks
// the cloud in index order, 32 points at a time, and computes each point's
// gripper-frame coordinates once for all combos, in the op order of
// graspbalance_tpu/ops/query.py:_rot_planes with __fmul_rn/__fadd_rn (no FMA
// contraction, so hits match the plain version bit for bit). For each combo,
// __ballot_sync + __popc give every hitting lane its slot; the per-combo
// counts are warp-uniform registers, and the walk stops once all combos are
// full. The TPU kernel's bf16 hi/lo planes and one-hot matmuls were TPU
// workarounds: here the lane that owns a hit writes it directly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCombos = 16;
constexpr int kWarpsPerBlock = 8;

struct CylParams {
  float r2[kMaxCombos];    // radius^2 of each combo, radius-major
  float hmax[kMaxCombos];  // hmax of each combo
  float hmin;
  int n_combos;
};

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    multicyl_kernel(const float* __restrict__ planes, const float* __restrict__ centers,
                    const float* __restrict__ rot, int n, int m, int k, CylParams prm,
                    int32_t* __restrict__ idx, float* __restrict__ rel) {
  const int lane = threadIdx.x & 31;
  const int seed = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (seed >= m) return;  // the whole warp leaves together

  const float* px = planes + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const size_t bs = static_cast<size_t>(b) * m + seed;
  const float cx = centers[bs * 3 + 0], cy = centers[bs * 3 + 1], cz = centers[bs * 3 + 2];
  const float* rr = rot + bs * 9;  // row-major R[j][i] = rr[3 * j + i]
  const float r00 = rr[0], r01 = rr[1], r02 = rr[2];
  const float r10 = rr[3], r11 = rr[4], r12 = rr[5];
  const float r20 = rr[6], r21 = rr[7], r22 = rr[8];

  int count[kMaxCombos];
#pragma unroll
  for (int c = 0; c < kMaxCombos; ++c) count[c] = 0;

  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float xr = 0.0f, yr = 0.0f, zr = 0.0f, d2 = 0.0f;
    bool inside = false;
    if (i < n) {
      const float dx = __fsub_rn(__ldg(px + i), cx);
      const float dy = __fsub_rn(__ldg(py + i), cy);
      const float dz = __fsub_rn(__ldg(pz + i), cz);
      xr = dot3(dx, r00, dy, r10, dz, r20);
      yr = dot3(dx, r01, dy, r11, dz, r21);
      zr = dot3(dx, r02, dy, r12, dz, r22);
      d2 = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(zr, zr));
      inside = xr > prm.hmin;
    }
    bool all_full = true;
#pragma unroll
    for (int c = 0; c < kMaxCombos; ++c) {
      if (c < prm.n_combos && count[c] < k) {
        const bool hit = inside && d2 < prm.r2[c] && xr < prm.hmax[c];
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int slot = count[c] + __popc(mask & ((1u << lane) - 1u));
          if (slot < k) {
            const size_t o = ((static_cast<size_t>(b) * prm.n_combos + c) * m + seed) * k + slot;
            idx[o] = i;
            if (rel != nullptr) {
              rel[o * 3 + 0] = xr;
              rel[o * 3 + 1] = yr;
              rel[o * 3 + 2] = zr;
            }
          }
        }
        count[c] += __popc(mask);
        all_full = all_full && count[c] >= k;
      }
    }
    if (all_full) break;  // counts are warp-uniform, so is the break
  }

  // Padding. The first hit was written by some lane of this warp; __syncwarp
  // orders those writes before the reads below.
  __syncwarp();
  const float dx0 = __fsub_rn(px[0], cx), dy0 = __fsub_rn(py[0], cy), dz0 = __fsub_rn(pz[0], cz);
  const float x0 = dot3(dx0, r00, dy0, r10, dz0, r20);
  const float y0 = dot3(dx0, r01, dy0, r11, dz0, r21);
  const float z0 = dot3(dx0, r02, dy0, r12, dz0, r22);
#pragma unroll
  for (int c = 0; c < kMaxCombos; ++c) {
    if (c < prm.n_combos) {
      const int filled = min(count[c], k);
      const size_t row = ((static_cast<size_t>(b) * prm.n_combos + c) * m + seed) * k;
      int32_t fi = 0;
      float fx = x0, fy = y0, fz = z0;
      if (filled > 0) {
        fi = idx[row];
        if (rel != nullptr) {
          fx = rel[row * 3 + 0];
          fy = rel[row * 3 + 1];
          fz = rel[row * 3 + 2];
        }
      }
      for (int slot = filled + lane; slot < k; slot += 32) {
        idx[row + slot] = fi;
        if (rel != nullptr) {
          rel[(row + slot) * 3 + 0] = fx;
          rel[(row + slot) * 3 + 1] = fy;
          rel[(row + slot) * 3 + 2] = fz;
        }
      }
    }
  }
}

}  // namespace

// planes: (B, 3, N) f32; centers: (B, M, 3) f32; rot: (B, M, 3, 3) f32;
// r2, hmax: (n_combos,) f32 host arrays, radius-major; idx: (B, n_combos, M, k)
// int32; rel: (B, n_combos, M, k, 3) f32 or null.
extern "C" int gb_multicyl(const float* planes, const float* centers, const float* rot,
                           const float* r2, const float* hmax, float hmin, int n_combos,
                           int32_t* idx, float* rel, int b, int n, int m, int k, void* stream) {
  if (n_combos < 1 || n_combos > kMaxCombos) return static_cast<int>(cudaErrorInvalidValue);
  CylParams prm{};
  for (int c = 0; c < n_combos; ++c) {
    prm.r2[c] = r2[c];
    prm.hmax[c] = hmax[c];
  }
  prm.hmin = hmin;
  prm.n_combos = n_combos;
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  multicyl_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, centers, rot, n, m, k, prm, idx, rel);
  return static_cast<int>(cudaGetLastError());
}
