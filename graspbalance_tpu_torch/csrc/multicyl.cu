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
// in-bounds indices. Combos are radius-major: combo = ri * n_h + hi; up
// to 7 radii and 7 depths (the class encoding's cap in the JAX package,
// which also refuses thresholds that are not ascending) and at most 28
// combos, one lane each (the default model has 4 x 4, a num_depth=5 model
// 4 x 5, the single-scale model 1 x 4).
//
// What bounds it on the H100: instruction issue and latency along each
// seed's serial scan. A seed scans the cloud until all combos hold k hits:
// at the main path's shapes (4 x 1024 seeds x 20000 points, a synthetic
// scene) the largest cylinder holds ~1,400 points of a seed's cloud spread
// over the whole index range, the smallest ~200, so most scans run past half
// the cloud, at ~20 dependent operations a point for the rotation alone. The
// cloud (240 KB per batch row) stays in L1/L2; the output is 16 x 64
// indices per seed.
//
// Design: one block of kWarps warps per seed. The warps walk the cloud in
// lockstep rounds, warp w taking chunk 4 r + w of 32 points in round r, so
// the scan stops within one round of where the last combo fills and no
// point is tested twice.
//   - Each point's gripper-frame coordinates are computed once for all
//     combos, in the op order of graspbalance_tpu/ops/query.py:_rot_planes
//     with __fmul_rn/__fadd_rn (no FMA contraction, so hits match the plain
//     version bit for bit).
//   - The cull: x' > hmin && d2 < max r2 && x' < max hmax, the maxima over
//     the combos still open (fewer than k hits), holds for every point that
//     could still be kept, whatever the combos' order; one __ballot_sync of
//     it per chunk, and only where it is non-zero the rest.
//   - A combo is a radius and a depth: a chunk's hits of combo (r, h) are
//     the AND of one ballot per radius (d2 < r2[r]) and one per depth
//     (x' < hmax[h]), n_r + n_h ballots for all n_r x n_h combos. A warp
//     whose chunk passed the cull puts them in shared memory, one word a
//     lane, and sets its flag.
//   - The ordered combine, after one block barrier a round: lane c of every
//     warp takes combo c, ANDs the words of each flagged warp and counts
//     them, which gives its warp's first slot (the hits of the earlier
//     warps) and the round's hits. Then only the combos with hits in the
//     warp's chunk are visited: each hitting lane writes its index (and
//     coordinates) at that slot + its rank (__popc). Every warp keeps the
//     same counts, so all agree on which combos stay open and when the walk
//     ends. Shared words are double-buffered by round.
//   - Then the padding, the seed's combos dealt over its warps.
// The TPU kernel's bf16 hi/lo planes and one-hot matmuls were TPU
// workarounds: here the lane that owns a hit writes it directly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCombos = 28;  // lane c keeps combo c: at most 4 radii x 7 depths (or 7 x 4)
constexpr int kMaxSide = 7;     // radii or depths: the class encoding's cap (ops/query.py)
constexpr int kDepthLane = 16;  // the shared word of depth h is lane 16 + h, radius r's lane r
constexpr int kWarps = 4;  // warps per seed, a block per seed
static_assert(kWarps <= 4, "a warp's flag is one byte of a 32-bit word");

struct CylParams {
  float r2[kMaxCombos];    // radius^2 of each combo, radius-major
  float hmax[kMaxCombos];  // hmax of each combo
  float r2_of_radius[kMaxSide];
  float hmax_of_depth[kMaxSide];
  float hmin;
  int n_r, n_h, n_combos;
};

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

struct Frame {
  float cx, cy, cz;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;  // R[j][i] = r_ji

  // p' = R^T (p - c)
  __device__ __forceinline__ void rotate(float px, float py, float pz, float& xr, float& yr, float& zr) const {
    const float dx = __fsub_rn(px, cx), dy = __fsub_rn(py, cy), dz = __fsub_rn(pz, cz);
    xr = dot3(dx, r00, dy, r10, dz, r20);
    yr = dot3(dx, r01, dy, r11, dz, r21);
    zr = dot3(dx, r02, dy, r12, dz, r22);
  }
};

// the cull's thresholds: the largest r2 and hmax over the open combos
__device__ __forceinline__ void open_maxima(const CylParams& prm, unsigned open, float& r2, float& hm) {
  r2 = -1.0f;
  hm = -3.4e38f;
  for (unsigned a = open; a != 0u; a &= a - 1u) {
    const int c = __ffs(a) - 1;
    r2 = fmaxf(r2, prm.r2[c]);
    hm = fmaxf(hm, prm.hmax[c]);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    multicyl_kernel(const float* __restrict__ planes, const float* __restrict__ centers,
                    const float* __restrict__ rot, int n, int m, int k, const __grid_constant__ CylParams prm,
                    int32_t* __restrict__ idx, float* __restrict__ rel) {
  // by round parity and warp: lane r < 7 the ballot of radius r, lane 16 + h that of depth h
  __shared__ uint32_t words[2][kWarps][32];
  __shared__ uint32_t passed[2];  // by round parity: byte w = 1 if warp w's chunk passed the cull
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int seed = blockIdx.x;
  const int b = blockIdx.y;
  const unsigned lt = (1u << lane) - 1u;

  const float* px = planes + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const size_t bs = static_cast<size_t>(b) * m + seed;
  Frame f;
  f.cx = centers[bs * 3 + 0];
  f.cy = centers[bs * 3 + 1];
  f.cz = centers[bs * 3 + 2];
  const float* rr = rot + bs * 9;  // row-major R[j][i] = rr[3 * j + i]
  f.r00 = rr[0], f.r01 = rr[1], f.r02 = rr[2];
  f.r10 = rr[3], f.r11 = rr[4], f.r12 = rr[5];
  f.r20 = rr[6], f.r21 = rr[7], f.r22 = rr[8];

  // lane c < n_combos keeps combo c's hits so far, the same in every warp
  const bool my_combo = lane < prm.n_combos;
  const int my_r = my_combo ? lane / prm.n_h : 0;
  const int my_h = my_combo ? lane % prm.n_h : 0;
  int count = 0;
  const size_t row_of_combo0 = (static_cast<size_t>(b) * prm.n_combos * m + seed) * k;
  const size_t combo_stride = static_cast<size_t>(m) * k;
  unsigned open = (1u << prm.n_combos) - 1u;
  float r2_open, hm_open;
  open_maxima(prm, open, r2_open, hm_open);
  const int chunks = (n + 31) / 32;
  int par = 0;
  for (int base = 0; base < chunks && open != 0u; base += kWarps, par ^= 1) {
    const int i = (base + w) * 32 + lane;
    float xr = 0.0f, yr = 0.0f, zr = 0.0f, d2 = 0.0f;
    bool cand = false;
    if (i < n) {
      f.rotate(__ldg(px + i), __ldg(py + i), __ldg(pz + i), xr, yr, zr);
      d2 = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(zr, zr));
      cand = xr > prm.hmin && d2 < r2_open && xr < hm_open;
    }
    const unsigned any = __ballot_sync(0xffffffffu, cand);
    if (any != 0u) {
      uint32_t word = 0u;
#pragma unroll
      for (int r = 0; r < kMaxSide; ++r) {
        if (r < prm.n_r) {
          const unsigned v = __ballot_sync(0xffffffffu, cand && d2 < prm.r2_of_radius[r]);
          word = lane == r ? v : word;
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxSide; ++h) {
        if (h < prm.n_h) {
          const unsigned v = __ballot_sync(0xffffffffu, xr < prm.hmax_of_depth[h]);
          word = lane == kDepthLane + h ? v : word;
        }
      }
      words[par][w][lane] = word;
    }
    if (lane == 0) reinterpret_cast<uint8_t*>(&passed[par])[w] = any != 0u;
    __syncthreads();  // the round's words written; the other parity's are free

    const uint32_t flags = passed[par];
    if (flags == 0u) continue;  // the same in every warp
    // lane c: combo c's hits in the chunks of the earlier warps, in this
    // warp's chunk (a lane mask) and in the whole round
    int earlier = 0, round = 0;
    unsigned mine = 0u;
    if (my_combo && (open >> lane & 1u)) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (flags >> (8 * v) & 1u) {
          const unsigned hits = words[par][v][my_r] & words[par][v][kDepthLane + my_h];
          const int nh = __popc(hits);
          earlier += v < w ? nh : 0;
          mine = v == w ? hits : mine;
          round += nh;
        }
      }
    }
    const int first_slot = count + earlier;
    for (unsigned a = __ballot_sync(0xffffffffu, mine != 0u); a != 0u; a &= a - 1u) {
      const int c = __ffs(a) - 1;
      const unsigned hits = __shfl_sync(0xffffffffu, mine, c);
      const int slot = __shfl_sync(0xffffffffu, first_slot, c) + __popc(hits & lt);
      if ((hits >> lane & 1u) && slot < k) {
        const size_t o = row_of_combo0 + c * combo_stride + slot;
        idx[o] = i;
        if (rel != nullptr) {
          rel[o * 3 + 0] = xr;
          rel[o * 3 + 1] = yr;
          rel[o * 3 + 2] = zr;
        }
      }
    }
    count += round;
    const unsigned still = __ballot_sync(0xffffffffu, my_combo && count < k);
    if (still != open) {
      open = still;
      open_maxima(prm, open, r2_open, hm_open);
    }
  }
  __syncthreads();  // every hit of the seed written and visible

  // padding: this warp's share of the seed's combos
  float x0, y0, z0;
  f.rotate(px[0], py[0], pz[0], x0, y0, z0);
  for (int c = w; c < prm.n_combos; c += kWarps) {
    const int hits = min(__shfl_sync(0xffffffffu, count, c), k);
    const size_t row = row_of_combo0 + c * combo_stride;
    int32_t fi = 0;
    float fx = x0, fy = y0, fz = z0;
    if (hits > 0) {
      fi = idx[row];
      if (rel != nullptr) {
        fx = rel[row * 3 + 0];
        fy = rel[row * 3 + 1];
        fz = rel[row * 3 + 2];
      }
    }
    for (int slot = hits + lane; slot < k; slot += 32) {
      idx[row + slot] = fi;
      if (rel != nullptr) {
        rel[(row + slot) * 3 + 0] = fx;
        rel[(row + slot) * 3 + 1] = fy;
        rel[(row + slot) * 3 + 2] = fz;
      }
    }
  }
}

}  // namespace

// planes: (B, 3, N) f32; centers: (B, M, 3) f32; rot: (B, M, 3, 3) f32;
// r2, hmax: (n_combos,) f32 host arrays, radius-major over n_combos / n_h
// radii x n_h depths; idx: (B, n_combos, M, k) int32; rel: (B, n_combos, M,
// k, 3) f32 or null.
extern "C" int gb_multicyl(const float* planes, const float* centers, const float* rot,
                           const float* r2, const float* hmax, float hmin, int n_combos, int n_h,
                           int32_t* idx, float* rel, int b, int n, int m, int k, void* stream) {
  if (n_combos < 1 || n_combos > kMaxCombos || n_h < 1 || n_h > kMaxSide || n_combos % n_h != 0 ||
      n_combos / n_h > kMaxSide || b < 1 || b > 65535 || n < 1 || m < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CylParams prm{};
  for (int c = 0; c < n_combos; ++c) {
    prm.r2[c] = r2[c];
    prm.hmax[c] = hmax[c];
    prm.r2_of_radius[c / n_h] = r2[c];
    prm.hmax_of_depth[c % n_h] = hmax[c];
  }
  prm.hmin = hmin;
  prm.n_r = n_combos / n_h;
  prm.n_h = n_h;
  prm.n_combos = n_combos;
  const dim3 grid(m, b);
  multicyl_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(planes, centers, rot, n, m, k, prm,
                                                                                idx, rel);
  return static_cast<int>(cudaGetLastError());
}
