// Box-occupancy counts of the collision filter: for every grasp and every
// valid scene point, the point's gripper-frame coordinates, the eight box
// tests and six counts [left, right, bottom, shifting, overall, inner].
// points (B, N, 3) f32, valid (B, N) uint8, params (B, G, 24) f32 ->
// counts (B, G, 6) f32 integer counts.
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
// What bounds it on the H100: operations. At bs=4 x 1024 grasps x ~13k
// valid voxel centroids it is ~54 M grasp-point pairs of ~36 FP32 operations
// each, against under 1 MB of input. Without FMA a pair issues ~40
// instructions, so the issue slots, not the FP32 peak, set the floor.
//
// Design: most pairs cannot hit, and a conservative cull per grasp and
// 32-point tile skips them before any pair is computed.
//   - collision_prep_kernel ranks each scene's grasps by center x (a total
//     order on the float bits, ties to the lower index; 7 warps count the
//     keys below 32 grasps' in runs of 4 while the 8th bounds the grasps in
//     the world, below) and writes their parameters in rank order,
//     field-major, so that a warp's 32 grasps lie close together in x. It
//     zeroes the counts and writes a record per 32-point tile: the bounding
//     box of its valid points with finite coordinates (a point with a
//     non-finite coordinate has a non-finite x, which no box counts for
//     finite parameters) and whether it holds a valid point at all.
//   - collision_kernel: a block of 8 warps takes a chunk of 128 points (4
//     tiles) and every grasp of its scene, a group of 32 ranked grasps at
//     a time, one a lane: warp w takes groups w, w + 8, ... It loads the
//     chunk's tile records and points and the world bounds of its warps'
//     first 4 groups each together, in one round trip; a block whose chunk
//     holds no valid point (past a scene's valid prefix) exits there, and a
//     group whose grasps' world bounds all miss the chunk's box has nothing
//     to count and loads no more. The ranked order puts the groups a chunk
//     needs next to each other, so they fall to different warps. The
//     points go to shared memory, invalid ones as NaN (which no box test
//     counts).
//   - Each lane keeps a tile for its grasp unless one of two tests proves
//     that no point of the tile's box can be counted: the world box test
//     (the tile's box misses the grasp's boxes' world bounds) and the
//     gripper-frame test (the ranges of x, y, z over the tile's box, by
//     interval arithmetic in the kernel's own rounding, miss every count's
//     conditions).
//   - Each lane then counts only its own kept tiles: in step j it takes
//     its j-th (its lanes read different tiles, on different banks), and
//     the warp runs as many steps as its busiest lane has tiles, not as
//     many as the union of its lanes' tiles.
//   - A tile's 32 points run unrolled; each box test sets one bit of a
//     mask per count, and the tile's counts are the masks' popcounts,
//     overall the popcount of their union.
//   - Partial counts are added to the float counts with atomicAdd: they are
//     integers below 2^24 (N < 2^24 is checked), so every sum is exact in
//     any order.
//
// Why the culls are sound. Gripper frame: round-to-nearest subtraction,
// multiplication by a constant and addition are monotone, so for every
// point in [lo, hi] the kernel's x lies in [fl(sum of the endpoint
// products' minima), fl(sum of their maxima)] computed with the same
// operations in the same order; when all six bounds are finite so is every
// point's x, y, z, and the box tests are decided by the bounds. World: a
// counted point has its rounded gripper coordinates g in the boxes' union
// U; with |g - M d| <= 8u |M| |d| (u = 2^-24, d = p - t, M the rows rx, ry,
// rz) and R = I - M^T M, d = M^T g + (8u |M^T| |M| + |R|) |d| componentwise,
// which bounds |d| and then each d_j; the bounds are computed in double
// without FMA and rounded outward to float. A grasp whose parameters are
// not all finite is never culled; one whose M is too far from orthonormal
// (||8u |M^T||M| + |R|||_inf > 1/2) keeps only the gripper-frame test.
// ops/collision.py:tile_may_hit is the plain twin of both tests, and
// tests/test_torch_collision_cull.py holds it to the counts.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kParams = 24;          // the packed parameters per grasp
constexpr int kFields = 28;          // ranked: 20 parameters, 6 world bounds, index, cull flag
constexpr int kTile = 32;            // points per culled tile
constexpr int kRecord = 8;           // per tile: lo, hi of its finite valid points, any valid, any finite
constexpr int kWarps = 8;            // per block of the counting kernel, a grasp a lane
constexpr int kChunk = 128;          // points per block of the counting kernel
constexpr int kTiles = kChunk / kTile;
constexpr int kBatch = 4;            // groups of 32 grasps a warp bounds per round trip
constexpr int kPrepThreads = 256;    // 8 warps: rank 32 grasps, or bound 8 tiles
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kKeyTile = 2048;       // keys per shared-memory tile of the ranking

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }

// A total order on float bits that agrees with < on non-NaN values.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The world box bounds of grasp p (20 parameters): lo[j] <= p_j <= hi[j] for
// every point that any count takes; (-inf, inf) where a parameter is not
// finite or M is too far from orthonormal. Every double operation is rounded on its own so that
// ops/collision.py:world_bounds gives the same floats.
__device__ void world_bounds(const float* p, float* lo, float* hi) {
  constexpr double kGamma = 1.0 / (1 << 21);  // 8u: bounds |fl(x) - x|'s 4u of a gripper coordinate
  constexpr double kSlack = 1.0 / (1ll << 40);  // the double arithmetic's own rounding
  double m[3][3];
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 3; ++j) m[a][j] = p[3 * a + j];
  const double xl = fminf(fminf(p[15], p[16]), p[17]);
  const double xh = fmaxf(fmaxf(p[14], p[15]), p[16]);
  const double ym = fmaxf(fabsf(p[18]), fabsf(p[19]));
  const double bc[3] = {__dmul_rn(__dadd_rn(xl, xh), 0.5), 0.0, __dmul_rn(__dadd_rn(p[12], p[13]), 0.5)};
  const double bh[3] = {fmax(__dmul_rn(__dsub_rn(xh, xl), 0.5), 0.0), ym,
                        fmax(__dmul_rn(__dsub_rn(p[13], p[12]), 0.5), 0.0)};
  double kr[3], cen[3], hal[3];
  double kappa = 0.0, cmax = 0.0;
  for (int j = 0; j < 3; ++j) {
    kr[j] = 0.0;
    for (int l = 0; l < 3; ++l) {
      double mm = 0.0, aa = 0.0;
      for (int a = 0; a < 3; ++a) {
        mm = __dadd_rn(mm, __dmul_rn(m[a][j], m[a][l]));
        aa = __dadd_rn(aa, __dmul_rn(fabs(m[a][j]), fabs(m[a][l])));
      }
      const double r = __dsub_rn(j == l ? 1.0 : 0.0, mm);
      kr[j] = __dadd_rn(kr[j], __dadd_rn(__dmul_rn(kGamma, aa), fabs(r)));
    }
    kappa = fmax(kappa, kr[j]);
    cen[j] = 0.0;
    hal[j] = 0.0;
    for (int a = 0; a < 3; ++a) {
      cen[j] = __dadd_rn(cen[j], __dmul_rn(m[a][j], bc[a]));
      hal[j] = __dadd_rn(hal[j], __dmul_rn(fabs(m[a][j]), bh[a]));
    }
    cmax = fmax(cmax, __dadd_rn(fabs(cen[j]), hal[j]));
  }
  const double dmax = __ddiv_rn(cmax, __dsub_rn(1.0, kappa));
  float sum = 0.0f;
  for (int c = 0; c < 20; ++c) sum += fabsf(p[c]);
  bool ok = sum <= FLT_MAX && kappa <= 0.5;
  for (int j = 0; j < 3; ++j) {
    const double t = p[9 + j];
    const double c = __dadd_rn(t, cen[j]);
    double h = __dadd_rn(hal[j], __dmul_rn(kr[j], dmax));
    h = __dadd_rn(h, __dadd_rn(__dmul_rn(kSlack, __dadd_rn(__dadd_rn(fabs(t), fabs(cen[j])), h)), 1e-35));
    lo[j] = __double2float_rd(__dsub_rn(c, h));
    hi[j] = __double2float_ru(__dadd_rn(c, h));
    ok = ok && fabsf(lo[j]) <= FLT_MAX && fabsf(hi[j]) <= FLT_MAX;
  }
  if (!ok) {
    for (int j = 0; j < 3; ++j) {
      lo[j] = -inf();
      hi[j] = inf();
    }
  }
}

// Blocks x < ceil(G / 32) rank 32 grasps each by center x into `ranked`
// (B, kFields, G), with their world bounds, and zero their counts; the other
// blocks write the records (B, T, kRecord) of 8 tiles each.
__global__ void __launch_bounds__(kPrepThreads)
    collision_prep_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                          const float* __restrict__ params, int n, int g_n, float* __restrict__ ranked,
                          float* __restrict__ tiles, float* __restrict__ counts) {
  __shared__ __align__(16) unsigned s_key[kKeyTile];
  __shared__ int s_rank[kPrepWarps][32];
  __shared__ float s_out[kFields][32];  // the 32 grasps' ranked fields
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rank = (g_n + 31) / 32;
  if (blockIdx.x >= n_rank) {
    const int n_tiles = (n + kTile - 1) / kTile;
    const int t = (blockIdx.x - n_rank) * kPrepWarps + warp;
    if (t >= n_tiles) return;
    const int i = t * kTile + lane;
    float q[3] = {0.0f, 0.0f, 0.0f};
    if (i < n)
      for (int j = 0; j < 3; ++j) q[j] = points[(static_cast<size_t>(b) * n + i) * 3 + j];
    const bool any = i < n && valid[static_cast<size_t>(b) * n + i];
    const bool fin = any && finite(q[0]) && finite(q[1]) && finite(q[2]);
    float lo[3], hi[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lo[j] = fin ? q[j] : inf();
      hi[j] = fin ? q[j] : -inf();
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        lo[j] = fminf(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], off));
        hi[j] = fmaxf(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], off));
      }
    }
    const float rec[kRecord] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2],
                                __any_sync(0xffffffffu, any) ? 1.0f : 0.0f,
                                __any_sync(0xffffffffu, fin) ? 1.0f : 0.0f};
    if (lane < kRecord) tiles[(static_cast<size_t>(b) * n_tiles + t) * kRecord + lane] = rec[lane];
    return;
  }
  const float* pb = params + static_cast<size_t>(b) * g_n * kParams;
  const int g0 = blockIdx.x * 32;
  const int g = g0 + lane;
  if (warp == 0) {  // the fields, with the world bounds, beside the other warps' ranking
    float p[20], lo[3], hi[3];
    float sum = 0.0f;
    for (int c = 0; c < 20; ++c) {
      p[c] = g < g_n ? pb[static_cast<size_t>(g) * kParams + c] : 0.0f;
      sum += fabsf(p[c]);
    }
    world_bounds(p, lo, hi);
    for (int c = 0; c < 20; ++c) s_out[c][lane] = p[c];
    for (int j = 0; j < 3; ++j) {
      s_out[20 + j][lane] = lo[j];
      s_out[23 + j][lane] = hi[j];
    }
    s_out[26][lane] = __int_as_float(g);
    s_out[27][lane] = sum <= FLT_MAX ? 1.0f : 0.0f;  // all 20 finite: the culls hold
  }
  const unsigned key = g < g_n ? order_key(pb[static_cast<size_t>(g) * kParams + 9]) : 0u;
  int rank = 0;
  for (int j0 = 0; j0 < g_n; j0 += kKeyTile) {
    const int len = min(kKeyTile, g_n - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < kKeyTile; j += kPrepThreads)
      s_key[j] = j < len ? order_key(pb[static_cast<size_t>(j0 + j) * kParams + 9]) : ~0u;
    __syncthreads();
    if (warp == 0) continue;
    // warp w takes every (kPrepWarps - 1)-th run of 4 keys from run w - 1
    for (int j = 4 * (warp - 1); j < len; j += 4 * (kPrepWarps - 1)) {
      const uint4 k4 = *reinterpret_cast<const uint4*>(s_key + j);
      const unsigned kj[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)  // keys past len are ~0u, after every real key
        rank += (kj[u] < key) | ((kj[u] == key) & (j0 + j + u < g));
    }
  }
  s_rank[warp][lane] = rank;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kPrepWarps; ++w) rank += s_rank[w][lane];
    s_rank[0][lane] = rank;
  }
  __syncthreads();
  // every thread writes fields of the 32 grasps at their ranks, and zeroes counts
  const int m = min(32, g_n - g0);
  float* out = ranked + static_cast<size_t>(b) * kFields * g_n;
  for (int i = threadIdx.x; i < kFields * 32; i += kPrepThreads) {
    const int f = i / 32, l = i % 32;
    if (l < m) out[static_cast<size_t>(f) * g_n + s_rank[0][l]] = s_out[f][l];
  }
  for (int i = threadIdx.x; i < 6 * m; i += kPrepThreads) counts[(static_cast<size_t>(b) * g_n + g0) * 6 + i] = 0.0f;
}

struct Grasp {
  float p[20];
  float wlo[3], whi[3];
  int index;
  bool cull;  // finite parameters: the culls hold
};

// The range [vmin, vmax] of one gripper coordinate (axis a, translation t)
// over the box [lo, hi], in the counting loop's operations and order.
__device__ __forceinline__ void axis_range(const float* a, const float* t, const float* lo, const float* hi,
                                           float& vmin, float& vmax) {
  float mn[3], mx[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float pl = __fmul_rn(__fsub_rn(lo[j], t[j]), a[j]);
    const float ph = __fmul_rn(__fsub_rn(hi[j], t[j]), a[j]);
    mn[j] = fminf(pl, ph);
    mx[j] = fmaxf(pl, ph);
  }
  vmin = __fadd_rn(__fadd_rn(mn[0], mn[1]), mn[2]);
  vmax = __fadd_rn(__fadd_rn(mx[0], mx[1]), mx[2]);
}

// Whether any point in the non-empty box [lo, hi] can be counted for grasp
// g (finite parameters); false is a proof that none can.
__device__ __forceinline__ bool tile_may_hit(const Grasp& g, const float* lo, const float* hi) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (hi[j] < g.wlo[j] || lo[j] > g.whi[j]) return false;
  float x0, x1, y0, y1, z0, z1;
  axis_range(g.p + 0, g.p + 9, lo, hi, x0, x1);
  axis_range(g.p + 3, g.p + 9, lo, hi, y0, y1);
  axis_range(g.p + 6, g.p + 9, lo, hi, z0, z1);
  if (!(fabsf(__fadd_rn(__fadd_rn(__fadd_rn(x0, x1), __fadd_rn(y0, y1)), __fadd_rn(z0, z1))) <= FLT_MAX))
    return true;  // a bound is not finite: no proof
  const float* p = g.p;
  const float zlo = p[12], zhi = p[13], dep = p[14], dfl = p[15], dflw = p[16], dflwa = p[17];
  const float w2 = p[18], w2fw = p[19];
  const bool h = z1 > zlo && z0 < zhi;       // z in (zlo, zhi): every count
  const bool xd = x1 > dfl && x0 < dep;      // x in (dfl, dep): left, right, inner
  const bool xb = x1 > dflw && x0 <= dfl;    // x in (dflw, dfl]: bottom
  const bool xs = x1 > dflwa && x0 <= dflw;  // x in (dflwa, dflw]: shifting
  const bool yl = y1 > -w2fw && y0 < -w2;    // left
  const bool yr = y1 > w2 && y0 < w2fw;      // right
  const bool ybs = y1 > -w2fw && y0 < w2fw;  // bottom, shifting
  const bool yi = y1 >= -w2 && y0 <= w2;     // inner
  return h && ((xd && (yl || yr || yi)) || ((xb || xs) && ybs));
}

struct Masks {
  unsigned left = 0, right = 0, bottom = 0, shift = 0, inner = 0;
};

// Point i of a tile: sets bit i of each count's mask that takes it.
__device__ __forceinline__ void test_point(const Grasp& g, const float4 q, int i, Masks& m) {
  const float* p = g.p;
  const float d0 = __fsub_rn(q.x, p[9]);
  const float d1 = __fsub_rn(q.y, p[10]);
  const float d2 = __fsub_rn(q.z, p[11]);
  const float x = __fadd_rn(__fadd_rn(__fmul_rn(d0, p[0]), __fmul_rn(d1, p[1])), __fmul_rn(d2, p[2]));
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(d0, p[3]), __fmul_rn(d1, p[4])), __fmul_rn(d2, p[5]));
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(d0, p[6]), __fmul_rn(d1, p[7])), __fmul_rn(d2, p[8]));
  const float zlo = p[12], zhi = p[13], dep = p[14], dfl = p[15];
  const float dflw = p[16], dflwa = p[17], w2 = p[18], w2fw = p[19];
  const bool m_h = (z > zlo) & (z < zhi);
  const bool m_d = (x > dfl) & (x < dep);
  const bool m_lo = y > -w2fw;
  const bool m_li = y < -w2;
  const bool m_ro = y < w2fw;
  const bool m_ri = y > w2;
  const bool m_b = (x <= dfl) & (x > dflw);
  const bool m_s = (x <= dflw) & (x > dflwa);
  const unsigned bit = 1u << i;
  if (m_h & m_d & m_lo & m_li) m.left |= bit;
  if (m_h & m_d & m_ro & m_ri) m.right |= bit;
  if (m_h & m_lo & m_ro & m_b) m.bottom |= bit;
  if (m_h & m_lo & m_ro & m_s) m.shift |= bit;
  if (m_h & m_d & !m_li & !m_ri) m.inner |= bit;
}

__global__ void __launch_bounds__(kWarps * 32)
    collision_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                     const float* __restrict__ ranked_all, const float* __restrict__ tiles, int n, int g_n,
                     float* __restrict__ counts, unsigned long long* __restrict__ stats) {
  // a tile a row, padded so that lanes reading point i of different tiles
  // hit different banks; row kTiles stays NaN, for lanes with no tile left
  __shared__ float4 s_pts[kTiles + 1][kTile + 1];
  __shared__ float s_rec[kTiles][kRecord];
  __shared__ float s_world[kBatch][kWarps][6][32];  // world bounds of a batch of groups

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kChunk;
  const int len = min(kChunk, n - c0);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int t0 = blockIdx.x * kTiles;
  const int tiles_here = min(kTiles, n_tiles - t0);
  const int n_groups = (g_n + 31) / 32;
  const float* ranked = ranked_all + static_cast<size_t>(b) * kFields * g_n;

  // the world bounds of the warp's groups base + warp + k * kWarps
  auto load_world = [&](int base) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = (base + warp + k * kWarps) * 32 + lane;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        s_world[k][warp][j][lane] = r < g_n ? ranked[static_cast<size_t>(20 + j) * g_n + r] : (j < 3 ? inf() : -inf());
    }
  };

  // one round trip: the chunk's tile records and points, and the world
  // bounds of the first batch of groups
  if (threadIdx.x < tiles_here * kRecord)
    (&s_rec[0][0])[threadIdx.x] = tiles[(static_cast<size_t>(b) * n_tiles + t0) * kRecord + threadIdx.x];
  const float* pb = points + (static_cast<size_t>(b) * n + c0) * 3;
  const uint8_t* vb = valid + static_cast<size_t>(b) * n + c0;
  for (int i = threadIdx.x; i < kChunk + kTile; i += kWarps * 32) {
    float4 q = make_float4(nan(), nan(), nan(), 0.0f);
    if (i < len) {
      q = make_float4(pb[3 * i], pb[3 * i + 1], pb[3 * i + 2], 0.0f);
      if (!vb[i]) q = make_float4(nan(), nan(), nan(), 0.0f);
    }
    s_pts[i / kTile][i % kTile] = q;
  }
  load_world(0);
  __syncthreads();

  // the chunk: its tiles with a valid point, and the box of their finite ones
  unsigned any_tiles = 0;
  float clo[3] = {inf(), inf(), inf()}, chi[3] = {-inf(), -inf(), -inf()};
  for (int t = 0; t < tiles_here; ++t) {
    any_tiles |= static_cast<unsigned>(s_rec[t][6] != 0.0f) << t;
    for (int j = 0; j < 3; ++j) {
      clo[j] = fminf(clo[j], s_rec[t][j]);
      chi[j] = fmaxf(chi[j], s_rec[t][3 + j]);
    }
  }
  if (!any_tiles) return;  // block-uniform: no valid point (past a scene's valid prefix)

  unsigned kept = 0, total = 0;
  for (int base = 0; base < n_groups; base += kBatch * kWarps) {
    if (base > 0) load_world(base);  // each lane reads back only what it stored
    for (int k = 0; k < kBatch; ++k) {
      const int grp = base + warp + k * kWarps;
      if (grp >= n_groups) break;
      const int r = grp * 32 + lane;
      const bool active = r < g_n;
      total += __popc(any_tiles);
      // the pre-cull: a grasp whose world bounds miss the chunk's box keeps
      // none of its tiles; one without world bounds (-inf, inf) keeps them
      // all for the tile tests
      Grasp g;
      for (int j = 0; j < 3; ++j) {
        g.wlo[j] = s_world[k][warp][j][lane];
        g.whi[j] = s_world[k][warp][3 + j][lane];
      }
      bool meets = active;
      for (int j = 0; j < 3; ++j) meets = meets && !(chi[j] < g.wlo[j] || clo[j] > g.whi[j]);
      if (!__any_sync(0xffffffffu, (active && !finite(g.wlo[0])) || meets)) continue;
      for (int c = 0; c < 20; ++c) g.p[c] = active ? ranked[static_cast<size_t>(c) * g_n + r] : nan();
      g.index = active ? __float_as_int(ranked[static_cast<size_t>(26) * g_n + r]) : 0;
      g.cull = active && ranked[static_cast<size_t>(27) * g_n + r] != 0.0f;
      // the tiles this lane's grasp keeps; the group keeps their union
      unsigned mine = 0;
      for (int t = 0; t < tiles_here; ++t) {
        if (!(any_tiles >> t & 1)) continue;
        const float lo[3] = {s_rec[t][0], s_rec[t][1], s_rec[t][2]};
        const float hi[3] = {s_rec[t][3], s_rec[t][4], s_rec[t][5]};
        const bool fin = s_rec[t][7] != 0.0f;
        mine |= static_cast<unsigned>(active && (!g.cull || (fin && tile_may_hit(g, lo, hi)))) << t;
      }
      kept += __popc(__reduce_or_sync(0xffffffffu, mine));
      // step j: each lane counts the points of its own j-th kept tile
      int c_left = 0, c_right = 0, c_bottom = 0, c_shift = 0, c_overall = 0, c_inner = 0;
      for (int steps = __reduce_max_sync(0xffffffffu, __popc(mine)); steps > 0; --steps) {
        const int t = mine ? __ffs(mine) - 1 : kTiles;
        mine &= mine - 1;
        const float4* tp = s_pts[t];
        Masks m;
#pragma unroll
        for (int i = 0; i < kTile; ++i) test_point(g, tp[i], i, m);
        c_left += __popc(m.left);
        c_right += __popc(m.right);
        c_bottom += __popc(m.bottom);
        c_shift += __popc(m.shift);
        c_overall += __popc(m.left | m.right | m.bottom | m.shift);
        c_inner += __popc(m.inner);
      }
      if (active) {
        float* o = counts + (static_cast<size_t>(b) * g_n + g.index) * 6;
        const int v[6] = {c_left, c_right, c_bottom, c_shift, c_overall, c_inner};
#pragma unroll
        for (int c = 0; c < 6; ++c)
          if (v[c]) atomicAdd(o + c, static_cast<float>(v[c]));
      }
    }
  }
  if (stats != nullptr && lane == 0 && total > 0) {
    atomicAdd(stats, static_cast<unsigned long long>(kept));
    atomicAdd(stats + 1, static_cast<unsigned long long>(total));
  }
}

}  // namespace

// points: (B, N, 3) f32; valid: (B, N) uint8 (0 or 1); params: (B, G, 24)
// f32; counts: (B, G, 6) f32; ranked: (B, 28, G) f32 scratch; tiles:
// (B, ceil(N / 32), 8) f32 scratch; stats: null, or two uint64 that the
// kernel adds (32-grasp group, 32-point tile) pairs to: those it kept and
// those with a valid point. N < 2^24 keeps the float counts exact.
extern "C" int gb_collision(const float* points, const uint8_t* valid, const float* params, float* counts,
                            float* ranked, float* tiles, unsigned long long* stats, int b, int n, int g_n,
                            void* stream) {
  if (b < 1 || n < 1 || g_n < 1 || n >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  const dim3 prep_grid((g_n + 31) / 32 + (n_tiles + kPrepWarps - 1) / kPrepWarps, b);
  collision_prep_kernel<<<prep_grid, kPrepThreads, 0, s>>>(points, valid, params, n, g_n, ranked, tiles, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kChunk - 1) / kChunk, b);
  collision_kernel<<<grid, kWarps * 32, 0, s>>>(points, valid, ranked, tiles, n, g_n, counts, stats);
  return static_cast<int>(cudaGetLastError());
}
