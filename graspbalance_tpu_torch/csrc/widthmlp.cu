// Fused width-grouping MLPs of the grasp head, then a max over the K
// neighbours. Eval only: BatchNorm is folded into the weights by the caller.
// Two entry points share one kernel body:
//
//   gb_widthmlp     replaces graspbalance_tpu/ops/pallas/widthmlp_kernel.py:
//                   width_mlp_fused_rot: raw neighbour coordinates, seed-major
//                   (B, S, R, H, K, 3), with the gripper rotation and the
//                   centre subtraction folded into per-seed layer-0 weights;
//                   out (B, S, H, R * C3), the default eval path.
//   gb_widthmlp_rel replaces widthmlp_kernel.py:width_mlp_fused: neighbour
//                   coordinates already in the gripper frame, scale-major
//                   (B, R, H, S, K, 3) as the cylinder query's emit_rel gives
//                   them, with each scale's shared layer-0 weights; out
//                   (B, H, S, R * C3), the width head's impl='fused_pallas'.
//
// Per (batch b, seed s, scale r, depth h), with x the K coordinates (K, 3):
//   h1 = relu(x @ W0 + b0)                                (K, C1)
//   h2 = relu(h1 @ W1[r] + b1[r])                         (K, C2)
//   h3 = relu(h2 @ W2[r] + b2[r])                         (K, C3)
//   out[..., r * C3 : (r + 1) * C3] = max over K of h3
// where for gb_widthmlp W0 = W0_eff[b, s, :, r] = rot @ W0[r] and b0 =
// b0_eff[b, s, r] = b0[r] - c @ W0_eff are built per seed by the wrapper, so
// ((p - c) @ rot) @ W0 + b0 == p @ W0_eff + b0_eff; for gb_widthmlp_rel W0 =
// W0[r] and b0 = b0[r].
//
// What bounds it on the H100: FP32 arithmetic. At the main path's shapes
// (B=4, S=1024, R=H=4, K=64, widths 64-128-256) the three layers are
// 345 GFLOP, 80% of it in the last layer, against ~50 MB of input and 67 MB
// of output. Written through device memory, the intermediates would be
// ~4 GB for the last layer alone, which the max then discards 63/64 of.
//
// Design: one block of 256 threads per (b, s, r, h), i.e. K = 64 rows. The
// activations h1 (16 KB) and h2 (32 KB) live in shared memory and h3 only in
// registers: each thread owns 8 rows x 8 columns of h3, reduces its 8 rows,
// and eight partial maxima per column meet in shared memory. Weights are
// read through the read-only cache, one coalesced row of W per step shared
// by the warp; a warp's 32 threads share their rows, so the activation reads
// are shared-memory broadcasts. Plain FP32 FMA on the CUDA cores; tensor
// cores (wgmma) are for a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kK = 64;
constexpr int kC1 = 64;
constexpr int kC2 = 128;
constexpr int kC3 = 256;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / 32;    // one warp per 8 rows
constexpr int kRows = kK / kRowGroups;       // rows per thread
static_assert(kRows == 8, "tiling assumes 8 rows per warp");

// kRelLayout false: gb_widthmlp's layouts; true: gb_widthmlp_rel's.
template <bool kRelLayout>
__global__ void __launch_bounds__(kThreads)
    widthmlp_kernel(const float* __restrict__ grouped, const float* __restrict__ w0_eff,
                    const float* __restrict__ b0_eff, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int s_count,
                    int r_count, int h_count) {
  // region A: h1 (K x C1), later the per-warp column maxima (8 x C3)
  // region B: x, W0_eff, b0_eff for layer 0, then h2 (K x C2)
  __shared__ float smem[kK * kC1 + kK * kC2];
  float* h1 = smem;
  float* red = smem;
  float* h2 = smem + kK * kC1;
  float* xs = h2;                 // K x 3
  float* w0s = xs + kK * 3;       // 3 x C1
  float* b0s = w0s + 3 * kC1;     // C1

  // block -> (b, r, s, h), h fastest: neighbouring blocks share a scale's
  // weights in cache
  int blk = blockIdx.x;
  const int h = blk % h_count;
  blk /= h_count;
  const int s = blk % s_count;
  blk /= s_count;
  const int r = blk % r_count;
  const int b = blk / r_count;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int rg = t >> 5;
  const size_t bs = static_cast<size_t>(b) * s_count + s;
  const int rc1 = r_count * kC1;

  // this block's K coordinates and its layer-0 weights (3 x C1) and biases
  const size_t x_off = kRelLayout
                           ? (((static_cast<size_t>(b) * r_count + r) * h_count + h) * s_count + s)
                           : ((bs * r_count + r) * h_count + h);
  const float* xg = grouped + x_off * kK * 3;
  for (int e = t; e < kK * 3; e += kThreads) xs[e] = xg[e];
  for (int e = t; e < 3 * kC1; e += kThreads) {
    const int j = e / kC1, c = e % kC1;
    w0s[e] = kRelLayout ? w0_eff[(static_cast<size_t>(r) * 3 + j) * kC1 + c]
                        : w0_eff[(bs * 3 + j) * rc1 + r * kC1 + c];
  }
  for (int c = t; c < kC1; c += kThreads)
    b0s[c] = kRelLayout ? b0_eff[r * kC1 + c] : b0_eff[bs * rc1 + r * kC1 + c];
  __syncthreads();

  // layer 0: rows rg*8.., columns lane + 32*jj
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = rg * kRows + i;
    const float x0 = xs[row * 3 + 0], x1 = xs[row * 3 + 1], x2 = xs[row * 3 + 2];
#pragma unroll
    for (int jj = 0; jj < kC1 / 32; ++jj) {
      const int c = lane + 32 * jj;
      float v = b0s[c];
      v = fmaf(x0, w0s[c], v);
      v = fmaf(x1, w0s[kC1 + c], v);
      v = fmaf(x2, w0s[2 * kC1 + c], v);
      h1[row * kC1 + c] = fmaxf(v, 0.0f);
    }
  }
  __syncthreads();  // h1 complete; x/W0 (region B) no longer read

  // layer 1: (K x C1) @ (C1 x C2)
  {
    const float* w = w1 + static_cast<size_t>(r) * kC1 * kC2;
    float acc[kRows][kC2 / 32];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kC2 / 32; ++jj) acc[i][jj] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kC1; ++kk) {
      float wv[kC2 / 32];
#pragma unroll
      for (int jj = 0; jj < kC2 / 32; ++jj) wv[jj] = __ldg(w + kk * kC2 + lane + 32 * jj);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = h1[(rg * kRows + i) * kC1 + kk];
#pragma unroll
        for (int jj = 0; jj < kC2 / 32; ++jj) acc[i][jj] = fmaf(a, wv[jj], acc[i][jj]);
      }
    }
    const float* bias = b1 + static_cast<size_t>(r) * kC2;
#pragma unroll
    for (int jj = 0; jj < kC2 / 32; ++jj) {
      const int c = lane + 32 * jj;
      const float bv = __ldg(bias + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i) h2[(rg * kRows + i) * kC2 + c] = fmaxf(acc[i][jj] + bv, 0.0f);
    }
  }
  __syncthreads();  // h2 complete; h1 (region A) no longer read

  // layer 2: (K x C2) @ (C2 x C3), then relu and the max over this thread's rows
  {
    const float* w = w2 + static_cast<size_t>(r) * kC2 * kC3;
    float acc[kRows][kC3 / 32];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kC3 / 32; ++jj) acc[i][jj] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < kC2; ++kk) {
      float wv[kC3 / 32];
#pragma unroll
      for (int jj = 0; jj < kC3 / 32; ++jj) wv[jj] = __ldg(w + kk * kC3 + lane + 32 * jj);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = h2[(rg * kRows + i) * kC2 + kk];
#pragma unroll
        for (int jj = 0; jj < kC3 / 32; ++jj) acc[i][jj] = fmaf(a, wv[jj], acc[i][jj]);
      }
    }
    const float* bias = b2 + static_cast<size_t>(r) * kC3;
#pragma unroll
    for (int jj = 0; jj < kC3 / 32; ++jj) {
      const int c = lane + 32 * jj;
      const float bv = __ldg(bias + c);
      float mx = 0.0f;  // relu floor: max_i relu(v_i) == max(0, max_i v_i)
#pragma unroll
      for (int i = 0; i < kRows; ++i) mx = fmaxf(mx, acc[i][jj] + bv);
      red[rg * kC3 + c] = mx;
    }
  }
  __syncthreads();

  const size_t out_row = kRelLayout ? (static_cast<size_t>(b) * h_count + h) * s_count + s
                                    : bs * h_count + h;
  for (int c = t; c < kC3; c += kThreads) {
    float mx = red[c];
#pragma unroll
    for (int g = 1; g < kRowGroups; ++g) mx = fmaxf(mx, red[g * kC3 + c]);
    out[out_row * (static_cast<size_t>(r_count) * kC3) + r * kC3 + c] = mx;
  }
}

}  // namespace

// grouped: (B, S, R, H, 64, 3); w0_eff: (B, S, 3, R*64); b0_eff: (B, S, R*64);
// w1: (R, 64, 128); b1: (R, 128); w2: (R, 128, 256); b2: (R, 256);
// out: (B, S, H, R*256). All f32, contiguous.
extern "C" int gb_widthmlp(const float* grouped, const float* w0_eff, const float* b0_eff,
                           const float* w1, const float* b1, const float* w2, const float* b2,
                           float* out, int b, int s, int r, int h, void* stream) {
  const long long blocks = static_cast<long long>(b) * s * r * h;
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  widthmlp_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(grouped, w0_eff, b0_eff, w1, b1,
                                                                w2, b2, out, s, r, h);
  return static_cast<int>(cudaGetLastError());
}

// rel: (B, R, H, S, 64, 3); w0: (R, 3, 64); b0: (R, 64); w1: (R, 64, 128);
// b1: (R, 128); w2: (R, 128, 256); b2: (R, 256); out: (B, H, S, R*256). All
// f32, contiguous.
extern "C" int gb_widthmlp_rel(const float* rel, const float* w0, const float* b0,
                               const float* w1, const float* b1, const float* w2, const float* b2,
                               float* out, int b, int s, int r, int h, void* stream) {
  const long long blocks = static_cast<long long>(b) * s * r * h;
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  widthmlp_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(rel, w0, b0, w1, b1, w2, b2, out,
                                                               s, r, h);
  return static_cast<int>(cudaGetLastError());
}
