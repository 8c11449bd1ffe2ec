// Fused per-neighbourhood MLP + reduction over K: the group + MLP + max of
// the backbone's set-abstraction and local-aggregation modules in eval mode.
// BatchNorm is folded into the weights by the caller.
//
// Replaces graspbalance_tpu/ops/pallas/mlpmax_kernel.py:mlp_max_fused.
//
// For every point (b, n), with x the K grouped rows of one or two parts
// (B, N, K, C_a) and (B, N, K, C_b), read as their concatenation:
//   h_1 = relu(x @ W_0 + b_0)          W_0 = [W_0a; W_0b], (C_a + C_b, C_1)
//   h_l = relu(h_{l-1} @ W_{l-1} + b_{l-1})
//   out[b, n] = max | mean | sum over the K rows of h_L        (C_L,)
// Layer 0 sums the part a rows of W_0 first, then the part b rows: the
// concatenation exists only as one row of shared memory, never in device
// memory.
//
// What bounds it on the H100: FP32 arithmetic. At the fused eval forward's
// shapes (bs=4: 4 set abstractions and 15 local aggregations, K = 64, 32, 16)
// the layers are ~215 GFLOP against ~1.5 GB of grouped input, and the
// intermediates, written through device memory, would be several GB that the
// reduction then discards K-1 rows of K.
//
// Design: one block of 256 threads per tile of 64 grouped rows (64 / K
// points of one batch row, K in {8, 16, 32, 64}); the tile's input rows and
// every layer's activations stay in shared memory (two ping-pong buffers
// sized from the call's widths, up to ~107 KB: dynamic shared memory past
// the 48 KB default), and the last layer lives only in registers. Each warp
// owns 8 rows and each lane 8 rows x (C_out / 32) columns; a weight row is
// read once per warp through the read-only cache (one coalesced load per 32
// columns) and the activations are shared-memory broadcasts. The reduction
// runs over the thread's 8 rows, then over the K / 8 warps of a point in
// warp order. Plain FP32 FMA on the CUDA cores, each dot product summed in
// input-channel order; tensor cores (wgmma) are for a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // 64 grouped rows per block
constexpr int kMaxLayers = 4;
constexpr int kMaxCj = 8;  // output widths up to 8 x 32 = 256

enum Reduction { kMax = 0, kMean = 1, kSum = 2 };

struct MlpParams {
  const float* w[kMaxLayers];  // (cin[l], cout[l]) row-major
  const float* b[kMaxLayers];  // (cout[l],)
  int cin[kMaxLayers];
  int cout[kMaxLayers];
  int n_layers;
};

// One dense layer over the block's 64 rows: this warp's 8 rows x CJ * 32
// columns. Intermediate layers write relu(.) to `dst`; the last layer writes
// this thread's reduction over its 8 rows to `red` (one row per warp).
template <int CJ>
__device__ __forceinline__ void dense_layer(const float* __restrict__ in, int cin,
                                            const float* __restrict__ w,
                                            const float* __restrict__ bias, float* dst,
                                            float* red, int reduction, int rg, int lane) {
  constexpr int cout = CJ * 32;
  float acc[kRowsPerWarp][CJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = 0.0f;
  const float* x = in + rg * kRowsPerWarp * cin;
#pragma unroll 4
  for (int kk = 0; kk < cin; ++kk) {
    float wv[CJ];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) wv[jj] = __ldg(w + kk * cout + lane + 32 * jj);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float a = x[i * cin + kk];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = fmaf(a, wv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < CJ; ++jj) {
    const int c = lane + 32 * jj;
    const float bv = __ldg(bias + c);
    if (dst != nullptr) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        dst[(rg * kRowsPerWarp + i) * cout + c] = fmaxf(acc[i][jj] + bv, 0.0f);
    } else if (reduction == kMax) {
      float mx = 0.0f;  // relu floor: max_i relu(v_i) == max(0, max_i v_i)
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) mx = fmaxf(mx, acc[i][jj] + bv);
      red[rg * cout + c] = mx;
    } else {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s += fmaxf(acc[i][jj] + bv, 0.0f);
      red[rg * cout + c] = s;
    }
  }
}

__device__ __forceinline__ void run_layer(int cj, const float* in, int cin, const float* w,
                                          const float* bias, float* dst, float* red,
                                          int reduction, int rg, int lane) {
  switch (cj) {
    case 1: dense_layer<1>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 2: dense_layer<2>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 3: dense_layer<3>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 4: dense_layer<4>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 5: dense_layer<5>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 6: dense_layer<6>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    case 7: dense_layer<7>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
    default: dense_layer<8>(in, cin, w, bias, dst, red, reduction, rg, lane); break;
  }
}

// Floats of the two activation buffers: buffer l % 2 holds layer l's input.
__host__ __device__ inline void buffer_floats(const MlpParams& p, int* even, int* odd) {
  *even = 0;
  *odd = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    int* f = (l % 2 == 0) ? even : odd;
    if (p.cin[l] * kTileRows > *f) *f = p.cin[l] * kTileRows;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mlpmax_kernel(const float* __restrict__ pa, const float* __restrict__ pb, int ca, int cb,
                  MlpParams prm, int reduction, int n, int k, float* __restrict__ out) {
  extern __shared__ float smem[];
  int even_f, odd_f;
  buffer_floats(prm, &even_f, &odd_f);
  float* const even = smem;  // layer 0's input, then every even layer's
  float* const odd = smem + even_f;
  float* const red = odd + odd_f;  // kWarps x cout_last

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int rg = t >> 5;
  const int b = blockIdx.y;
  const int pts = kTileRows / k;  // points per tile
  const int p0 = blockIdx.x * pts;
  const int n_pts = min(pts, n - p0);
  const int rows = n_pts * k;
  const int cin0 = ca + cb;

  // stage the tile's rows of both parts, side by side; rows past the last
  // point are zeros (their results are never written)
  const size_t row0 = (static_cast<size_t>(b) * n + p0) * k;
  float* x0 = even;
  for (int e = t; e < kTileRows * ca; e += kThreads) {
    const int r = e / ca, c = e - r * ca;
    x0[r * cin0 + c] = r < rows ? pa[row0 * ca + e] : 0.0f;
  }
  for (int e = t; e < kTileRows * cb; e += kThreads) {
    const int r = e / cb, c = e - r * cb;
    x0[r * cin0 + ca + c] = r < rows ? pb[row0 * cb + e] : 0.0f;
  }
  __syncthreads();

  for (int l = 0; l < prm.n_layers; ++l) {
    const bool last = l == prm.n_layers - 1;
    float* const in = l % 2 == 0 ? even : odd;
    float* const dst = last ? nullptr : (l % 2 == 0 ? odd : even);
    run_layer(prm.cout[l] / 32, in, prm.cin[l], prm.w[l], prm.b[l], dst, red, reduction, rg, lane);
    __syncthreads();  // this layer's output complete; its input no longer read
  }

  // the K / 8 warps of each point, in warp order
  const int cout = prm.cout[prm.n_layers - 1];
  const int wpp = k / kRowsPerWarp;
  for (int e = t; e < n_pts * cout; e += kThreads) {
    const int p = e / cout, c = e - p * cout;
    float v = red[p * wpp * cout + c];
    for (int g = 1; g < wpp; ++g) {
      const float u = red[(p * wpp + g) * cout + c];
      v = reduction == kMax ? fmaxf(v, u) : v + u;
    }
    if (reduction == kMean) v *= 1.0f / static_cast<float>(k);
    out[(static_cast<size_t>(b) * n + p0 + p) * cout + c] = v;
  }
}

}  // namespace

// pa: (B, N, K, ca) f32; pb: (B, N, K, cb) f32 or null when cb == 0;
// w[l]: (widths[l], widths[l + 1]) f32, bias[l]: (widths[l + 1],) f32, for
// l < n_layers, with widths[0] == ca + cb; out: (B, N, widths[n_layers]) f32.
// K in {8, 16, 32, 64}; every output width a multiple of 32 up to 256;
// reduction 0 max, 1 mean, 2 sum. All contiguous.
extern "C" int gb_mlpmax(const float* pa, const float* pb, int ca, int cb, const void* const* w,
                         const void* const* bias, const int* widths, int n_layers, int reduction,
                         float* out, int b, int n, int k, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || ca < 1 || cb < 0 || (cb > 0 && pb == nullptr) ||
      (k != 8 && k != 16 && k != 32 && k != 64) || reduction < kMax || reduction > kSum ||
      b < 1 || b > 65535 || n < 1 || widths[0] != ca + cb)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpParams prm{};
  prm.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    prm.w[l] = static_cast<const float*>(w[l]);
    prm.b[l] = static_cast<const float*>(bias[l]);
    prm.cin[l] = widths[l];
    prm.cout[l] = widths[l + 1];
    if (prm.cout[l] < 32 || prm.cout[l] > kMaxCj * 32 || prm.cout[l] % 32 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int even_f, odd_f;
  buffer_floats(prm, &even_f, &odd_f);
  const size_t smem = sizeof(float) * (static_cast<size_t>(even_f) + odd_f +
                                       static_cast<size_t>(kWarps) * widths[n_layers]);
  cudaError_t err = cudaFuncSetAttribute(mlpmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pts = kTileRows / k;
  const dim3 grid((n + pts - 1) / pts, b);
  mlpmax_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(pa, pb, ca, cb, prm,
                                                                              reduction, n, k, out);
  return static_cast<int>(cudaGetLastError());
}
