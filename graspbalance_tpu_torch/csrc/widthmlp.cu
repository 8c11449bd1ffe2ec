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
// What bounds it on the H100: arithmetic. At the main path's shapes (B=4,
// S=1024, R=H=4, K=64, widths 64-128-256) layers 1 and 2 are 343.6 GFLOP
// (layer 0 ~1%), against ~50 MB of input and 67 MB of output. Written
// through device memory, the intermediates would be ~4 GB for the last layer
// alone, which the max then discards 63/64 of.
//
// Design: layers 1 and 2 on the tensor cores in 3xTF32, layer 0 on the CUDA
// cores, every activation in shared memory, h3 only in registers.
//   - 3xTF32: each operand x is split into a TF32 high part and a TF32
//     residual, hi = rna(x), lo = rna(x - hi), and a product is accumulated
//     in f32 as lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 of it,
//     is dropped). Its error stays at f32's level (~2e-7 at the head's
//     widths, against ~2.5e-4 for one TF32 pass), inside the 1e-5 the
//     kernel is held to. mma.sync.m16n8k8 (TF32 in, f32 accumulators): a
//     warp-level product of a 16x8 and an 8x8 tile.
//   - Persistent blocks, each fixed to one scale r: a block stages W2[r]
//     (128 KB) in shared memory once and keeps its warp's slice of W1[r] in
//     registers (32 values a lane), then walks the (b, s, h) groups of that
//     scale, 64 rows (K) a group, with a stride of the scale's block count.
//     Grid: the SMs split evenly over the scales, one 256-thread block (225
//     KB of dynamic shared memory) per SM.
//   - Per group: layer 0 from the group's coordinates and layer-0 weights
//     (staged by cp.async during the previous group's layer 1) writes h1 as
//     hi and lo halves (16 KB each); each of the 8 warps computes 16 columns
//     of h2 over all 64 rows from h1 and its W1 registers and writes them
//     back split (32 KB each half); each warp then computes 32 columns of h3
//     over all 64 rows from h2 and W2 (split as it is read) and takes the
//     max over the rows straight from its accumulators: within a lane, then
//     across the 8 lanes that hold a column (shuffles), then bias + ReLU.
//     Two block barriers a group.
//   - Bank-conflict-free fragment loads: activations (row, k) sit at
//     k ^ 4 (row % 8) in their row, W2 (k, n) at n ^ 8 (k % 4).
// The result is deterministic (a fixed order of products and sums).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kK = 64;
constexpr int kC1 = 64;
constexpr int kC2 = 128;
constexpr int kC3 = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kC2 / kWarps == 16 && kC3 / kWarps == 32, "a warp owns 16 columns of h2, 32 of h3");
constexpr int kMaxDevices = 64;

// dynamic shared memory, in 4-byte words
constexpr int kW2Words = kC2 * kC3;  // W2[r], f32
constexpr int kH1Words = kK * kC1;   // each half of h1
constexpr int kH2Words = kK * kC2;   // each half of h2
constexpr int kXWords = kK * 3;
constexpr int kW0Words = 3 * kC1;
constexpr int kSmemBytes = 4 * (kW2Words + 2 * kH1Words + 2 * kH2Words + kXWords + kW0Words + kC1);
static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");
constexpr int kStageChunks = (kXWords + kW0Words + kC1) / 4;  // 16-byte copies per group
static_assert(kStageChunks <= kThreads, "one copy a thread");

// activation (row, k) in a row of `stride` words (a multiple of 32)
__device__ __forceinline__ int act_at(int row, int k, int stride) {
  return row * stride + (k ^ ((row & 7) << 2));
}

// W2 (k, n)
__device__ __forceinline__ int w2_at(int k, int n) { return k * kC3 + (n ^ ((k & 3) << 3)); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo exact: x - hi is representable)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on a 16x8 (a: 16x8 row-major fragment, b: 8x8 column fragment)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma(d, alo, bhi[0], bhi[1]);
  mma(d, ahi, blo[0], blo[1]);
  mma(d, ahi, bhi[0], bhi[1]);
}

// the A fragment of rows m0.. and depth k0.. of a split activation: lane
// (g, t) = (lane / 4, lane % 4) holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)
__device__ __forceinline__ void load_a(const uint32_t* hi, const uint32_t* lo, int stride, int m0, int k0,
                                       int g, int t, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int at[4] = {act_at(m0 + g, k0 + t, stride), act_at(m0 + g + 8, k0 + t, stride),
                     act_at(m0 + g, k0 + t + 4, stride), act_at(m0 + g + 8, k0 + t + 4, stride)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ah[q] = hi[at[q]];
    al[q] = lo[at[q]];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// kRelLayout false: gb_widthmlp's layouts; true: gb_widthmlp_rel's.
template <bool kRelLayout>
__global__ void __launch_bounds__(kThreads, 1)
    widthmlp_kernel(const float* __restrict__ grouped, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int b_count, int s_count,
                    int r_count, int h_count) {
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;
  uint32_t* h1hi = reinterpret_cast<uint32_t*>(smem + kW2Words);
  uint32_t* h1lo = h1hi + kH1Words;
  uint32_t* h2hi = h1lo + kH1Words;
  uint32_t* h2lo = h2hi + kH2Words;
  float* xs = reinterpret_cast<float*>(h2lo + kH2Words);  // K x 3
  float* w0s = xs + kXWords;                              // 3 x C1
  float* b0s = w0s + kW0Words;                            // C1

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int fg = lane >> 2;  // the fragment's row group
  const int ft = lane & 3;   // and its thread in the group
  const int per_scale = gridDim.x / r_count;
  const int r = blockIdx.x / per_scale;
  const int groups = b_count * s_count * h_count;
  const int rc3 = r_count * kC3;

  // W2[r] into shared memory, once
  {
    const float4* src = reinterpret_cast<const float4*>(w2 + static_cast<size_t>(r) * kC2 * kC3);
    for (int e = t; e < kW2Words / 4; e += kThreads) {
      const int k = e / (kC3 / 4), n = (e % (kC3 / 4)) * 4;
      *reinterpret_cast<float4*>(w2s + w2_at(k, n)) = __ldg(src + e);
    }
  }
  // this warp's B fragments of W1[r] (columns 16 warp + 8 j + g, rows
  // 8 ks + t and 8 ks + t + 4), and the biases of its columns
  float w1r[kC1 / 8][2][2];
  {
    const float* src = w1 + static_cast<size_t>(r) * kC1 * kC2 + 16 * warp + fg;
#pragma unroll
    for (int ks = 0; ks < kC1 / 8; ++ks)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) w1r[ks][j][q] = __ldg(src + (8 * ks + ft + 4 * q) * kC2 + 8 * j);
  }
  float bias1[2][2], bias2[4][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias1[j][e] = __ldg(b1 + r * kC2 + 16 * warp + 8 * j + 2 * ft + e);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias2[j][e] = __ldg(b2 + r * kC3 + 32 * warp + 8 * j + 2 * ft + e);

  // group g -> (b, s, h), h fastest; stage(g) copies its coordinates and
  // layer-0 weights into xs, w0s, b0s
  auto stage = [&](int g) {
    const int h = g % h_count;
    const int bs = g / h_count;
    const int s = bs % s_count;
    const int b = bs / s_count;
    if (t >= kStageChunks) return;
    const int word = 4 * t;
    const float* src;
    if (word < kXWords) {
      const size_t x_off = kRelLayout ? ((static_cast<size_t>(b) * r_count + r) * h_count + h) * s_count + s
                                      : (static_cast<size_t>(bs) * r_count + r) * h_count + h;
      src = grouped + x_off * kXWords + word;
    } else if (word < kXWords + kW0Words) {
      const int j = (word - kXWords) / kC1, c = (word - kXWords) % kC1;
      src = kRelLayout ? w0 + (static_cast<size_t>(r) * 3 + j) * kC1 + c
                       : w0 + (static_cast<size_t>(bs) * 3 + j) * r_count * kC1 + r * kC1 + c;
    } else {
      const int c = word - kXWords - kW0Words;
      src = kRelLayout ? b0 + r * kC1 + c : b0 + static_cast<size_t>(bs) * r_count * kC1 + r * kC1 + c;
    }
    cp_async16(xs + word, src);
  };

  int g = blockIdx.x % per_scale;
  if (g < groups) stage(g);
  cp_async_wait_all();
  __syncthreads();  // W2 staged; the first group's inputs landed

  for (; g < groups; g += per_scale) {
    // layer 0 (CUDA cores): thread t does column t % 64 of rows t / 64 + 4 i
    {
      const int c = t & (kC1 - 1);
      const float wa = w0s[c], wb = w0s[kC1 + c], wc = w0s[2 * kC1 + c], bias = b0s[c];
#pragma unroll 4
      for (int row = t / kC1; row < kK; row += kThreads / kC1) {
        float v = bias;
        v = fmaf(xs[row * 3 + 0], wa, v);
        v = fmaf(xs[row * 3 + 1], wb, v);
        v = fmaf(xs[row * 3 + 2], wc, v);
        uint32_t hi, lo;
        split(fmaxf(v, 0.0f), hi, lo);
        const int at = act_at(row, c, kC1);
        h1hi[at] = hi;
        h1lo[at] = lo;
      }
    }
    __syncthreads();  // h1 complete; xs, w0s, b0s free
    if (g + per_scale < groups) stage(g + per_scale);

    // layer 1 (tensor cores): rows 0..63, columns 16 warp .. 16 warp + 15
    {
      float acc[kK / 16][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kC1 / 8; ++ks) {
        uint32_t bhi[2][2], blo[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) split(w1r[ks][j][q], bhi[j][q], blo[j][q]);
#pragma unroll
        for (int mi = 0; mi < kK / 16; ++mi) {
          uint32_t ah[4], al[4];
          load_a(h1hi, h1lo, kC1, 16 * mi, 8 * ks, fg, ft, ah, al);
#pragma unroll
          for (int j = 0; j < 2; ++j) mma3(acc[mi][j], ah, al, bhi[j], blo[j]);
        }
      }
      // bias + ReLU, written to h2 split; the accumulator (mi, j) holds
      // rows 16 mi + g (+ 8) and columns 16 warp + 8 j + 2 t (+ 1)
#pragma unroll
      for (int mi = 0; mi < kK / 16; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = 16 * mi + fg + 8 * (q >> 1);
            const int col = 16 * warp + 8 * j + 2 * ft + (q & 1);
            uint32_t hi, lo;
            split(fmaxf(acc[mi][j][q] + bias1[j][q & 1], 0.0f), hi, lo);
            const int at = act_at(row, col, kC2);
            h2hi[at] = hi;
            h2lo[at] = lo;
          }
    }
    cp_async_wait_all();
    __syncthreads();  // h2 complete; the next group's inputs landed

    // layer 2 (tensor cores): rows 0..63, columns 32 warp .. 32 warp + 31,
    // then the max over the rows, bias and ReLU
    {
      float acc[kK / 16][4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kC2 / 8; ++ks) {
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            split(w2s[w2_at(8 * ks + ft + 4 * q, 32 * warp + 8 * j + fg)], bhi[j][q], blo[j][q]);
#pragma unroll
        for (int mi = 0; mi < kK / 16; ++mi) {
          uint32_t ah[4], al[4];
          load_a(h2hi, h2lo, kC2, 16 * mi, 8 * ks, fg, ft, ah, al);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma3(acc[mi][j], ah, al, bhi[j], blo[j]);
        }
      }
      const int h = g % h_count;
      const int bs = g / h_count;
      const size_t out_row = kRelLayout
                                 ? (static_cast<size_t>(bs / s_count) * h_count + h) * s_count + bs % s_count
                                 : static_cast<size_t>(bs) * h_count + h;
      float* dst = out + out_row * rc3 + r * kC3 + 32 * warp + 2 * ft;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float mx[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[0][j][e];
#pragma unroll
          for (int mi = 0; mi < kK / 16; ++mi) v = fmaxf(v, fmaxf(acc[mi][j][e], acc[mi][j][e + 2]));
          // the 8 lanes of a column differ in g = lane / 4
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          // max_i relu(v_i + b) == relu(max_i v_i + b): both roundings are monotone
          mx[e] = fmaxf(v + bias2[j][e], 0.0f);
        }
        if (fg == 0) *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(mx[0], mx[1]);
      }
    }
  }
}

// once per process and device: the SM count, and both instantiations'
// shared-memory limit raised past 48 KB
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(widthmlp_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(widthmlp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = count;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kRelLayout>
int launch(const float* x, const float* w0, const float* b0, const float* w1, const float* b1,
           const float* w2, const float* b2, float* out, int b, int s, int r, int h, void* stream) {
  const long long groups = static_cast<long long>(b) * s * h;
  if (groups < 1 || groups > 0x7fffffffLL || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  // cp.async and the float4 / float2 accesses need aligned rows
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w0), static_cast<const void*>(b0),
                        static_cast<const void*>(w2), static_cast<const void*>(out)})
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long per_scale = sms / r;
  if (per_scale < 1) per_scale = 1;
  if (per_scale > groups) per_scale = groups;
  widthmlp_kernel<kRelLayout><<<static_cast<unsigned>(per_scale * r), kThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(x, w0, b0, w1, b1, w2, b2, out, b, s,
                                                                     r, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grouped: (B, S, R, H, 64, 3); w0_eff: (B, S, 3, R*64); b0_eff: (B, S, R*64);
// w1: (R, 64, 128); b1: (R, 128); w2: (R, 128, 256); b2: (R, 256);
// out: (B, S, H, R*256). All f32, contiguous, 16-byte aligned.
extern "C" int gb_widthmlp(const float* grouped, const float* w0_eff, const float* b0_eff,
                           const float* w1, const float* b1, const float* w2, const float* b2,
                           float* out, int b, int s, int r, int h, void* stream) {
  return launch<false>(grouped, w0_eff, b0_eff, w1, b1, w2, b2, out, b, s, r, h, stream);
}

// rel: (B, R, H, S, 64, 3); w0: (R, 3, 64); b0: (R, 64); w1: (R, 64, 128);
// b1: (R, 128); w2: (R, 128, 256); b2: (R, 256); out: (B, H, S, R*256). All
// f32, contiguous, 16-byte aligned.
extern "C" int gb_widthmlp_rel(const float* rel, const float* w0, const float* b0,
                               const float* w1, const float* b1, const float* w2, const float* b2,
                               float* out, int b, int s, int r, int h, void* stream) {
  return launch<true>(rel, w0, b0, w1, b1, w2, b2, out, b, s, r, h, stream);
}
