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
// The concatenation is never built.
//
// What bounds it on the H100: the products. At the fused eval forward's
// shapes (bs=4: 4 set abstractions and 15 local aggregations, K = 64, 32,
// 16) the layers are ~107 G multiply-adds against ~1.5 GB of grouped input;
// written through device memory the intermediates would be several GB that
// the reduction then discards K-1 rows of K.
//
// Design: the products on the tensor cores in 3xTF32, as csrc/widthmlp.cu.
//   - 3xTF32: each operand x is split into hi = rna(x) and lo = rna(x - hi),
//     both TF32, and a product is accumulated in f32 as lo_a hi_b + hi_a lo_b
//     + hi_a hi_b (lo_a lo_b dropped): f32-level error at three tensor-core
//     products per f32 product. mma.sync.m16n8k8 (TF32 in, f32 accumulators).
//     The splits, one per fragment element read, are a large share of the
//     issued instructions: the rounding is two integer operations, not a
//     conversion, and the copies' row / column split a multiply-shift.
//   - A block of 256 threads per tile of 128 grouped rows (128 / K points;
//     the tiles run over the flattened B * N * K rows). The 8 warps are 2
//     along the rows x 4 along the columns: a warp owns 64 rows (whole
//     points, since K <= 64) and a quarter of the layer's columns, so a
//     layer's output lives in its accumulators, up to 64 x 64 per warp.
//   - Every weight matrix is streamed through shared memory in slabs of 32
//     rows, three stages in flight with cp.async (two where a 256-wide
//     intermediate layer leaves no room for a third), one block barrier a
//     slab; each slab is split into hi and lo as its fragments are read.
//     Layer 0 streams the tile's input rows (the part on the tensor cores)
//     beside its weight slabs, straight from device memory, so the input
//     never sits in shared memory whole.
//   - Layer 0's leading part of fewer than 8 channels (the 3-channel offset
//     of every call on the model's path) runs on the CUDA cores in f32 and
//     is added into the accumulators; the rest of layer 0 and every later
//     layer run on the tensor cores.
//   - An intermediate layer's output, relu(acc + b), is written in f32 over
//     its own input in one shared-memory buffer (a barrier first), 128 rows x
//     (C + 4) words, which shares its room with layer 0's input stages, and
//     is split as the next layer reads it. Row strides of C + 4, 32 + 4 and
//     C + 8 words make the fragment loads free of bank conflicts.
//   - The last layer never leaves the registers: the reduction over K runs
//     over a lane's rows of a point, then across the 8 lanes that share a
//     column (shuffles); for max, relu(max_i v_i + b) == max_i relu(v_i + b)
//     (both roundings are monotone).
//   - Two instantiations: layers of at most 128 columns keep 64 accumulators
//     a thread and run two blocks an SM; wider ones 128 and one block.
// The result is deterministic (a fixed order of products and sums).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;      // grouped rows per block
constexpr int kWarpRows = 64;       // 2 warps along the rows ...
constexpr int kColWarps = 4;        // ... x 4 along the columns
constexpr int kSlab = 32;           // weight rows per pipeline stage
constexpr int kMaxStages = 3;
constexpr int kAStride = kSlab + 4; // words per row of an input slab
constexpr int kMaxLayers = 4;
constexpr int kMaxCj = 8;           // output widths up to 8 x 32 = 256
constexpr int kFmaMax = 7;          // a leading part this narrow runs on the CUDA cores
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

enum Reduction { kMax = 0, kMean = 1, kSum = 2 };

struct Params {
  const float* pa;
  const float* pb;
  int ca, cb;
  const float* w[kMaxLayers];  // (cin[l], cout[l]) row-major
  const float* b[kMaxLayers];  // (cout[l],)
  int cin[kMaxLayers];
  int cout[kMaxLayers];
  int slabs[kMaxLayers];  // layer l's weight slabs on the tensor cores
  unsigned quad_magic[kMaxLayers];  // ceil(2^20 / (cout[l] / 4)): e / (cout / 4) == e * magic >> 20 for e < 2^12
  int n_layers;
  int c_fma;         // layer 0's leading channels on the CUDA cores: part a's, or none
  int cin_tc;        // layer 0's channels on the tensor cores: [c_fma, ca + cb)
  const float* tc;   // where those lie, when in one part (tc_vec)
  int tc_stride;
  int tc_vec;        // one part, channels % 4 == 0, 16-byte aligned: 16-byte copies
  int reduction;
  int k;
  int stages;        // slabs in flight: 3, or 2 where 3 do not fit
  long long rows;    // B * N * K
  float* out;
};

// dynamic shared memory, in words: layer 0's input stages or the
// intermediate layer (one region: the input is spent before the first
// intermediate is written), then the weight stages
__host__ __device__ inline void smem_words(const Params& p, int* region, int* b_stage) {
  int cmax = 0, hmax = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    cmax = p.cout[l] > cmax ? p.cout[l] : cmax;
    if (l < p.n_layers - 1 && p.cout[l] > hmax) hmax = p.cout[l];
  }
  *b_stage = kSlab * (cmax + 8);
  const int a = p.cin_tc > 0 ? p.stages * kTileRows * kAStride : 0;
  const int h = p.n_layers > 1 ? kTileRows * (hmax + 4) : 0;
  *region = a > h ? a : h;
}

// cvt.rna.tf32.f32 on a finite value (round to nearest, ties away from
// zero, on the magnitude bits) in two integer operations, which issue
// faster than the conversion
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

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

// 16 (or 4) bytes from src, or zeros when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// this thread's copies of every slab but the newest `pending` landed
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  float* a_st;  // p.stages input slabs, 128 x kAStride
  float* b_st;  // p.stages weight slabs, 32 x (cout + 8)
  float* h;     // the intermediate layer, 128 x (C + 4), where a_st was
  int b_stage;
  long long row0;
  int rows_here;
  int slabs;    // over all layers
  int t, wm, wn, g, q;  // thread, warp row and column, fragment row group and thread
};

// start the copies of slab s of the stream (layer 0's slabs, then layer
// 1's, ...) into stage s % p.stages; one commit group per slab, empty past
// the end
__device__ void issue_slab(const Params& p, const Tile& tl, int s) {
  if (s < tl.slabs) {
    int l = 0, ls = s;
    while (ls >= p.slabs[l]) ls -= p.slabs[l++];
    const int stage = s % p.stages;
    const int cout = p.cout[l];
    const int k0 = ls * kSlab;
    const int kr0 = (l == 0 ? p.c_fma : 0) + k0;  // the weight row of the slab's first row
    float* bdst = tl.b_st + stage * tl.b_stage;
    const int quads = cout / 4;
    for (int e = tl.t; e < kSlab * quads; e += kThreads) {
      const int r = static_cast<int>((static_cast<unsigned>(e) * p.quad_magic[l]) >> 20);  // e / quads
      const int c = (e - r * quads) * 4;
      const bool ok = kr0 + r < p.cin[l];
      cp_async16(bdst + r * (cout + 8) + c, p.w[l] + static_cast<size_t>(ok ? kr0 + r : 0) * cout + c, ok);
    }
    if (l == 0) {  // the tile's input rows, channels [k0, k0 + kSlab) of the tensor-core part
      float* adst = tl.a_st + stage * kTileRows * kAStride;
      if (p.tc_vec) {
        constexpr int kQuads = kSlab / 4;
        for (int e = tl.t; e < kTileRows * kQuads; e += kThreads) {
          const int r = e / kQuads, q4 = (e % kQuads) * 4, j = k0 + q4;
          const bool ok = r < tl.rows_here && j < p.cin_tc;
          const float* src = p.tc + (ok ? static_cast<size_t>(tl.row0 + r) * p.tc_stride + j : 0);
          cp_async16(adst + r * kAStride + q4, src, ok);
        }
      } else {
        for (int e = tl.t; e < kTileRows * kSlab; e += kThreads) {
          const int r = e / kSlab, j = k0 + e % kSlab;
          const int c = p.c_fma + j;
          const bool ok = r < tl.rows_here && j < p.cin_tc;
          const size_t row = static_cast<size_t>(tl.row0 + r);
          const float* src = !ok ? p.pa : c < p.ca ? p.pa + row * p.ca + c : p.pb + row * p.cb + (c - p.ca);
          cp_async4(adst + r * kAStride + e % kSlab, src, ok);
        }
      }
    }
  }
  cp_async_commit();
}

// acc += a b over one slab: the warp's 64 rows of `a` (k columns [0, kSlab) of
// rows `a_stride` words apart) against its NT n-tiles of the slab
template <int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[4][NT][4], const float* a, int a_stride,
                                         const float* bs, int b_stride, const Tile& tl) {
#pragma unroll
  for (int ks = 0; ks < kSlab / 8; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
    const float* bp = bs + (8 * ks + tl.q) * b_stride + tl.wn * 8 * NT + tl.g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(bp[8 * j], bh[j][0], bl[j][0]);
      split(bp[4 * b_stride + 8 * j], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float* ap = a + (tl.wm * kWarpRows + 16 * mi + tl.g) * a_stride + 8 * ks + tl.q;
      uint32_t ah[4], al[4];
      split(ap[0], ah[0], al[0]);
      split(ap[8 * a_stride], ah[1], al[1]);
      split(ap[4], ah[2], al[2]);
      split(ap[8 * a_stride + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc[mi][j], ah, al, bh[j], bl[j]);
    }
  }
}

// the accumulator (mi, j, e) holds row 16 mi + g + 8 (e >> 1) of the warp's
// rows and column 8 j + 2 q + (e & 1) of its columns
__device__ __forceinline__ int acc_row(const Tile& tl, int mi, int e) {
  return tl.wm * kWarpRows + 16 * mi + tl.g + 8 * (e >> 1);
}

template <int NT>
__device__ __forceinline__ int acc_col(const Tile& tl, int j, int e) {
  return tl.wn * 8 * NT + 8 * j + 2 * tl.q + (e & 1);
}

// layer 0's leading c_fma channels (part a) on the CUDA cores, in f32
template <int NT>
__device__ __forceinline__ void add_fma(const Params& p, float (&acc)[4][NT][4], const Tile& tl) {
  const int cout = 32 * NT;
  for (int c = 0; c < p.c_fma; ++c) {
    float w[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) w[j][e] = __ldg(p.w[0] + c * cout + acc_col<NT>(tl, j, e));
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = acc_row(tl, mi, 2 * hf);
        const float x = r < tl.rows_here ? __ldg(p.pa + static_cast<size_t>(tl.row0 + r) * p.ca + c) : 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[mi][j][2 * hf + e] = fmaf(x, w[j][e], acc[mi][j][2 * hf + e]);
      }
  }
}

// relu(acc + b) over this layer's own input in h (every warp is past its reads)
template <int NT>
__device__ __forceinline__ void store_h(const Params& p, int l, float (&acc)[4][NT][4], const Tile& tl) {
  const int stride = 32 * NT + 4;
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = __ldg(p.b[l] + acc_col<NT>(tl, j, e));
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = make_float2(fmaxf(acc[mi][j][2 * hf] + bias[j][0], 0.0f),
                                     fmaxf(acc[mi][j][2 * hf + 1] + bias[j][1], 0.0f));
        *reinterpret_cast<float2*>(tl.h + acc_row(tl, mi, 2 * hf) * stride + acc_col<NT>(tl, j, 0)) = v;
      }
}

// the last layer: bias, ReLU and the reduction over each point's K = 8 HPP
// rows, straight from the accumulators; the warp's 64 rows are 8 / HPP
// whole points
template <int NT, int HPP>
__device__ __forceinline__ void reduce_out(const Params& p, int l, float (&acc)[4][NT][4], const Tile& tl) {
  constexpr int kPoints = 8 / HPP;
  const int cout = 32 * NT;
  const bool is_max = p.reduction == kMax;
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = __ldg(p.b[l] + acc_col<NT>(tl, j, e));
#pragma unroll
  for (int pt = 0; pt < kPoints; ++pt) {
    float v[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float r = 0.0f;
#pragma unroll
        for (int hh = 0; hh < HPP; ++hh) {  // the lane's rows of the point: 8-row halves of m-tiles
          const int ht = pt * HPP + hh;
          const float x = acc[ht >> 1][j][2 * (ht & 1) + e];
          if (is_max)
            r = hh == 0 ? x : fmaxf(r, x);
          else
            r = hh == 0 ? fmaxf(x + bias[j][e], 0.0f) : r + fmaxf(x + bias[j][e], 0.0f);
        }
        // the 8 lanes of a column differ in g = lane / 4
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float o = __shfl_xor_sync(0xffffffffu, r, off);
          r = is_max ? fmaxf(r, o) : r + o;
        }
        if (is_max) r = fmaxf(r + bias[j][e], 0.0f);
        if (p.reduction == kMean) r *= 1.0f / static_cast<float>(8 * HPP);
        v[j][e] = r;
      }
    const int first = tl.wm * kWarpRows + pt * 8 * HPP;  // the point's first row in the tile
    if (tl.g == 0 && first < tl.rows_here) {
      const long long point = (tl.row0 + first) / (8 * HPP);
      float* dst = p.out + static_cast<size_t>(point) * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) *reinterpret_cast<float2*>(dst + acc_col<NT>(tl, j, 0)) = make_float2(v[j][0], v[j][1]);
    }
  }
}

// layer l: its slabs through the pipeline from the stream's slab s, then
// the intermediate store or the reduction; returns the next layer's first
// slab. Its accumulators live only here: one function per width, not
// inlined, so that the widths' register allocations stay apart (inlined
// together they spilled)
template <int NT>
__device__ __noinline__ int run_layer(const Params& p, int l, int s, const Tile tl) {
  float acc[4][NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
  const int b_stride = 32 * NT + 8;
  for (int ls = 0; ls < p.slabs[l]; ++ls, ++s) {
    cp_async_wait(p.stages - 2);
    __syncthreads();  // slab s landed for every thread; the stage slab s - 1 used is free
    issue_slab(p, tl, s + p.stages - 1);
    const float* bs = tl.b_st + (s % p.stages) * tl.b_stage;
    if (l == 0)
      mma_slab<NT>(acc, tl.a_st + (s % p.stages) * kTileRows * kAStride, kAStride, bs, b_stride, tl);
    else
      mma_slab<NT>(acc, tl.h + ls * kSlab, p.cin[l] + 4, bs, b_stride, tl);
  }
  if (l == 0 && p.c_fma > 0) add_fma<NT>(p, acc, tl);
  if (l < p.n_layers - 1) {
    store_h<NT>(p, l, acc, tl);  // made visible by the next slab's barrier
  } else {
    switch (p.k) {
      case 8: reduce_out<NT, 1>(p, l, acc, tl); break;
      case 16: reduce_out<NT, 2>(p, l, acc, tl); break;
      case 32: reduce_out<NT, 4>(p, l, acc, tl); break;
      default: reduce_out<NT, 8>(p, l, acc, tl); break;
    }
  }
  return s;
}

template <int NT, int NTMAX>
__device__ __forceinline__ void run_layer_if(int nt, const Params& p, int l, int& s, const Tile& tl) {
  if constexpr (NT <= NTMAX) {
    if (nt == NT) s = run_layer<NT>(p, l, s, tl);
  }
}

// NTMAX: the widest layer's columns / 32; up to 4 keeps 64 accumulators a
// thread, so that two blocks fit an SM
template <int NTMAX>
__global__ void __launch_bounds__(kThreads, NTMAX <= 4 ? 2 : 1) mlpmax_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  int region;
  Tile tl;
  smem_words(p, &region, &tl.b_stage);
  tl.a_st = smem;
  tl.h = smem;
  tl.b_st = smem + region;
  tl.row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  tl.rows_here = static_cast<int>(min(static_cast<long long>(kTileRows), p.rows - tl.row0));
  tl.slabs = 0;
  for (int l = 0; l < p.n_layers; ++l) tl.slabs += p.slabs[l];
  tl.t = threadIdx.x;
  const int warp = tl.t >> 5, lane = tl.t & 31;
  tl.wm = warp / kColWarps;
  tl.wn = warp % kColWarps;
  tl.g = lane >> 2;
  tl.q = lane & 3;

  for (int q = 0; q < p.stages - 1; ++q) issue_slab(p, tl, q);
  int s = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int nt = p.cout[l] / 32;
    run_layer_if<1, NTMAX>(nt, p, l, s, tl);
    run_layer_if<2, NTMAX>(nt, p, l, s, tl);
    run_layer_if<3, NTMAX>(nt, p, l, s, tl);
    run_layer_if<4, NTMAX>(nt, p, l, s, tl);
    run_layer_if<5, NTMAX>(nt, p, l, s, tl);
    run_layer_if<6, NTMAX>(nt, p, l, s, tl);
    run_layer_if<7, NTMAX>(nt, p, l, s, tl);
    run_layer_if<8, NTMAX>(nt, p, l, s, tl);
  }
}

// once per process and device: both instantiations' shared-memory limit
// raised past 48 KB
cudaError_t device_setup() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(mlpmax_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mlpmax_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

}  // namespace

// pa: (B, N, K, ca) f32; pb: (B, N, K, cb) f32 or null when cb == 0;
// w[l]: (widths[l], widths[l + 1]) f32, bias[l]: (widths[l + 1],) f32, for
// l < n_layers, with widths[0] == ca + cb; out: (B, N, widths[n_layers]) f32.
// K in {8, 16, 32, 64}; every output width a multiple of 32 up to 256;
// reduction 0 max, 1 mean, 2 sum. All contiguous; the weights 16-byte
// aligned.
extern "C" int gb_mlpmax(const float* pa, const float* pb, int ca, int cb, const void* const* w,
                         const void* const* bias, const int* widths, int n_layers, int reduction,
                         float* out, int b, int n, int k, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || ca < 1 || cb < 0 || (cb > 0 && pb == nullptr) ||
      (k != 8 && k != 16 && k != 32 && k != 64) || reduction < kMax || reduction > kSum ||
      b < 1 || n < 1 || widths[0] != ca + cb)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.pa = pa;
  p.pb = pb;
  p.ca = ca;
  p.cb = cb;
  p.n_layers = n_layers;
  p.reduction = reduction;
  p.k = k;
  p.rows = static_cast<long long>(b) * n * k;
  p.out = out;
  p.c_fma = ca <= kFmaMax ? ca : 0;
  p.cin_tc = ca + cb - p.c_fma;
  int ntmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const float*>(w[l]);
    p.b[l] = static_cast<const float*>(bias[l]);
    p.cin[l] = widths[l];
    p.cout[l] = widths[l + 1];
    if (p.cout[l] < 32 || p.cout[l] > kMaxCj * 32 || p.cout[l] % 32 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned(p.w[l], 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    p.slabs[l] = ((l == 0 ? p.cin_tc : p.cin[l]) + kSlab - 1) / kSlab;
    p.quad_magic[l] = ((1u << 20) + p.cout[l] / 4 - 1) / (p.cout[l] / 4);
    if (p.cout[l] / 32 > ntmax) ntmax = p.cout[l] / 32;
  }
  if (!aligned(out, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (p.cin_tc > 0) {
    const bool in_b = p.c_fma == ca;  // else cb == 0 or the tensor-core part spans both parts
    p.tc = in_b ? pb : pa;
    p.tc_stride = in_b ? cb : ca;
    p.tc_vec = (in_b || cb == 0) && p.tc_stride % 4 == 0 && aligned(p.tc, 16);
  }
  const long long tiles = (p.rows + kTileRows - 1) / kTileRows;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  for (p.stages = kMaxStages; p.stages >= 2; --p.stages) {
    int region, b_stage;
    smem_words(p, &region, &b_stage);
    smem = sizeof(float) * (static_cast<size_t>(region) + static_cast<size_t>(p.stages) * b_stage);
    if (smem <= static_cast<size_t>(kMaxSmem)) break;
  }
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = device_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntmax <= 4)
    mlpmax_kernel<4><<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(p);
  else
    mlpmax_kernel<8><<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
