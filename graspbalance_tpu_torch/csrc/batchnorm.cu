// Train-mode BatchNorm over the rows of a channels-last (rows, C) f32 tensor,
// with the ReLU after it fused: from the batch statistics that the wrapper
// computes with PyTorch's own reductions (mean, and rstd = 1 / sqrt(var +
// eps), inv = weight * rstd), the forward's apply pass
//   y = relu((x - mean) * inv + bias)            (act = 0: no ReLU),
// and the backward, with g = dy where y > 0 (every dy without the ReLU),
// d = x - mean:
//   dbias = sum(g), dweight = sum(g * d) * rstd,
//   dx = inv * g - inv * sum(g) / n - inv * rstd^2 * sum(g * d) / n.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is plain XLA, which
// fuses the normalisation into its neighbours. Eager PyTorch runs each of
// its ~30 forward and ~50 backward aten ops as a pass over the rows; this
// file does the apply and the backward in three passes.
//
// Why the statistics stay PyTorch's: the training step picks views and
// matches labels by argmax over the forward's outputs, so a forward that
// rounds its batch statistics in another order flips some of those choices
// and moves the first step's loss by ~1e-3 (as TF32 products do). The
// wrapper takes them from the same reductions as the plain code, and the
// apply pass rounds op by op as the plain code does, without contracting
// into FMAs (__f*_rn): the forward is the plain code's bit for bit, and
// the backward recomputes the ReLU's mask from it exactly.
//
// What bounds it on the H100: bytes. The apply pass reads x and writes y;
// the backward's reduction pass reads dy and x, its apply pass reads dy and
// x and writes dx: 7 passes of 4 bytes an element. At the width head's
// largest shape of the training step (2,097,152 rows x 256 channels,
// 2.15 GB a pass) that is 15.0 GB, 4.5 ms at 3.35 TB/s.
//
// Design. Every pass gives each thread one group of VEC channels (VEC = 4,
// 16-byte loads, where C % 4 == 0 and the rows are 16-byte aligned; 1
// otherwise) and a block of kThreads threads tv such groups (the power of
// two at or above C / VEC, at most kThreads) times tr = kThreads / tv rows;
// a grid of (slabs, chunks) blocks, chunks over the channel groups past
// kThreads, slabs of consecutive rows. So a thread loads its channels'
// per-channel values once and walks its slab's rows tr apart, kUnroll rows
// in flight. The reduction pass writes one partial (sum g, sum g * d) per
// slab and channel: each thread adds its rows in row order (kUnroll rows
// pairwise, then into the running sum), the block adds its tr row phases
// in a tree in shared memory. A one-block finalize kernel then adds the
// slabs' partials in a fixed order (lanes over the slabs, then a tree) and
// forms the per-channel values. No float atomics: the number of slabs
// depends only on (rows, C), so two launches on the same inputs give
// bit-equal outputs.
//
// Across ranks (data parallelism), the finalize kernel writes this rank's
// sums (full = 0); the wrapper adds them over the ranks in float64 and
// forms the coefficients of dx; the apply pass is the same.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;       // threads of a reduction or apply block
constexpr int kFinThreads = 1024;   // threads of the one finalize block
constexpr long long kSlabs = 264;   // blocks across the rows: 2 per SM of 132, all resident
constexpr int kUnroll = 4;          // rows in flight a thread

struct Layout {
  int vec;           // channels a thread loads at once (4 or 1)
  int nvec;          // channel groups a row
  int tv;            // channel groups a block
  int tr;            // row phases a block
  int chunks;        // blocks across the channel groups
  long long slabs;   // blocks across the rows
  long long slab;    // rows a slab
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the least power of two at or above v, at most cap
int pow2_at_least(int v, int cap) {
  int p = 1;
  while (p < v && p < cap) p <<= 1;
  return p;
}

Layout layout(long long rows, int c) {
  Layout l;
  l.vec = c % 4 == 0 ? 4 : 1;
  l.nvec = c / l.vec;
  l.tv = pow2_at_least(l.nvec, kThreads);
  l.tr = kThreads / l.tv;
  l.chunks = (l.nvec + l.tv - 1) / l.tv;
  long long per = kSlabs / l.chunks;
  if (per < 1) per = 1;
  const long long need = (rows + static_cast<long long>(l.tr) * kUnroll - 1) / (static_cast<long long>(l.tr) * kUnroll);
  l.slabs = need < per ? need : per;
  if (l.slabs < 1) l.slabs = 1;
  l.slab = (rows + l.slabs - 1) / l.slabs;
  return l;
}

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    f[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    p[0] = f[0];
  }
}

// the norm's output before the ReLU, rounded op by op as the plain code
__device__ __forceinline__ float affine(float x, float mean, float inv, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), inv), b);
}

__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// The backward's reduction pass: per slab and channel (sum g, sum g * d)
// into part (slabs, 2, C).
template <int VEC, bool ACT>
__global__ void __launch_bounds__(kThreads, 2)
partial_kernel(const float* __restrict__ dy, const float* __restrict__ x, const float* __restrict__ stat,
               const float* __restrict__ bias, float* __restrict__ part, long long rows, int c, int nvec, int tv,
               long long slab) {
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  const int tr_n = kThreads / tv;
  const int tr = threadIdx.x / tv;
  const int j = blockIdx.y * tv + threadIdx.x % tv;
  const bool live = j < nvec;
  const int col = j * VEC;
  float s[VEC], q[VEC], mean[VEC], inv[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s[k] = 0.f;
    q[k] = 0.f;
    if (live) {
      mean[k] = stat[col + k];
      inv[k] = stat[2 * c + col + k];
      b[k] = bias[col + k];
    }
  }
  // one element's pair of terms, g and g * d
  auto terms = [&](float gv, float xv, int k, float& ts, float& tq) {
    ts = ACT && affine(xv, mean[k], inv[k], b[k]) <= 0.f ? 0.f : gv;
    tq = ts * __fsub_rn(xv, mean[k]);
  };
  const long long r0 = blockIdx.x * slab;
  const long long r1 = r0 + slab < rows ? r0 + slab : rows;
  if (live) {
    long long r = r0 + tr;
    for (; r + static_cast<long long>(kUnroll - 1) * tr_n < r1; r += static_cast<long long>(kUnroll) * tr_n) {
      float vg[kUnroll][VEC], vx[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + static_cast<long long>(u) * tr_n) * c + col;
        load<VEC>(dy + off, vg[u]);
        load<VEC>(x + off, vx[u]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float ts[kUnroll], tq[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) terms(vg[u][k], vx[u][k], k, ts[u], tq[u]);
        s[k] += (ts[0] + ts[1]) + (ts[2] + ts[3]);
        q[k] += (tq[0] + tq[1]) + (tq[2] + tq[3]);
      }
    }
    for (; r < r1; r += tr_n) {
      float vg[VEC], vx[VEC];
      load<VEC>(dy + r * c + col, vg);
      load<VEC>(x + r * c + col, vx);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float ts, tq;
        terms(vg[k], vx[k], k, ts, tq);
        s[k] += ts;
        q[k] += tq;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh_s[threadIdx.x * VEC + k] = s[k];
    sh_q[threadIdx.x * VEC + k] = q[k];
  }
  __syncthreads();
  for (int stride = tr_n >> 1; stride > 0; stride >>= 1) {
    if (tr < stride) {
      const int o = (threadIdx.x + stride * tv) * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sh_s[threadIdx.x * VEC + k] += sh_s[o + k];
        sh_q[threadIdx.x * VEC + k] += sh_q[o + k];
      }
    }
    __syncthreads();
  }
  if (tr == 0 && live) {
    float* out = part + blockIdx.x * 2LL * c + col;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      out[k] = sh_s[threadIdx.x * VEC + k];
      out[c + k] = sh_q[threadIdx.x * VEC + k];
    }
  }
}

// The slabs' partials of channels [ch0, ch0 + cp) summed in a fixed order:
// lane p of a channel adds slabs p, p + lanes, ...; the lanes then add in a
// tree. Lane 0 (threadIdx.x < cp) gets the channel's sums in (s, q).
__device__ __forceinline__ void sum_partials(const float* __restrict__ part, long long slabs, int c, int ch0,
                                             int cp, float* sh_s, float* sh_q, int& ch, float& s, float& q) {
  const int lanes = kFinThreads / cp;
  const int p = threadIdx.x / cp;
  ch = ch0 + threadIdx.x % cp;
  s = 0.f;
  q = 0.f;
  if (ch < c) {
    for (long long b = p; b < slabs; b += lanes) {
      s += part[b * 2 * c + ch];
      q += part[b * 2 * c + c + ch];
    }
  }
  sh_s[threadIdx.x] = s;
  sh_q[threadIdx.x] = q;
  __syncthreads();
  for (int stride = lanes >> 1; stride > 0; stride >>= 1) {
    if (p < stride) {
      sh_s[threadIdx.x] += sh_s[threadIdx.x + stride * cp];
      sh_q[threadIdx.x] += sh_q[threadIdx.x + stride * cp];
    }
    __syncthreads();
  }
  s = sh_s[threadIdx.x];
  q = sh_q[threadIdx.x];
}

// out (4, C): [dweight | dbias | c0 | cd] with dx = inv * g - c0 - cd * d;
// full = 0, [dweight | dbias | sum g | sum g * d] (this rank's sums)
__global__ void __launch_bounds__(kFinThreads)
finalize_grad_kernel(const float* __restrict__ part, long long slabs, int c, int cp, float n,
                     const float* __restrict__ stat, float* __restrict__ out, int full) {
  __shared__ float sh_s[kFinThreads];
  __shared__ float sh_q[kFinThreads];
  for (int ch0 = 0; ch0 < c; ch0 += cp) {
    int ch;
    float sg, sgd;
    sum_partials(part, slabs, c, ch0, cp, sh_s, sh_q, ch, sg, sgd);
    if (threadIdx.x < cp && ch < c) {
      const float rstd = stat[c + ch];
      const float inv = stat[2 * c + ch];
      out[ch] = sgd * rstd;
      out[c + ch] = sg;
      out[2 * c + ch] = full ? inv * (sg / n) : sg;
      out[3 * c + ch] = full ? inv * rstd * rstd * (sgd / n) : sgd;
    }
    __syncthreads();
  }
}

// The forward's apply pass: y = relu((x - mean) * inv + bias).
template <int VEC, bool ACT>
__global__ void __launch_bounds__(kThreads, 2)
apply_kernel(const float* __restrict__ x, const float* __restrict__ stat, const float* __restrict__ bias,
             float* __restrict__ y, long long rows, int c, int nvec, int tv, long long slab) {
  const int tr_n = kThreads / tv;
  const int tr = threadIdx.x / tv;
  const int j = blockIdx.y * tv + threadIdx.x % tv;
  if (j >= nvec) return;
  const int col = j * VEC;
  float mean[VEC], inv[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mean[k] = stat[col + k];
    inv[k] = stat[2 * c + col + k];
    b[k] = bias[col + k];
  }
  const long long r0 = blockIdx.x * slab;
  const long long r1 = r0 + slab < rows ? r0 + slab : rows;
  long long r = r0 + tr;
  for (; r + static_cast<long long>(kUnroll - 1) * tr_n < r1; r += static_cast<long long>(kUnroll) * tr_n) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<VEC>(x + (r + static_cast<long long>(u) * tr_n) * c + col, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float o = affine(v[u][k], mean[k], inv[k], b[k]);
        v[u][k] = ACT ? relu(o) : o;
      }
      store<VEC>(y + (r + static_cast<long long>(u) * tr_n) * c + col, v[u]);
    }
  }
  for (; r < r1; r += tr_n) {
    float v[VEC];
    load<VEC>(x + r * c + col, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float o = affine(v[k], mean[k], inv[k], b[k]);
      v[k] = ACT ? relu(o) : o;
    }
    store<VEC>(y + r * c + col, v);
  }
}

// The backward's apply pass: dx = inv * g - c0 - cd * (x - mean), uncontracted,
// so that where the terms cancel exactly (one row) dx is exactly 0.
template <int VEC, bool ACT>
__global__ void __launch_bounds__(kThreads, 2)
grad_apply_kernel(const float* __restrict__ dy, const float* __restrict__ x, const float* __restrict__ stat,
                  const float* __restrict__ bias, const float* __restrict__ coef, float* __restrict__ dx,
                  long long rows, int c, int nvec, int tv, long long slab) {
  const int tr_n = kThreads / tv;
  const int tr = threadIdx.x / tv;
  const int j = blockIdx.y * tv + threadIdx.x % tv;
  if (j >= nvec) return;
  const int col = j * VEC;
  float mean[VEC], inv[VEC], b[VEC], c0[VEC], cd[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mean[k] = stat[col + k];
    inv[k] = stat[2 * c + col + k];
    b[k] = bias[col + k];
    c0[k] = coef[col + k];
    cd[k] = coef[c + col + k];
  }
  auto grad = [&](float gv, float xv, int k) {
    const float g = ACT && affine(xv, mean[k], inv[k], b[k]) <= 0.f ? 0.f : gv;
    return __fsub_rn(__fsub_rn(__fmul_rn(inv[k], g), c0[k]), __fmul_rn(cd[k], __fsub_rn(xv, mean[k])));
  };
  const long long r0 = blockIdx.x * slab;
  const long long r1 = r0 + slab < rows ? r0 + slab : rows;
  long long r = r0 + tr;
  for (; r + static_cast<long long>(kUnroll - 1) * tr_n < r1; r += static_cast<long long>(kUnroll) * tr_n) {
    float vg[kUnroll][VEC], vx[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + static_cast<long long>(u) * tr_n) * c + col;
      load<VEC>(dy + off, vg[u]);
      load<VEC>(x + off, vx[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vg[u][k] = grad(vg[u][k], vx[u][k], k);
      store<VEC>(dx + (r + static_cast<long long>(u) * tr_n) * c + col, vg[u]);
    }
  }
  for (; r < r1; r += tr_n) {
    float vg[VEC], vx[VEC];
    load<VEC>(dy + r * c + col, vg);
    load<VEC>(x + r * c + col, vx);
#pragma unroll
    for (int k = 0; k < VEC; ++k) vg[k] = grad(vg[k], vx[k], k);
    store<VEC>(dx + r * c + col, vg);
  }
}

// the checks every entry point makes: sizes, and 16-byte rows on the
// vector route
cudaError_t check_args(long long rows, int c, const void* a, const void* b, const void* out) {
  if (rows < 1 || c < 1) return cudaErrorInvalidValue;
  if (c % 4 == 0 && !(aligned16(a) && aligned16(b) && aligned16(out))) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

// The number of slabs of the reduction pass over (rows, C): the partial
// buffer the wrapper allocates holds slabs x 2 x C floats. -1 if refused.
extern "C" long long gb_bn_partials(long long rows, int c) {
  if (rows < 1 || c < 1) return -1;
  return layout(rows, c).slabs;
}

// Forward apply: x (rows, C), stat (3, C) = [mean | rstd | inv], bias (C);
// y = relu((x - mean) * inv + bias) (act = 0: no ReLU).
extern "C" int gb_bn_apply(const float* x, const float* stat, const float* bias, float* y, long long rows, int c,
                           int act, void* stream) {
  cudaError_t err = check_args(rows, c, x, y, y);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(rows, c);
  const dim3 grid(static_cast<unsigned>(l.slabs), static_cast<unsigned>(l.chunks));
  if (l.vec == 4) {
    if (act) {
      apply_kernel<4, true><<<grid, kThreads, 0, s>>>(x, stat, bias, y, rows, c, l.nvec, l.tv, l.slab);
    } else {
      apply_kernel<4, false><<<grid, kThreads, 0, s>>>(x, stat, bias, y, rows, c, l.nvec, l.tv, l.slab);
    }
  } else if (act) {
    apply_kernel<1, true><<<grid, kThreads, 0, s>>>(x, stat, bias, y, rows, c, l.nvec, l.tv, l.slab);
  } else {
    apply_kernel<1, false><<<grid, kThreads, 0, s>>>(x, stat, bias, y, rows, c, l.nvec, l.tv, l.slab);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward reduction: dy, x (rows, C); stat (3, C) = [mean | rstd | inv];
// part (slabs, 2, C) scratch; out (4, C) (see finalize_grad_kernel).
extern "C" int gb_bn_grad_reduce(const float* dy, const float* x, const float* stat, const float* bias, float* part,
                                 float* out, long long rows, int c, float n, int act, int full, void* stream) {
  cudaError_t err = check_args(rows, c, dy, x, x);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(rows, c);
  const dim3 grid(static_cast<unsigned>(l.slabs), static_cast<unsigned>(l.chunks));
  if (l.vec == 4) {
    if (act) {
      partial_kernel<4, true><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, part, rows, c, l.nvec, l.tv, l.slab);
    } else {
      partial_kernel<4, false><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, part, rows, c, l.nvec, l.tv, l.slab);
    }
  } else if (act) {
    partial_kernel<1, true><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, part, rows, c, l.nvec, l.tv, l.slab);
  } else {
    partial_kernel<1, false><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, part, rows, c, l.nvec, l.tv, l.slab);
  }
  finalize_grad_kernel<<<1, kFinThreads, 0, s>>>(part, l.slabs, c, pow2_at_least(c, kFinThreads), n, stat, out, full);
  return static_cast<int>(cudaGetLastError());
}

// Backward apply: dx = inv * g - c0 - cd * (x - mean), coef (2, C) = [c0 | cd].
extern "C" int gb_bn_grad_apply(const float* dy, const float* x, const float* stat, const float* bias,
                                const float* coef, float* dx, long long rows, int c, int act, void* stream) {
  cudaError_t err = check_args(rows, c, dy, x, dx);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(rows, c);
  const dim3 grid(static_cast<unsigned>(l.slabs), static_cast<unsigned>(l.chunks));
  if (l.vec == 4) {
    if (act) {
      grad_apply_kernel<4, true><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, coef, dx, rows, c, l.nvec, l.tv, l.slab);
    } else {
      grad_apply_kernel<4, false><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, coef, dx, rows, c, l.nvec, l.tv,
                                                            l.slab);
    }
  } else if (act) {
    grad_apply_kernel<1, true><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, coef, dx, rows, c, l.nvec, l.tv, l.slab);
  } else {
    grad_apply_kernel<1, false><<<grid, kThreads, 0, s>>>(dy, x, stat, bias, coef, dx, rows, c, l.nvec, l.tv, l.slab);
  }
  return static_cast<int>(cudaGetLastError());
}
