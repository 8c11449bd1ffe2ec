// Same-shape gather from a table: the table-gather probe.
//
// Replaces tools/probe_mosaic_gather.py:_same_shape_case's kernel (and
// bench_dim0's), the same-shape take_along_axis of a table held in on-chip
// memory:
//   dim 0: out[i, j] = x[idx[i, j], j]
//   dim 1: out[i, j] = x[i, idx[i, j]]
// for x (M, N) f32 and idx (M, N) int32 in range, out (M, N) f32, with
// M * N < 2^31 and, at dim 1, a row within shared memory (N <= 58,112).
//
// What bounds it on the H100: device memory. Each element moves 12 bytes
// (its index in, the table value in once, the output out) and no arithmetic.
//
// Design. dim 0: no staging. The table is read straight from global memory
// through the read-only path; at the probe's sizes (10 MB at M = 19,968,
// N = 128) it stays in the 50 MB L2, so each table row is fetched from
// device memory about once whatever order the indices pick it in. A thread
// takes 4 consecutive columns of a row: one int4 index load and one float4
// store, both with the streaming hint (each is touched once), and four
// table loads, over a grid-stride loop; a scalar loop takes N % 4 != 0 or
// pointers off 16 bytes. dim 1: the row is staged in shared memory, a warp
// per row while N <= 1,024 (8 rows per block, float4 copies where aligned),
// a block per row up to the 227 KB of one block; longer rows are refused.
// The TPU probe asked whether Mosaic lowers such a gather from VMEM at all;
// here dim 0 is an indexed global load served by L2 and dim 1 an indexed
// shared-memory load.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;  // dim 1, short rows: rows per block, a warp each
constexpr int kWarpRowMax = 1024;         // dim 1: longest row a warp stages
constexpr int kSmemMax = 232448;          // shared memory one block may use (227 KB)
constexpr int kBlocksPerSm = 16;          // grid-stride loops: resident blocks per SM
constexpr int kMaxDevices = 64;

// 4 columns per thread
__global__ void __launch_bounds__(kThreads)
    dim0_vec4_kernel(const float* __restrict__ x, const int4* __restrict__ idx, int n, int n4, int total4,
                     float4* __restrict__ out) {
  // unsigned: e + the stride stays below 2^32 for any total4 < 2^31
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < static_cast<unsigned>(total4);
       e += gridDim.x * kThreads) {
    const int4 r = __ldcs(idx + e);
    const size_t j = static_cast<size_t>(e % n4) * 4;
    float4 v;
    v.x = __ldg(x + static_cast<size_t>(r.x) * n + j);
    v.y = __ldg(x + static_cast<size_t>(r.y) * n + j + 1);
    v.z = __ldg(x + static_cast<size_t>(r.z) * n + j + 2);
    v.w = __ldg(x + static_cast<size_t>(r.w) * n + j + 3);
    __stcs(out + e, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    dim0_scalar_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int n, int total,
                       float* __restrict__ out) {
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < static_cast<unsigned>(total);
       e += gridDim.x * kThreads) {
    __stcs(out + e, __ldg(x + static_cast<size_t>(__ldcs(idx + e)) * n + e % n));
  }
}

// dim 1, N <= kWarpRowMax: a warp per row, kRowWarps rows per block
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dim1_warp_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int m, int n,
                     float* __restrict__ out) {
  __shared__ __align__(16) float rows[kRowWarps][kWarpRowMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = rows[warp];
  for (unsigned i = blockIdx.x * kRowWarps + warp; i < static_cast<unsigned>(m); i += gridDim.x * kRowWarps) {
    const size_t off = static_cast<size_t>(i) * n;
    if (kVec) {
      const float4* xr = reinterpret_cast<const float4*>(x + off);
      for (int j = lane; j < n / 4; j += 32) reinterpret_cast<float4*>(row)[j] = __ldcs(xr + j);
      __syncwarp();
      const int4* ir = reinterpret_cast<const int4*>(idx + off);
      float4* orow = reinterpret_cast<float4*>(out + off);
      for (int j = lane; j < n / 4; j += 32) {
        const int4 r = __ldcs(ir + j);
        __stcs(orow + j, make_float4(row[r.x], row[r.y], row[r.z], row[r.w]));
      }
    } else {
      for (int j = lane; j < n; j += 32) row[j] = __ldcs(x + off + j);
      __syncwarp();
      for (int j = lane; j < n; j += 32) __stcs(out + off + j, row[__ldcs(idx + off + j)]);
    }
    __syncwarp();  // the row is read before the next one overwrites it
  }
}

// dim 1, longer rows that fit in shared memory: a block per row
__global__ void __launch_bounds__(kThreads)
    dim1_block_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int n,
                      float* __restrict__ out) {
  extern __shared__ float row_dyn[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) row_dyn[j] = __ldcs(x + off + j);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) __stcs(out + off + j, row_dyn[__ldcs(idx + off + j)]);
}

// the current device's SM count, and the block kernel's shared-memory limit
// raised past 48 KB, each once per process and device
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(dim1_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = count;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

// blocks of `per_block` items for `work` items, at most kBlocksPerSm per SM
unsigned grid_for(int work, int per_block, int sms) {
  const int blocks = work / per_block + (work % per_block != 0);
  const int cap = sms * kBlocksPerSm;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: (m, n) f32; idx: (m, n) int32, in [0, m) for dim 0 and [0, n) for
// dim 1; out: (m, n) f32. m * n < 2^31; at dim 1, n * 4 bytes within
// kSmemMax.
extern "C" int gb_table_gather(const float* x, const int32_t* idx, float* out, int m, int n, int dim,
                               void* stream) {
  if (m < 1 || n < 1 || (dim != 0 && dim != 1) || static_cast<long long>(m) * n > 0x7fffffffLL ||
      (dim == 1 && static_cast<long long>(n) * sizeof(float) > kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = m * n;
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(idx) && aligned16(out);
  if (dim == 0) {
    if (vec) {
      dim0_vec4_kernel<<<grid_for(total / 4, kThreads, sms), kThreads, 0, s>>>(
          x, reinterpret_cast<const int4*>(idx), n, n / 4, total / 4, reinterpret_cast<float4*>(out));
    } else {
      dim0_scalar_kernel<<<grid_for(total, kThreads, sms), kThreads, 0, s>>>(x, idx, n, total, out);
    }
  } else if (n <= kWarpRowMax) {
    const unsigned grid = grid_for(m, kRowWarps, sms);
    if (vec) {
      dim1_warp_kernel<true><<<grid, kThreads, 0, s>>>(x, idx, m, n, out);
    } else {
      dim1_warp_kernel<false><<<grid, kThreads, 0, s>>>(x, idx, m, n, out);
    }
  } else {
    dim1_block_kernel<<<m, kThreads, sizeof(float) * static_cast<size_t>(n), s>>>(x, idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
