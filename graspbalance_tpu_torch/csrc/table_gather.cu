// Same-shape gather from a table held in shared memory: the table-gather
// probe.
//
// Replaces tools/probe_mosaic_gather.py:_same_shape_case's kernel (and
// bench_dim0's), the same-shape take_along_axis of a table held in on-chip
// memory:
//   dim 0: out[i, j] = x[idx[i, j], j]
//   dim 1: out[i, j] = x[i, idx[i, j]]
// for x (M, N) f32 and idx (M, N) int32 in range, out (M, N) f32.
//
// What bounds it on the H100: device memory. Each element moves 12 bytes
// (its index in, the table value in once, the output out) and no arithmetic.
//
// Design. dim 1: one block per row; the row (N floats) is staged in shared
// memory and every thread picks its outputs' values from there. dim 0: one
// block per slab of `cw` consecutive columns and a share of the rows; the
// slab's whole table columns (M x cw floats, up to 227 KB: dynamic shared
// memory past the 48 KB default) are staged, then every thread picks
// x[idx[i, j], j] for its (i, j) with j fastest, so a warp's index loads and
// output stores cover whole runs of a row. The TPU probe asked whether
// Mosaic lowers such a gather from VMEM at all; here it is a plain indexed
// shared-memory load.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_dim1_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int n,
                       float* __restrict__ out) {
  extern __shared__ float row[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) row[j] = x[off + j];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) out[off + j] = row[idx[off + j]];
}

__global__ void __launch_bounds__(kThreads)
    gather_dim0_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int m, int n,
                       int cw, float* __restrict__ out) {
  extern __shared__ float slab[];  // (m, cw), row-major
  const int j0 = blockIdx.x * cw;
  const int w = min(cw, n - j0);
  for (int e = threadIdx.x; e < m * w; e += kThreads) {
    const int i = e / w, jj = e - i * w;
    slab[i * cw + jj] = x[static_cast<size_t>(i) * n + j0 + jj];
  }
  __syncthreads();
  const int rows_per = (m + gridDim.y - 1) / gridDim.y;
  const int i0 = blockIdx.y * rows_per;
  const int i1 = min(m, i0 + rows_per);
  for (int e = threadIdx.x; e < (i1 - i0) * w; e += kThreads) {
    const int i = i0 + e / w, jj = e % w;
    const size_t o = static_cast<size_t>(i) * n + j0 + jj;
    out[o] = slab[idx[o] * cw + jj];
  }
}

}  // namespace

// x: (m, n) f32; idx: (m, n) int32, in [0, m) for dim 0 and [0, n) for
// dim 1; out: (m, n) f32. dim 0 stages cw columns per block (m * cw * 4
// bytes of shared memory) and splits the rows over row_splits blocks.
extern "C" int gb_table_gather(const float* x, const int32_t* idx, float* out, int m, int n,
                               int dim, int cw, int row_splits, void* stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 1) {
    const size_t smem = sizeof(float) * static_cast<size_t>(n);
    cudaError_t err = cudaFuncSetAttribute(gather_dim1_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_dim1_kernel<<<m, kThreads, smem, s>>>(x, idx, n, out);
  } else if (dim == 0) {
    if (cw < 1 || row_splits < 1 || row_splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * static_cast<size_t>(m) * cw;
    cudaError_t err = cudaFuncSetAttribute(gather_dim0_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_dim0_kernel<<<dim3((n + cw - 1) / cw, row_splits), kThreads, smem, s>>>(x, idx, m, n, cw,
                                                                                    out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
