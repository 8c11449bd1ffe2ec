// Scatter-add of cotangent rows onto their source rows: the backward of
// gather_points / group_points.
//   ct (B, R, C) f32, idx (B, R) int32 -> out (B, n, C) f32,
//   out[b, d, c] = sum of ct[b, r, c] over the rows r with idx[b, r] == d,
// added in increasing r. A row whose index lies outside [0, n) is dropped
// (negative = padding).
//
// Replaces graspbalance_tpu/ops/pallas/scatter_kernel.py:scatter_add_matmul
// (the TPU kernel builds one-hot tiles in VMEM and runs the scatter as an
// MXU matmul, onehot(idx)^T @ ct).
//
// What bounds it on the H100: bytes. Each cotangent row is read once and
// each output row written once: at the largest shape of the training step
// (the stage-1 local-aggregation gathers, B=2, R=131,072, n=2048, C=128)
// that is 134 MB of ct + 1 MB of idx + 2 MB of out, 0.04 ms at 3.35 TB/s.
// The one-hot matmul of the TPU would spend 2*R*n*C operations on it; here
// no multiplication happens at all.
//
// Design: deterministic without float atomics, as a stable counting sort of
// the rows by destination followed by ordered segment sums.
//   1. count: rows per destination (integer atomicAdd, exact in any order);
//   2. scan: each batch row's exclusive prefix of the counts = the start of
//      each destination's segment;
//   3. fill: a block owns a tile of kFillTile destinations and streams its
//      batch row's idx in rounds of kChunk entries, read coalesced, in
//      groups of 32 consecutive rows (one warp's load); __match_any_sync
//      counts each group's hits per destination, one prefix sum per
//      destination over the groups in row order gives each group's first
//      slot in the destination's segment, and each hit takes that slot plus
//      the number of equal lanes before it: the segment holds its rows in
//      increasing order;
//   4. sum: a warp per (destination, 32 channels) adds its segment's ct rows
//      in segment order, kUnroll loads in flight, and writes the output.
// So every destination sums its rows in increasing row order, and two
// launches give bit-equal results. The hottest destination bounds step 4
// (query padding repeats a neighbourhood's first hit, so a few sources take
// hundreds of rows): its chain is one warp's, not a whole tile's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kFillThreads = 128;
constexpr int kFillWarps = kFillThreads / 32;
constexpr int kFillTile = 32;                       // destinations per fill block (one warp's lanes)
constexpr int kPerThread = 32;                      // idx entries per thread and round
constexpr int kChunk = kFillThreads * kPerThread;   // idx entries per round
constexpr int kSumWarps = 8;                        // (destination, 32 channels) per sum block
constexpr int kUnroll = 16;                         // ct loads in flight per lane

__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const int32_t* __restrict__ idx, int r_n, int n, int* __restrict__ counts) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * kCountThreads + threadIdx.x;
  if (r >= r_n) return;
  const int d = idx[static_cast<size_t>(b) * r_n + r];
  if (d >= 0 && d < n) atomicAdd(&counts[static_cast<size_t>(b) * n + d], 1);
}

// offsets[b, d] = sum of counts[b, :d] for d in [0, n]
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ counts, int n, int* __restrict__ offsets) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int* cb = counts + static_cast<size_t>(blockIdx.x) * n;
  int* ob = offsets + static_cast<size_t>(blockIdx.x) * (n + 1);
  if (t == 0) s_carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int v = base + t < n ? cb[base + t] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = s_carry;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (base + t < n) ob[base + t] = before + incl - v;
    __syncthreads();  // everyone has read s_carry and s_warp
    if (t == kScanThreads - 1) s_carry = before + incl;
    __syncthreads();
  }
  if (t == 0) ob[n] = s_carry;
}

__global__ void __launch_bounds__(kFillThreads)
    fill_kernel(const int32_t* __restrict__ idx, const int* __restrict__ offsets, int r_n, int n,
                int* __restrict__ rows) {
  constexpr int kGroups = kPerThread * kFillWarps;  // 32-row groups per round, in row order
  __shared__ int s_gd[kGroups * kFillTile];         // hits per (group, destination), then positions
  __shared__ int s_cur[kFillTile];                  // next free slot of each destination's segment

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lower = (1u << lane) - 1u;  // lanes before this one
  const int d0 = blockIdx.x * kFillTile;
  const int b = blockIdx.y;
  const int d_end = min(d0 + kFillTile, n);
  const int32_t* irow = idx + static_cast<size_t>(b) * r_n;
  int* rb = rows + static_cast<size_t>(b) * r_n;
  if (t < kFillTile) s_cur[t] = t < d_end - d0 ? offsets[static_cast<size_t>(b) * (n + 1) + d0 + t] : 0;

  for (int base = 0; base < r_n; base += kChunk) {
    // entry j of the round is row base + j * kFillThreads + t, in group
    // j * kFillWarps + warp: which hit the tile
    int hit[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = base + j * kFillThreads + t;
      const int d = r < r_n ? irow[r] : -1;
      hit[j] = (d >= d0 && d < d_end) ? d - d0 : -1;
    }
    for (int i = t; i < kGroups * kFillTile; i += kFillThreads) s_gd[i] = 0;
    __syncthreads();
    // hits per (group, destination): one lane of each set of equal keys
    // writes its set's size (a miss gets a key of its own)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned m = __match_any_sync(0xffffffffu, hit[j] >= 0 ? hit[j] : -1 - lane);
      if (hit[j] >= 0 && (m & lower) == 0) s_gd[(j * kFillWarps + warp) * kFillTile + hit[j]] = __popc(m);
    }
    __syncthreads();
    // per destination, over the groups in row order: the first slot of each
    // group's hits in the destination's segment
    if (t < kFillTile) {
      int run = s_cur[t];
      for (int g = 0; g < kGroups; ++g) {
        const int x = s_gd[g * kFillTile + t];
        s_gd[g * kFillTile + t] = run;
        run += x;
      }
      s_cur[t] = run;
    }
    __syncthreads();
    // each hit's slot: its group's first slot + the equal lanes before it
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned m = __match_any_sync(0xffffffffu, hit[j] >= 0 ? hit[j] : -1 - lane);
      if (hit[j] >= 0)
        rb[s_gd[(j * kFillWarps + warp) * kFillTile + hit[j]] + __popc(m & lower)] = base + j * kFillThreads + t;
    }
    __syncthreads();  // the slots are read before the next round clears them
  }
}

__global__ void __launch_bounds__(kSumWarps * 32)
    sum_kernel(const float* __restrict__ ct, const int* __restrict__ offsets,
               const int* __restrict__ rows, int r_n, int n, int c_n, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int chunks = (c_n + 31) / 32;
  const int task = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int d = task / chunks;
  if (d >= n) return;  // warp-uniform
  const int c = (task - d * chunks) * 32 + lane;
  const int beg = offsets[static_cast<size_t>(b) * (n + 1) + d];
  const int end = offsets[static_cast<size_t>(b) * (n + 1) + d + 1];
  const int* rb = rows + static_cast<size_t>(b) * r_n;
  const float* cb = ct + static_cast<size_t>(b) * r_n * c_n + c;
  const bool has_c = c < c_n;

  float acc = 0.0f;
  for (int i = beg; i < end; i += 32) {
    const int my_row = i + lane < end ? rb[i + lane] : 0;
    const int m = min(32, end - i);
    for (int j = 0; j < m; j += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = __shfl_sync(0xffffffffu, my_row, (j + u) & 31);
        v[u] = (j + u < m && has_c) ? cb[static_cast<size_t>(row) * c_n] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < m) acc += v[u];
    }
  }
  if (has_c) out[(static_cast<size_t>(b) * n + d) * c_n + c] = acc;
}

}  // namespace

// ct: (B, R, C) f32; idx: (B, R) int32; out: (B, n, C) f32, fully written.
// Scratch: counts (B, n) int32, offsets (B, n + 1) int32, rows (B, R)
// int32. B, n, C >= 1; R >= 0.
extern "C" int gb_scatter_add(const float* ct, const int32_t* idx, float* out, int* counts,
                              int* offsets, int* rows, int b, int r_n, int n, int c_n,
                              void* stream) {
  if (b < 1 || n < 1 || c_n < 1 || r_n < 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tasks = static_cast<long long>(n) * ((c_n + 31) / 32);
  if ((tasks + kSumWarps - 1) / kSumWarps > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(b) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r_n > 0) {
    count_kernel<<<dim3((r_n + kCountThreads - 1) / kCountThreads, b), kCountThreads, 0, s>>>(idx, r_n, n,
                                                                                             counts);
  }
  scan_kernel<<<b, kScanThreads, 0, s>>>(counts, n, offsets);
  if (r_n > 0) {
    fill_kernel<<<dim3((n + kFillTile - 1) / kFillTile, b), kFillThreads, 0, s>>>(idx, offsets, r_n, n,
                                                                                  rows);
  }
  sum_kernel<<<dim3(static_cast<unsigned>((tasks + kSumWarps - 1) / kSumWarps), b), kSumWarps * 32, 0, s>>>(
      ct, offsets, rows, r_n, n, c_n, out);
  return static_cast<int>(cudaGetLastError());
}
