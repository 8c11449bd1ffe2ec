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
// the rows by destination over tiles of `tile_rows` rows of a batch row,
// then ordered segment sums. Tiles hold about kTileRows rows, fewer only
// where a batch row's (tiles, n) counts would pass kMaxCounts. Four
// launches:
//   1. hist: a block per (tile, batch row, range of kDestChunk
//      destinations) counts its tile's rows per destination with
//      shared-memory integer atomics (exact in any order; a warp's equal
//      destinations add once, through __match_any_sync) and writes the
//      counts to start (B, tiles, n); the first tile's blocks also clear
//      the destinations' chunk counters;
//   2. scan: a block per 32 destinations turns each one's counts into
//      their exclusive prefix over the tiles, in place, and writes its
//      total; the last block of the batch row to finish (an integer atomic
//      count) scans the totals into offsets (B, n + 1), each segment's
//      start, and the segments' chunk counts, max(1, ceil(rows /
//      kSegRows)), into tasks (B, n + 1), each destination's first sum
//      task, in one pass over (total, chunk count) pairs, and maps each
//      task to its destination;
//   3. rank: a block per (tile, batch row, destination range), its warps
//      on consecutive parts of the tile: each warp counts its part per
//      destination (shared-memory integer atomics), the block turns the
//      counts into each part's first slots, and each warp walks its part in
//      32-row groups in row order, holding each destination's next slot in
//      shared memory: __match_any_sync finds a group's equal destinations,
//      the lowest lane of each takes their slots (a shared-memory atomic),
//      and each row lands in rows[slot] (the segments hold their rows in
//      increasing order). Each index is read from device memory once in
//      hist and read again twice, mostly from L2, in rank;
//   4. sum: a warp per task, a chunk of at most kSegRows rows of one
//      segment, adds its rows' ct in segment order, 128 channels at a time
//      (a float4 per lane, kUnroll rows in flight; 4 scalars per lane where
//      C % 4 != 0), and writes the output row, or for a segment of several
//      chunks its partial; the chunk that finishes last (an integer atomic
//      counter) adds the partials in chunk order into the output row.
// So every destination sums its rows in increasing row order within chunks
// and its chunks in order, and two launches give bit-equal results. Long
// segments (query padding repeats a neighbourhood's first hit) are split
// over warps instead of being one warp's chain, and the error stays within
// the bound of recursive summation: (chunk rows - 1) + (chunks - 1) <=
// rows - 1 roundings per term.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTileRows = 1024;         // rows of a batch row per sort tile (hist and rank)
constexpr int kMaxCounts = 1 << 24;     // most (tile, destination) counts per batch row (64 MB)
constexpr int kSegRows = 64;            // rows per sum task: longer segments are split across warps
constexpr int kHistThreads = 512;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;  // destinations per scan block
constexpr int kScanItems = 16;     // consecutive entries per scan thread and round
constexpr int kScanRound = kScanThreads * kScanItems;
constexpr int kScanBatch = 16;     // tiles a scan thread holds in registers
constexpr int kRankWarps = 8;      // most warps per rank block (fewer where n is large)
constexpr int kRankThreads = kRankWarps * 32;
constexpr int kRankBatch = 8;      // 32-row groups a rank warp holds in registers
constexpr int kSumWarps = 8;       // tasks per sum block
constexpr int kSumBlocksPerSm = 4;  // 32 warps per SM: at most 64 registers a thread
constexpr int kUnroll = 8;         // ct rows in flight per sum warp
constexpr int kLaneChannels = 4;   // channels per lane and pass
constexpr int kPassChannels = 32 * kLaneChannels;
constexpr int kDestChunk = 32768;  // destinations per hist / rank block (128 KB of counts)
constexpr int kSmemMax = 232448;   // shared memory one block may use (227 KB)
constexpr int kMaxDevices = 64;
constexpr size_t kAlign = 256;

struct Layout {
  int tile_rows, tiles, max_tasks;
  size_t partial, start, offsets, tasks, task_dest, counter, done, rows, bytes;
};

size_t round_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// The sort tiles, and the scratch: partial sums first (16-byte aligned for
// float4), then the int32 arrays of the sort.
Layout layout(int b, int r_n, int n, int c_n) {
  Layout l;
  const int tiles = std::max(1, std::min((r_n + kTileRows - 1) / kTileRows, kMaxCounts / n));
  l.tile_rows = std::max(1, (r_n + tiles - 1) / tiles);
  l.tiles = r_n > 0 ? (r_n + l.tile_rows - 1) / l.tile_rows : 1;
  l.max_tasks = n + r_n / kSegRows;  // sum over d of max(1, ceil(rows_d / kSegRows))
  const size_t sb = static_cast<size_t>(b);
  l.partial = 0;
  l.start = round_up(sizeof(float) * sb * l.max_tasks * c_n);
  l.offsets = l.start + round_up(sizeof(int) * sb * n * l.tiles);
  l.tasks = l.offsets + round_up(sizeof(int) * sb * (n + 1));
  l.task_dest = l.tasks + round_up(sizeof(int) * sb * (n + 1));
  l.counter = l.task_dest + round_up(sizeof(int) * sb * l.max_tasks);
  l.done = l.counter + round_up(sizeof(int) * sb * n);
  l.rows = l.done + round_up(sizeof(int) * sb);
  l.bytes = l.rows + round_up(sizeof(int) * sb * (r_n > 0 ? r_n : 1));
  return l;
}

__global__ void __launch_bounds__(kHistThreads)
    hist_kernel(const int32_t* __restrict__ idx, int r_n, int n, int tile_rows, int tiles,
                int* __restrict__ start, int* __restrict__ counter, int* __restrict__ done) {
  extern __shared__ int s_hist[];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int dlo = blockIdx.z * kDestChunk;
  const int dn = min(kDestChunk, n - dlo);
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < dn; i += kHistThreads) s_hist[i] = 0;
  __syncthreads();
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, r_n);
  const int32_t* irow = idx + static_cast<size_t>(b) * r_n;
  for (int base = r0; base < r1; base += kHistThreads) {
    const int r = base + threadIdx.x;
    const int d = r < r1 ? irow[r] : -1;
    const bool in = d >= dlo && d < dlo + dn;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? d : -1 - lane);
    if (in && (peers & lower) == 0) atomicAdd(&s_hist[d - dlo], __popc(peers));
  }
  __syncthreads();
  int* hb = start + (static_cast<size_t>(b) * tiles + t) * n + dlo;
  for (int i = threadIdx.x; i < dn; i += kHistThreads) {
    hb[i] = s_hist[i];
    if (t == 0) counter[static_cast<size_t>(b) * n + dlo + i] = 0;
  }
  if (t == 0 && blockIdx.z == 0 && threadIdx.x == 0) done[b] = 0;
}

// pad a staged scan index so that a thread's kScanItems consecutive
// entries fall in distinct banks across the warp
__device__ __forceinline__ int padded(int i) { return i + i / 32; }

// Exclusive prefix sum of load(0..len-1), handed to store(i, prefix,
// value), in rounds of kScanRound entries staged in shared memory (loads
// and stores coalesced, each thread scanning kScanItems consecutive
// entries); every thread returns the total.
template <typename T, class Load, class Store>
__device__ T block_exclusive_scan(int len, Load load, Store store, T* s_buf, T* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T carry = 0;
  for (int base = 0; base < len; base += kScanRound) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = k * kScanThreads + threadIdx.x;
      s_buf[padded(i)] = base + i < len ? load(base + i) : T(0);
    }
    __syncthreads();
    T v[kScanItems];
    T sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = s_buf[padded(threadIdx.x * kScanItems + k)];
      sum += v[k];
    }
    T incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      T w = lane < kScanWarps ? s_warp[lane] : T(0);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      if (lane < kScanWarps) s_warp[lane] = w;
    }
    __syncthreads();
    T before = carry + (warp > 0 ? s_warp[warp - 1] : T(0)) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      s_buf[padded(threadIdx.x * kScanItems + k)] = before;
      before += v[k];
    }
    carry += s_warp[kScanWarps - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = k * kScanThreads + threadIdx.x;
      if (base + i < len) {
        const T prefix = s_buf[padded(i)];
        store(base + i, prefix, (i + 1 < kScanRound ? s_buf[padded(i + 1)] : carry) - prefix);
      }
    }
    __syncthreads();  // s_buf and s_warp are read before the next round writes them
  }
  return carry;
}

__device__ __forceinline__ int chunks_of(int rows) { return rows > kSegRows ? (rows + kSegRows - 1) / kSegRows : 1; }

// A block per 32 destinations (a lane each; the warps split the tiles):
// each destination's counts become their exclusive prefix over the tiles,
// in place, and its total goes to offsets. The batch row's last block to
// finish then scans (total, chunk count) pairs in one pass: the totals into
// offsets (each segment's start), the segments' chunk counts, max(1,
// ceil(rows / kSegRows)), into tasks (each destination's first sum task),
// and it maps each task to its destination.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int n, int tiles, int max_tasks, int* __restrict__ start, int* __restrict__ offsets,
                int* __restrict__ tasks, int* __restrict__ task_dest, int* __restrict__ done) {
  using u64 = unsigned long long;
  __shared__ u64 s_buf[kScanRound + kScanRound / 32];
  __shared__ u64 s_warp[kScanWarps];
  __shared__ int s_part[kScanWarps][32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int d = blockIdx.x * 32 + lane;
  int* sb = start + static_cast<size_t>(b) * tiles * n + d;
  int* ob = offsets + static_cast<size_t>(b) * (n + 1);
  const int per_warp = (tiles + kScanWarps - 1) / kScanWarps;
  const int t0 = warp * per_warp;
  const int t1 = min(tiles, t0 + per_warp);
  // the first kScanBatch counts stay in registers; more tiles than
  // kScanWarps * kScanBatch are read again
  int v[kScanBatch];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanBatch; ++k) {
    v[k] = d < n && t0 + k < t1 ? sb[static_cast<size_t>(t0 + k) * n] : 0;
    sum += v[k];
  }
  for (int t = t0 + kScanBatch; d < n && t < t1; ++t) sum += sb[static_cast<size_t>(t) * n];
  s_part[warp][lane] = sum;
  __syncthreads();
  if (d < n) {
    int carry = 0;
    for (int w = 0; w < warp; ++w) carry += s_part[w][lane];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      if (t0 + k < t1) sb[static_cast<size_t>(t0 + k) * n] = carry;
      carry += v[k];
    }
    for (int t = t0 + kScanBatch; t < t1; ++t) {
      const int c = sb[static_cast<size_t>(t) * n];
      sb[static_cast<size_t>(t) * n] = carry;
      carry += c;
    }
    if (warp == kScanWarps - 1) ob[d] = carry;  // the destination's total
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the block's totals are out before the count
    s_last = atomicAdd(&done[b], 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int* tb = tasks + static_cast<size_t>(b) * (n + 1);
  int* td = task_dest + static_cast<size_t>(b) * max_tasks;
  const u64 total = block_exclusive_scan<u64>(
      n,
      [&](int i) {
        const int rows = __ldcg(ob + i);
        return (static_cast<u64>(rows) << 32) | static_cast<u64>(chunks_of(rows));
      },
      [&](int i, u64 prefix, u64 value) {
        const int first = static_cast<int>(prefix & 0xffffffffu);
        ob[i] = static_cast<int>(prefix >> 32);
        tb[i] = first;
        for (int q = 0; q < static_cast<int>(value & 0xffffffffu); ++q) td[first + q] = i;
      },
      s_buf, s_warp);
  if (threadIdx.x == 0) {
    ob[n] = static_cast<int>(total >> 32);
    tb[n] = static_cast<int>(total & 0xffffffffu);
  }
}

__device__ __forceinline__ void load_groups(const int32_t* __restrict__ irow, int base, int r1, int lane,
                                            int (&d)[kRankBatch]) {
#pragma unroll
  for (int k = 0; k < kRankBatch; ++k) {
    const int r = base + k * 32 + lane;
    d[k] = r < r1 ? irow[r] : -1;
  }
}

// A block of `warps` warps per (tile, batch row, destination range); warp w
// takes the w-th 32-row-aligned part of the tile. Each warp counts its
// part per destination, the block turns the counts into each part's first
// slots (the tile's first slot, then the parts in order), and each warp
// ranks its part in row order.
__global__ void __launch_bounds__(kRankThreads)
    rank_kernel(const int32_t* __restrict__ idx, const int* __restrict__ start, const int* __restrict__ offsets,
                int r_n, int n, int tile_rows, int tiles, int* __restrict__ rows) {
  extern __shared__ int s_cur[];  // (warps, destinations): counts, then each part's next free slot
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int dlo = blockIdx.z * kDestChunk;
  const int dn = min(kDestChunk, n - dlo);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < warps * dn; i += blockDim.x) s_cur[i] = 0;
  __syncthreads();
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, r_n);
  const int part = (r1 - r0 + 32 * warps - 1) / (32 * warps) * 32;
  const int p0 = min(r1, r0 + warp * part);
  const int p1 = min(r1, p0 + part);
  const int32_t* irow = idx + static_cast<size_t>(b) * r_n;
  int* cur = s_cur + warp * dn;
  int next[kRankBatch];

  load_groups(irow, p0, p1, lane, next);
  for (int base = p0; base < p1; base += 32 * kRankBatch) {
    int d[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) d[k] = next[k];
    load_groups(irow, base + 32 * kRankBatch, p1, lane, next);
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      const bool in = d[k] >= dlo && d[k] < dlo + dn;
      const unsigned peers = __match_any_sync(0xffffffffu, in ? d[k] : -1 - lane);
      if (in && (peers & lower) == 0) atomicAdd(&cur[d[k] - dlo], __popc(peers));
    }
  }
  __syncthreads();
  const int* sb = start + (static_cast<size_t>(b) * tiles + t) * n + dlo;
  const int* ob = offsets + static_cast<size_t>(b) * (n + 1) + dlo;
  for (int i = threadIdx.x; i < dn; i += blockDim.x) {
    int slot = ob[i] + sb[i];
    for (int w = 0; w < warps; ++w) {
      const int c = s_cur[w * dn + i];
      s_cur[w * dn + i] = slot;
      slot += c;
    }
  }
  __syncthreads();

  int* rb = rows + static_cast<size_t>(b) * r_n;
  load_groups(irow, p0, p1, lane, next);
  for (int base = p0; base < p1; base += 32 * kRankBatch) {
    int d[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) d[k] = next[k];
    load_groups(irow, base + 32 * kRankBatch, p1, lane, next);  // in flight while this batch is ranked
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      const bool in = d[k] >= dlo && d[k] < dlo + dn;
      const unsigned peers = __match_any_sync(0xffffffffu, in ? d[k] : -1 - lane);
      const int leader = __ffs(peers) - 1;
      // the leader's atomic has returned before any lane passes the
      // shuffle, so the next group's leaders see these slots taken
      int first = 0;
      if (in && lane == leader) first = atomicAdd(&cur[d[k] - dlo], __popc(peers));
      first = __shfl_sync(0xffffffffu, first, leader);
      if (in) rb[first + __popc(peers & lower)] = base + k * 32 + lane;
    }
  }
}

// kLaneChannels channels of one row for this lane, in pass c0: 4
// consecutive ones (one float4) where C % 4 == 0, else lane + 32 q
template <bool kVec>
__device__ __forceinline__ float4 load_lane(const float* __restrict__ row, int c0, int lane, int c_n) {
  if (kVec) {
    const int c = c0 + kLaneChannels * lane;
    return c < c_n ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int c = c0 + lane;
  return make_float4(c < c_n ? __ldg(row + c) : 0.f, c + 32 < c_n ? __ldg(row + c + 32) : 0.f,
                     c + 64 < c_n ? __ldg(row + c + 64) : 0.f, c + 96 < c_n ? __ldg(row + c + 96) : 0.f);
}

// the same for partials written by other warps in this launch (not
// through the read-only cache)
template <bool kVec>
__device__ __forceinline__ float4 load_partial(const float* row, int c0, int lane, int c_n) {
  if (kVec) {
    const int c = c0 + kLaneChannels * lane;
    return c < c_n ? __ldcg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int c = c0 + lane;
  return make_float4(c < c_n ? __ldcg(row + c) : 0.f, c + 32 < c_n ? __ldcg(row + c + 32) : 0.f,
                     c + 64 < c_n ? __ldcg(row + c + 64) : 0.f, c + 96 < c_n ? __ldcg(row + c + 96) : 0.f);
}

template <bool kVec>
__device__ __forceinline__ void store_lane(float* row, int c0, int lane, int c_n, float4 v) {
  if (kVec) {
    const int c = c0 + kLaneChannels * lane;
    if (c < c_n) *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  const int c = c0 + lane;
  if (c < c_n) row[c] = v.x;
  if (c + 32 < c_n) row[c + 32] = v.y;
  if (c + 64 < c_n) row[c + 64] = v.z;
  if (c + 96 < c_n) row[c + 96] = v.w;
}

__device__ __forceinline__ void add4(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kSumWarps * 32, kSumBlocksPerSm)
    sum_kernel(const float* __restrict__ ct, const int* __restrict__ offsets, const int* __restrict__ tasks,
               const int* __restrict__ task_dest, const int* __restrict__ rows, int r_n, int n, int c_n,
               int max_tasks, float* __restrict__ partial, int* __restrict__ counter,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int* tb = tasks + static_cast<size_t>(b) * (n + 1);
  if (w >= tb[n]) return;  // warp-uniform
  const int d = task_dest[static_cast<size_t>(b) * max_tasks + w];
  const int chunks = tb[d + 1] - tb[d];
  const int* ob = offsets + static_cast<size_t>(b) * (n + 1);
  const int beg = ob[d] + (w - tb[d]) * kSegRows;
  const int end = min(ob[d + 1], beg + kSegRows);
  const int* rb = rows + static_cast<size_t>(b) * r_n;
  const float* cb = ct + static_cast<size_t>(b) * r_n * c_n;
  float* orow = out + (static_cast<size_t>(b) * n + d) * c_n;
  float* dst = chunks == 1 ? orow : partial + (static_cast<size_t>(b) * max_tasks + w) * c_n;

  for (int c0 = 0; c0 < c_n; c0 += kPassChannels) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = beg; i < end; i += 32) {
      const int my_row = i + lane < end ? rb[i + lane] : 0;
      const int m = min(32, end - i);
      for (int j = 0; j < m; j += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = __shfl_sync(0xffffffffu, my_row, (j + u) & 31);
          v[u] = j + u < m ? load_lane<kVec>(cb + static_cast<size_t>(row) * c_n, c0, lane, c_n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (j + u < m) add4(acc, v[u]);
      }
    }
    store_lane<kVec>(dst, c0, lane, c_n, acc);
  }
  if (chunks == 1) return;

  // the segment's last chunk to finish adds the partials in chunk order
  __threadfence();
  __syncwarp();  // every lane's partial is out before the count
  int last = 0;
  if (lane == 0) last = atomicAdd(&counter[static_cast<size_t>(b) * n + d], 1) == chunks - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  const float* pb = partial + (static_cast<size_t>(b) * max_tasks + tb[d]) * c_n;
  for (int c0 = 0; c0 < c_n; c0 += kPassChannels) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < chunks; ++q) add4(acc, load_partial<kVec>(pb + static_cast<size_t>(q) * c_n, c0, lane, c_n));
    store_lane<kVec>(orow, c0, lane, c_n, acc);
  }
}

// the hist and rank kernels' shared-memory limit raised past 48 KB, once
// per process and device
cudaError_t device_setup() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// the grids' and the int32 arrays' limits (layout() keeps n * tiles within
// max(n, kMaxCounts))
bool valid_args(int b, int r_n, int n, int c_n) {
  if (b < 1 || b > 65535 || n < 1 || c_n < 1 || r_n < 0 || r_n > 0x7fffffff - kTileRows) return false;
  const long long tasks = static_cast<long long>(n) + r_n / kSegRows;
  return (static_cast<long long>(n) + kDestChunk - 1) / kDestChunk <= 65535 && tasks + kSumWarps <= 0x7fffffff;
}

}  // namespace

// Bytes of scratch gb_scatter_add needs for these sizes (0 if it refuses them).
extern "C" long long gb_scatter_add_scratch(int b, int r_n, int n, int c_n) {
  if (!valid_args(b, r_n, n, c_n)) return 0;
  return static_cast<long long>(layout(b, r_n, n, c_n).bytes);
}

// ct: (B, R, C) f32; idx: (B, R) int32; out: (B, n, C) f32, fully written;
// scratch: gb_scatter_add_scratch bytes, 16-byte aligned. B, n, C >= 1;
// R >= 0.
extern "C" int gb_scatter_add(const float* ct, const int32_t* idx, float* out, void* scratch, int b, int r_n,
                              int n, int c_n, void* stream) {
  if (!valid_args(b, r_n, n, c_n) || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = device_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout l = layout(b, r_n, n, c_n);
  char* base = static_cast<char*>(scratch);
  float* partial = reinterpret_cast<float*>(base + l.partial);
  int* start = reinterpret_cast<int*>(base + l.start);
  int* offsets = reinterpret_cast<int*>(base + l.offsets);
  int* tasks = reinterpret_cast<int*>(base + l.tasks);
  int* task_dest = reinterpret_cast<int*>(base + l.task_dest);
  int* counter = reinterpret_cast<int*>(base + l.counter);
  int* done = reinterpret_cast<int*>(base + l.done);
  int* rows = reinterpret_cast<int*>(base + l.rows);
  const int dn = n < kDestChunk ? n : kDestChunk;  // destinations per hist / rank block
  const size_t smem = sizeof(int) * static_cast<size_t>(dn);
  const dim3 sort_grid(l.tiles, b, (n + kDestChunk - 1) / kDestChunk);

  hist_kernel<<<sort_grid, kHistThreads, smem, s>>>(idx, r_n, n, l.tile_rows, l.tiles, start, counter, done);
  scan_kernel<<<dim3((n + 31) / 32, b), kScanThreads, 0, s>>>(n, l.tiles, l.max_tasks, start, offsets, tasks,
                                                              task_dest, done);
  // as many warps per rank block as shared memory holds their slots
  const int rank_warps = static_cast<int>(std::min<size_t>(kRankWarps, kSmemMax / smem));
  if (r_n > 0)
    rank_kernel<<<sort_grid, 32 * rank_warps, smem * rank_warps, s>>>(idx, start, offsets, r_n, n, l.tile_rows,
                                                                      l.tiles, rows);
  const dim3 sum_grid((l.max_tasks + kSumWarps - 1) / kSumWarps, b);
  const bool vec = c_n % 4 == 0 && (reinterpret_cast<uintptr_t>(ct) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec) {
    sum_kernel<true><<<sum_grid, kSumWarps * 32, 0, s>>>(ct, offsets, tasks, task_dest, rows, r_n, n, c_n,
                                                         l.max_tasks, partial, counter, out);
  } else {
    sum_kernel<false><<<sum_grid, kSumWarps * 32, 0, s>>>(ct, offsets, tasks, task_dest, rows, r_n, n, c_n,
                                                          l.max_tasks, partial, counter, out);
  }
  return static_cast<int>(cudaGetLastError());
}
