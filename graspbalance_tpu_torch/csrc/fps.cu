// Greedy furthest point sampling, (B, N, 3) f32 -> (B, m) int32, and its
// masked mode over per-row valid subsets.
//
// Replaces graspbalance_tpu/ops/pallas/fps_kernel.py:fps_pallas_2d_batched,
// and with it the same function in the older layouts fps_pallas_2d and
// fps_pallas; the masked mode (gb_fps_masked) replaces
// fps_pallas_2d_batched_masked, OBS's per-object FPS.
//
// Semantics: idx[0] = 0; the running distance starts at 1e10; a point with
// |p|^2 <= 1e-3 is never selected (its distance starts at -1, and
// min(-1, d) stays -1); each step takes the point with the largest running
// distance, the lowest index on a tie. The wrapper passes the initial
// distances (validity folded in, as the TPU kernel folds it).
//
// What bounds it on the H100: the latency of the step chain, not bytes or
// FLOPs. Each of the m-1 steps is a min + argmax over the whole cloud whose
// winner the next step needs, so the steps cannot overlap: at (4, 20000) ->
// 2048 the distance work is ~20k updates a step, a few hundred cycles
// spread over a few SMs, and the rest of a step is the exchange of the
// winner between the SMs that hold the cloud.
//
// Design (gb_fps): a thread-block cluster per cloud, of 1 to 16 blocks of
// 128 threads on neighbouring SMs, the smallest whose threads hold at most
// 20 points each (8 blocks at N = 20000), else 16 blocks with up to 32
// points a thread (N <= 65536). Block r of the cluster owns the points
// [r * 128 * P, (r + 1) * 128 * P), thread t the points t + 128 p; each
// thread keeps its points' coordinates and running distances in registers,
// so no coordinate is read twice. A step:
//   1. each thread updates its distances and keeps its best (value, index,
//      coordinates); the distance is written with __fsub_rn / __fmul_rn /
//      __fadd_rn so that nvcc cannot contract it into an FMA (the plain
//      version rounds every product, and one flipped last bit on a near-tie
//      changes every later index);
//   2. each warp reduces its 32 candidates with two redux.sync instructions
//      (the largest value as an order-preserving int, then the lowest index
//      among the lanes that hold it);
//   3. the warp pushes its winner (value, index, x, y, z) into its own slot
//      of every block of the cluster: lane c stores it into block c's shared
//      memory with st.async, which completes bytes on block c's mbarrier;
//   4. each block waits on its own mbarrier for all the cluster's warp
//      winners (4 x cluster size), then every warp reduces them from its
//      block's shared memory by the same rule, so every thread knows the
//      winner and its coordinates. Thread 0 of block 0 writes out[j].
// No cluster barrier and no remote load is on the step's path: one one-way
// remote store and a local wait. (A version with one cluster barrier a step
// and every warp reading the winners over distributed shared memory was
// measured first, and was slower: the barrier and the remote reads each
// cost about as much as the whole step of this one.)
// The slots and mbarriers are double-buffered: step j + 2 writes step j's
// slots and completes its mbarrier's next phase only after its writer has
// received all of step j + 1's winners, and every warp sends its step j + 1
// winner only after reading step j's slots; each block's thread 0 re-arms
// a buffer's mbarrier (expect_tx) right after its phase completes, before
// any step j + 2 byte can arrive. Every comparison prefers the larger value,
// then the lower index, so the result depends on no warp, block or arrival
// order and is bit-equal to the plain version.
//
// gb_fps_chain runs the same launch with the distance work taken out (each
// thread's best is taken once, then every step only reduces, pushes and
// waits): the latency floor of the step chain at a shape, for measurement
// only.
//
// Masked mode (gb_fps_masked): one block per row, reading the (S, N, 3)
// points and the (S, N) valid mask as they are. A valid point's running
// distance starts at 1e10, an invalid point's at -1 (never selected, as
// above); the seed is each row's first valid index (index 0 for a row with
// none, whose slots are all 0), and the step count is read from a device int32, max_needed,
// clamped to [1, m], so that OBS launches without a host sync. Slots from
// max_needed on are written as 0 (the caller promises not to read them).
// OBS runs S = B x 16 rows of N = 4096 compacted points whose valid points
// form a prefix, for ~128 steps: latency-bound like the main mode, but
// inside one block, so a step's cost is its chain of dependent operations.
// A step takes one barrier and no global read:
//   1. each thread updates the running distances of its points (point p of
//      thread t has index t + T p) and keeps its best (value, lowest
//      index); a warp updates its points in groups of kGroup, only up to the
//      group of its last valid point (counted once per row), so in OBS's
//      prefix rows the warps past the prefix only reduce (a warp-uniform
//      test per point, each a branch on the step's chain, was slower);
//   2. each warp reduces its lanes' candidates as one key, the distance's
//      order-preserving int above the index (two redux.sync: the largest
//      key, then the lowest index holding it), and lane 0 stores the
//      (key, index) pair into the warp's slot of a parity-buffered shared
//      array (step j writes buffer j % 2; a warp that writes step j + 1's
//      slot has passed step j's barrier, after every read of step j - 1's);
//   3. one __syncthreads, then every warp reduces the block's slots by the
//      same rule, so every thread knows the winner without a second
//      barrier; thread 0 writes out[j];
//   4. the winner's coordinates come from the row staged in shared memory
//      (float4 per point), read once at the start.
// Rows of up to kStagedMax = 8,192 points take this route: 256 threads with
// up to 32 points each, coordinates and distances in registers. Longer
// rows (foreground_indices passes whole 20,000-point scenes), up to 32,768
// points, take 1,024 threads with 32 distances each in registers and read
// their coordinates, and the winner's, through L1 every step. Both give the
// plain version's indices bit for bit.
//
// Streaming mode (gb_fps_stream): clouds past the two register-resident
// routes (N > 65,536 in the main mode, N > 32,768 in the masked mode) up
// to any N that int32 indexes. The running distances live in global
// memory, (B, N) f32 updated in place, and the coordinates are read as
// (B, 3, N) planes every step; at 2^20 points that is 16 MB a step, which
// the H100's 50 MB L2 keeps resident, so a step streams from L2, not HBM.
// One cooperative launch, P blocks per cloud (as many as are co-resident,
// at most one per kStreamThreads points), block p of a cloud taking the
// points p * T + t + k * P * T. A step:
//   1. each thread updates its points' distances and keeps its best
//      (value, lowest index), visiting its points in rising index order;
//   2. each warp reduces its lanes' (order key, index) by two redux.sync,
//      the block its warps' winners in shared memory, and warp 0 stores the
//      block's winner into its slot of a parity-buffered global array;
//   3. one grid-wide barrier (cooperative groups); then warp 0 of every
//      block reduces its cloud's P slots (read past L1, which is not
//      coherent across SMs) by the same rule, and every thread reads the
//      winner's coordinates.
// Each reduction prefers the larger key, then the lower index, so no step
// depends on the order of blocks, warps or arrivals, and the indices equal
// the plain version's bit for bit. Step j writes buffer j % 2; a block
// writes step j + 2's slot only after passing step j + 1's barrier, which
// every block reaches after reading step j's slots. The masked mode takes
// the same kernel: the wrapper folds validity into the initial distances
// and passes each row's seed (its first valid index) and max_needed as
// device int32s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // a block of the main path's cluster
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;       // non-portable; 8 is the portable limit
constexpr int kTargetPerThread = 20;  // the smallest cluster whose threads hold at most this
constexpr int kMaxPerThread = 32;
constexpr int kMaxPoints = kMaxCluster * kThreads * kMaxPerThread;  // 65536
constexpr int kSlotBytes = 20;        // a winner as pushed: key, index, x, y, z
constexpr int kMaskedThreads = 256;   // rows staged in shared memory, up to 32 points a thread
constexpr int kMaskedBigThreads = 1024;  // longer rows, coordinates through L1
constexpr int kStagedMax = kMaskedThreads * 32;  // 8192
constexpr float kInitDist = 1e10f;  // a valid point's running distance before the first step
constexpr int kGroup = 4;  // the masked kernel's points a thread, updated or skipped together
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// a float's order as a signed int's: larger value, larger key (-1 and the
// padding's -inf included)
__device__ __forceinline__ int order_key(float v) {
  const int k = __float_as_int(v);
  return k ^ ((k >> 31) & 0x7fffffff);
}

// a warp winner as it lands in a block's shared memory (16-byte aligned for
// the vector store; the pad is never written)
struct __align__(16) Slot {
  int key;
  unsigned idx;
  float x, y, z;
  int pad[3];
};

// the warp's best of the lanes' (key, idx): every lane gets (key, idx) and
// the lane that holds it
__device__ __forceinline__ int warp_winner(int& key, unsigned& idx) {
  const int wk = __reduce_max_sync(0xffffffffu, key);
  const unsigned wi = __reduce_min_sync(0xffffffffu, key == wk ? idx : 0xffffffffu);
  const unsigned holders = __ballot_sync(0xffffffffu, key == wk && idx == wi);
  key = wk;
  idx = wi;
  return __ffs(holders) - 1;
}

// the thread's best of its points (point p has index base + p * kThreads):
// its order key, index and coordinates
template <int P>
__device__ __forceinline__ void thread_best(const float (&dist)[P], const float (&x)[P],
                                            const float (&y)[P], const float (&z)[P], int base,
                                            int& key, unsigned& idx, float& bx, float& by,
                                            float& bz) {
  float bv = -INFINITY;
  idx = 0xffffffffu;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (dist[p] > bv) {  // the index rises with p: strict > keeps the lowest
      bv = dist[p];
      idx = base + p * kThreads;
      bx = x[p];
      by = y[p];
      bz = z[p];
    }
  }
  key = order_key(bv);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// arm the barrier's current phase: one arrival, `bytes` to come
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the winner into a slot of another block (cluster address), completing
// its 20 bytes on that block's mbarrier
__device__ __forceinline__ void push(unsigned slot, unsigned bar, int key, unsigned idx, float x, float y,
                                     float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(slot),
      "r"(key), "r"(idx), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(bar)
      : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(slot + 16),
               "r"(__float_as_uint(z)), "r"(bar)
               : "memory");
}

template <int P, bool kChainOnly>
__global__ void __launch_bounds__(kThreads, 1)
    fps_cluster_kernel(const float* __restrict__ planes, const float* __restrict__ dist0, int n,
                       int m, int32_t* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / csize;
  const float* px = planes + static_cast<size_t>(cloud) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* d0 = dist0 + static_cast<size_t>(cloud) * n;
  int32_t* o = out + static_cast<size_t>(cloud) * m;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = rank * (kThreads * P) + t;
  const bool writer = rank == 0 && t == 0;
  const int winners = csize * kWarps;  // the slots a step fills in each block
  const int step_bytes = winners * kSlotBytes;

  // slot[b][r * kWarps + w]: warp w of block r's winner of a step j with j % 2 == b
  __shared__ Slot slot[2][kMaxCluster * kWarps];
  __shared__ __align__(8) unsigned long long bar[2];
  if (t == 0) {
    mbar_init(smem_addr(&bar[0]));
    mbar_init(smem_addr(&bar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&bar[1]), step_bytes);  // step 1
    mbar_expect(smem_addr(&bar[0]), step_bytes);  // step 2
  }

  // this thread's points; padding past n has distance -inf and never wins
  float x[P], y[P], z[P], dist[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = base + p * kThreads;
    const bool in = i < n;
    x[p] = in ? px[i] : 0.0f;
    y[p] = in ? py[i] : 0.0f;
    z[p] = in ? pz[i] : 0.0f;
    dist[p] = in ? d0[i] : -INFINITY;
  }
  if (writer) o[0] = 0;
  float lx = px[0], ly = py[0], lz = pz[0];

  // the thread's best candidate of the step
  int bk = 0;
  unsigned bi = 0;
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  if (kChainOnly) thread_best<P>(dist, x, y, z, base, bk, bi, bx, by, bz);

  // lane c < csize pushes this warp's winners to block c
  const int to = lane < csize ? lane : 0;
  const unsigned to_slot0 = cluster_addr(smem_addr(&slot[0][rank * kWarps + warp]), to);
  const unsigned to_slot1 = cluster_addr(smem_addr(&slot[1][rank * kWarps + warp]), to);
  const unsigned to_bar0 = cluster_addr(smem_addr(&bar[0]), to);
  const unsigned to_bar1 = cluster_addr(smem_addr(&bar[1]), to);
  unsigned parity = 0;  // bit b: the parity of buffer b's phase to wait for
  // every block's mbarriers are armed before anything is pushed to them
  cluster.sync();
  for (int j = 1; j < m; ++j) {
    if (!kChainOnly) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float d = sq3(__fsub_rn(x[p], lx), __fsub_rn(y[p], ly), __fsub_rn(z[p], lz));
        dist[p] = fminf(dist[p], d);
      }
      thread_best<P>(dist, x, y, z, base, bk, bi, bx, by, bz);
    }
    int key = bk;
    unsigned idx = bi;
    int from = warp_winner(key, idx);
    const int buf = j & 1;
    {
      const float wx = __shfl_sync(0xffffffffu, bx, from);
      const float wy = __shfl_sync(0xffffffffu, by, from);
      const float wz = __shfl_sync(0xffffffffu, bz, from);
      if (lane < csize) push(buf ? to_slot1 : to_slot0, buf ? to_bar1 : to_bar0, key, idx, wx, wy, wz);
    }
    const unsigned my_bar = smem_addr(&bar[buf]);
    mbar_wait(my_bar, (parity >> buf) & 1);
    parity ^= 1u << buf;
    if (t == 0 && j + 2 < m) mbar_expect(my_bar, step_bytes);

    // the cluster's winners of this step, up to kMaxCluster * kWarps / 32 a
    // lane, reduced by the same rule
    constexpr int kPerLane = kMaxCluster * kWarps / 32;
    key = INT_MIN;
    idx = 0xffffffffu;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int e = lane + 32 * q;
      if (e < winners) {
        const Slot& c = slot[buf][e];
        if (c.key > key || (c.key == key && c.idx < idx)) {
          key = c.key;
          idx = c.idx;
          wx = c.x;
          wy = c.y;
          wz = c.z;
        }
      }
    }
    from = warp_winner(key, idx);
    lx = __shfl_sync(0xffffffffu, wx, from);
    ly = __shfl_sync(0xffffffffu, wy, from);
    lz = __shfl_sync(0xffffffffu, wz, from);
    if (writer) o[j] = static_cast<int32_t>(idx);
  }
  // a block's shared memory must outlive the cluster's accesses to it
  cluster.sync();
}

// clusters past 8 blocks, allowed once per instantiation, process and device
template <int P, bool kChainOnly>
cudaError_t allow_wide_clusters() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(fps_cluster_kernel<P, kChainOnly>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int P, bool kChainOnly>
cudaError_t launch_cluster(const float* planes, const float* dist0, int32_t* out, int b, int n, int m,
                           int c, cudaStream_t stream) {
  cudaError_t err = allow_wide_clusters<P, kChainOnly>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<P, kChainOnly>, planes, dist0, n, m, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the cluster size for n points: the smallest whose threads hold at most
// kTargetPerThread points each, else the largest
int cluster_for(int n) {
  for (int c = 1; c < kMaxCluster; c *= 2)
    if (n <= c * kThreads * kTargetPerThread) return c;
  return kMaxCluster;
}

template <bool kChainOnly>
cudaError_t launch_fps(const float* planes, const float* dist0, int32_t* out, int b, int n, int m,
                       cudaStream_t s) {
  if (b < 1 || n < 1 || n > kMaxPoints || m < 1) return cudaErrorInvalidValue;
  const int c = cluster_for(n);
  const int per = (n + c * kThreads - 1) / (c * kThreads);
  if (per <= 1) return launch_cluster<1, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 2) return launch_cluster<2, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 4) return launch_cluster<4, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 8) return launch_cluster<8, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 12) return launch_cluster<12, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 16) return launch_cluster<16, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 20) return launch_cluster<20, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  if (per <= 24) return launch_cluster<24, kChainOnly>(planes, dist0, out, b, n, m, c, s);
  return launch_cluster<kMaxPerThread, kChainOnly>(planes, dist0, out, b, n, m, c, s);
}

// one masked row per block (see the note at the top): T threads, P points
// a thread; kStaged: coordinates in registers and the row in shared memory,
// else coordinates read through L1
template <int T, int P, bool kStaged>
__global__ void __launch_bounds__(T, 1)
    fps_masked_kernel(const float* __restrict__ xyz, const bool* __restrict__ valid, int n, int m,
                      const int32_t* __restrict__ needed, int32_t* __restrict__ out) {
  constexpr int kBlockWarps = T / 32;
  extern __shared__ float4 s_xyz[];  // kStaged: the row's n points
  __shared__ int2 s_slot[2][kBlockWarps];  // a step's warp winners (key, index), by parity
  __shared__ int s_first;
  const float* pr = xyz + static_cast<size_t>(blockIdx.x) * 3 * n;
  const bool* vr = valid + static_cast<size_t>(blockIdx.x) * n;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // this thread's points; padding past n has distance -inf and never wins
  float x[kStaged ? P : 1], y[kStaged ? P : 1], z[kStaged ? P : 1], dist[P];
  int top = 0;    // 1 + the last p holding a valid point
  int first = INT_MAX;  // the thread's first valid index
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = t + p * T;
    const bool in = i < n;
    const bool ok = in && vr[i];
    dist[p] = ok ? kInitDist : (in ? -1.0f : -INFINITY);
    if (ok) {
      top = p + 1;
      first = min(first, i);
    }
    if constexpr (kStaged) {
      x[p] = in ? pr[3 * i] : 0.0f;
      y[p] = in ? pr[3 * i + 1] : 0.0f;
      z[p] = in ? pr[3 * i + 2] : 0.0f;
      if (in) s_xyz[i] = make_float4(x[p], y[p], z[p], 0.0f);
    }
  }
  // the warp updates its points up to its last valid one
  const int upto = __reduce_max_sync(0xffffffffu, top);
  // seed: the first valid index
  if (t == 0) s_first = INT_MAX;
  __syncthreads();
  first = static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(first)));
  if (lane == 0 && first != INT_MAX) atomicMin(&s_first, first);
  __syncthreads();  // also publishes the staged row
  const int seed = s_first;
  const int steps = min(max(*needed, 1), m);
  for (int j = steps + t; j < m; j += T) o[j] = 0;
  if (seed == INT_MAX) {  // no valid point: index 0 everywhere
    for (int j = t; j < steps; j += T) o[j] = 0;
    return;
  }
  if (t == 0) o[0] = seed;

  float lx, ly, lz;
  if constexpr (kStaged) {
    const float4 q = s_xyz[seed];
    lx = q.x, ly = q.y, lz = q.z;
  } else {
    lx = pr[3 * seed], ly = pr[3 * seed + 1], lz = pr[3 * seed + 2];
  }
  for (int j = 1; j < steps; ++j) {
    float bv = -INFINITY;
    unsigned bi = t;  // a lane without a candidate above -inf never wins: the row has a valid point
#pragma unroll
    for (int g = 0; g < P; g += kGroup) {
      if (g >= upto) continue;  // a warp-uniform test per kGroup points
#pragma unroll
      for (int p = g; p < g + kGroup; ++p) {
        const int i = t + p * T;
        float xp, yp, zp;
        if constexpr (kStaged) {
          xp = x[p], yp = y[p], zp = z[p];
        } else {
          const float* q = pr + 3 * min(i, n - 1);  // past n: any point, its distance stays -inf
          xp = __ldg(q), yp = __ldg(q + 1), zp = __ldg(q + 2);
        }
        const float d = sq3(__fsub_rn(xp, lx), __fsub_rn(yp, ly), __fsub_rn(zp, lz));
        const float nd = fminf(dist[p], d);
        dist[p] = nd;
        if (nd > bv) {  // i rises with p: strict > keeps the lowest index
          bv = nd;
          bi = i;
        }
      }
    }
    // the warp's winner: the largest key, then the lowest index holding it
    const int key = order_key(bv);
    const int wk = __reduce_max_sync(0xffffffffu, key);
    const unsigned wi = __reduce_min_sync(0xffffffffu, key == wk ? bi : 0xffffffffu);
    const int buf = j & 1;
    if (lane == 0) s_slot[buf][warp] = make_int2(wk, static_cast<int>(wi));
    __syncthreads();
    // every warp reduces the block's winners by the same rule
    const int2 c = lane < kBlockWarps ? s_slot[buf][lane] : make_int2(INT_MIN, -1);
    const int bk = __reduce_max_sync(0xffffffffu, c.x);
    const unsigned best = __reduce_min_sync(0xffffffffu, c.x == bk ? static_cast<unsigned>(c.y) : 0xffffffffu);
    if (t == 0) o[j] = static_cast<int32_t>(best);
    if constexpr (kStaged) {
      const float4 q = s_xyz[best];
      lx = q.x, ly = q.y, lz = q.z;
    } else {
      const float* q = pr + 3 * best;
      lx = __ldg(q), ly = __ldg(q + 1), lz = __ldg(q + 2);
    }
  }
}

// the staged kernels' shared memory past 48 KB, allowed once per
// instantiation, process and device
template <int T, int P>
cudaError_t allow_staged_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(fps_masked_kernel<T, P, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T * P * static_cast<int>(sizeof(float4)));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int P>
cudaError_t launch_staged(const float* xyz, const bool* valid, const int32_t* needed, int32_t* out, int b, int n,
                          int m, cudaStream_t stream) {
  constexpr int T = kMaskedThreads;
  cudaError_t err = allow_staged_smem<T, P>();
  if (err != cudaSuccess) return err;
  fps_masked_kernel<T, P, true><<<b, T, n * sizeof(float4), stream>>>(xyz, valid, n, m, needed, out);
  return cudaGetLastError();
}

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamMaxParts = 1024;  // blocks per cloud; the slots' capacity

__global__ void __launch_bounds__(kStreamThreads)
    fps_stream_kernel(const float* __restrict__ planes, float* __restrict__ dist, const int32_t* __restrict__ seed,
                      const int32_t* __restrict__ needed, int n, int m, int cloud0, int parts,
                      int2* __restrict__ slots, int32_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int2 s_warp[kStreamWarps];
  __shared__ int s_win;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int local = blockIdx.x / parts;  // the cloud within this launch
  const int part = blockIdx.x % parts;
  const int cloud = cloud0 + local;
  const float* px = planes + static_cast<size_t>(cloud) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  float* d = dist + static_cast<size_t>(cloud) * n;
  int32_t* o = out + static_cast<size_t>(cloud) * m;
  const int steps = needed != nullptr ? min(max(*needed, 1), m) : m;
  const int first = seed != nullptr ? seed[cloud] : 0;
  if (part == 0) {
    for (int j = steps + t; j < m; j += kStreamThreads) o[j] = 0;
    if (t == 0) o[0] = first;
  }
  const size_t buf_stride = gridDim.x;  // slots[b * gridDim.x + block]
  const int2* cloud_slots = slots + static_cast<size_t>(local) * parts;
  const int stride = parts * kStreamThreads;
  float lx = __ldg(px + first), ly = __ldg(py + first), lz = __ldg(pz + first);
  for (int j = 1; j < steps; ++j) {
    float bv = -INFINITY;
    unsigned bi = 0xffffffffu;
    for (int i = part * kStreamThreads + t; i < n; i += stride) {
      const float dd = sq3(__fsub_rn(__ldg(px + i), lx), __fsub_rn(__ldg(py + i), ly), __fsub_rn(__ldg(pz + i), lz));
      const float nd = fminf(d[i], dd);
      d[i] = nd;
      if (nd > bv) {  // i rises: strict > keeps the lowest index
        bv = nd;
        bi = i;
      }
    }
    int key = order_key(bv);
    warp_winner(key, bi);
    if (lane == 0) s_warp[warp] = make_int2(key, static_cast<int>(bi));
    __syncthreads();
    const size_t buf = (j & 1) * buf_stride;
    if (warp == 0) {
      const int2 c = lane < kStreamWarps ? s_warp[lane] : make_int2(INT_MIN, -1);
      key = c.x;
      bi = static_cast<unsigned>(c.y);
      warp_winner(key, bi);
      if (lane == 0) slots[buf + blockIdx.x] = make_int2(key, static_cast<int>(bi));
    }
    grid.sync();
    if (warp == 0) {
      key = INT_MIN;
      bi = 0xffffffffu;
      for (int e = lane; e < parts; e += 32) {
        const int2 c = __ldcg(cloud_slots + buf + e);
        if (c.x > key || (c.x == key && static_cast<unsigned>(c.y) < bi)) {
          key = c.x;
          bi = static_cast<unsigned>(c.y);
        }
      }
      warp_winner(key, bi);
      if (lane == 0) s_win = static_cast<int>(bi);
    }
    __syncthreads();
    const int w = s_win;
    if (part == 0 && t == 0) o[j] = w;
    lx = __ldg(px + w), ly = __ldg(py + w), lz = __ldg(pz + w);
  }
}

cudaError_t launch_stream(const float* planes, float* dist, const int32_t* seed, const int32_t* needed,
                          int32_t* out, int2* slots, int b, int n, int m, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fps_stream_kernel, kStreamThreads, 0);
  if (err != cudaSuccess) return err;
  const int resident = sms * per_sm;  // blocks that can all run at once
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int want = min((n + kStreamThreads - 1) / kStreamThreads, kStreamMaxParts);
  for (int c0 = 0; c0 < b; c0 += resident) {
    const int clouds = min(b - c0, resident);
    int parts = max(1, min(want, resident / clouds));
    unsigned grid = static_cast<unsigned>(clouds * parts);
    void* args[] = {&planes, &dist, &seed, &needed, &n, &m, &c0, &parts, &slots, &out};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fps_stream_kernel), dim3(grid), dim3(kStreamThreads),
                                      args, 0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Streaming mode, any N (see the note at the top). planes: (B, 3, N) f32;
// dist: (B, N) f32 initial distances, overwritten; seed: (B,) device int32
// first indices, or null for 0; needed: one device int32 step count, or
// null for m; slots: device scratch of gb_fps_stream_slots(B) int2 (the
// launch's per-block winners, two parities); out: (B, m) int32.
extern "C" long long gb_fps_stream_slots(int b) { return 2LL * b * kStreamMaxParts; }

extern "C" int gb_fps_stream(const float* planes, float* dist, const int32_t* seed, const int32_t* needed,
                             int32_t* out, void* slots, int b, int n, int m, void* stream) {
  return static_cast<int>(launch_stream(planes, dist, seed, needed, out, static_cast<int2*>(slots), b, n, m,
                                        static_cast<cudaStream_t>(stream)));
}

// planes: (B, 3, N) f32; dist0: (B, N) f32 initial distances (1e10, or -1
// for a point never to be selected); out: (B, m) int32. N <= 65536.
extern "C" int gb_fps(const float* planes, const float* dist0, int32_t* out, int b, int n, int m,
                      void* stream) {
  return static_cast<int>(
      launch_fps<false>(planes, dist0, out, b, n, m, static_cast<cudaStream_t>(stream)));
}

// gb_fps's launch with the distance work taken out: every step only
// reduces the same candidates, pushes them across the cluster and waits.
// out gets the same index at every step; for timing the chain alone.
extern "C" int gb_fps_chain(const float* planes, const float* dist0, int32_t* out, int b, int n, int m,
                            void* stream) {
  return static_cast<int>(
      launch_fps<true>(planes, dist0, out, b, n, m, static_cast<cudaStream_t>(stream)));
}

// Masked mode. xyz: (S, N, 3) f32; valid: (S, N) bool; needed: one device
// int32, the number of leading slots the caller reads; out: (S, m) int32.
// N <= 32768 (rows past 8192 points take 1024-thread blocks that read their
// coordinates through L1).
extern "C" int gb_fps_masked(const float* xyz, const bool* valid, const int32_t* needed, int32_t* out, int b,
                             int n, int m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = (n + kMaskedThreads - 1) / kMaskedThreads;
  cudaError_t err;
  if (per_thread <= 4) err = launch_staged<4>(xyz, valid, needed, out, b, n, m, s);
  else if (per_thread <= 8) err = launch_staged<8>(xyz, valid, needed, out, b, n, m, s);
  else if (per_thread <= 16) err = launch_staged<16>(xyz, valid, needed, out, b, n, m, s);
  else if (n <= kStagedMax) err = launch_staged<32>(xyz, valid, needed, out, b, n, m, s);
  else if (n <= 32 * kMaskedBigThreads) {
    fps_masked_kernel<kMaskedBigThreads, 32, false><<<b, kMaskedBigThreads, 0, s>>>(xyz, valid, n, m, needed, out);
    err = cudaGetLastError();
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* gb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
