// First-k-by-index selection for all cylinder combos of the grasp head, from
// a precomputed class plane.
//
// Replaces graspbalance_tpu/ops/pallas/select_kernel.py:multicyl_select.
//
// Each point of a row carries one class value, c = rc * 8 + hc (rc: the radii
// whose cylinder excludes it, hc: the depths below it; 63 for a point that no
// combo takes), built by ops/query.py:class_plane. The point hits combo
// (ri, hi) iff rc <= ri and hc <= hi, which equals the cylinder test when
// the radii and depths ascend. Per row and combo: the first k hits in index
// order; slots past the hit count repeat the first hit; a combo with no hit
// gets index 0 everywhere. Combos are radius-major: combo = ri * n_h + hi.
//
// What bounds it on the H100: the bytes, if the per-point work stays a few
// integer operations. The plane is one byte per point (82 MB at the fused
// eval forward's 4 x 1024 rows of 20,000 points); every row is scanned
// until all combos hold k hits, which for the smallest cylinder usually
// means the whole row. A design that tests each combo on each point (a
// ballot and popcounts per combo and 32 points) is bound by instruction
// issue at ~90x the byte floor.
//
// Design: one warp per row, eight rows per block. A warp step covers 512
// points: each lane loads 16 class bytes at once (one uint4 from the
// 16-byte-aligned address below the row's start, the next step's load
// issued before this step's work; bytes outside the row count as 63). The
// bit work is done once per point, not once per point and combo:
//   1. bytewise compares find the lane's points in the cover of the open
//      combos, the smallest combo whose radius and depth are each the
//      largest of an open combo's (it holds every point that hits an open
//      combo); a step where no lane has one moves on, and the cover shrinks
//      as combos fill, so once only the small cylinders are open most steps
//      end here;
//   2. a step with at most kSparse covered points takes them one at a time
//      in index order: the lowest lane holding one broadcasts its index and
//      class, and lane c, which keeps combo c's count and first hit, writes
//      it into combo c's next slot if it hits c (a bit of a 64-entry table
//      of combo masks);
//   3. a step with more counts them in packed fields. A 64-entry table in
//      shared memory, built once per block from n_r and n_h, maps a class
//      value to one 4-bit field per combo (1 if the value hits it; 63, and
//      values above it, hit nothing), 16 fields in 64 bits; a lane adds the
//      entries of its covered points among 0-7 and among 8-15 into two
//      such 64-bit sums (each field <= 8), widens them to 8-bit fields and
//      adds them (<= 16), then widens again to 16-bit fields: 8 words of
//      two combos each. One warp inclusive scan per packed word (five
//      shuffles; skipped for a word whose combos are all full or have no
//      hit) gives every lane, per combo, the hits in the step before its
//      own points, and lane 31's sums the step's totals. For each combo
//      still short of k hits (a warp-uniform test), the lanes whose first
//      slot lies below k find their own points that hit it (bytewise
//      compares) and write their slots in index order; the lowest lane
//      with a hit gives the combo's first hit when it had none;
//   4. the walk stops once every combo holds k hits. Then the slots past
//      each count get its first hit.
// The TPU kernel's slot-tile one-hot matmuls and log-shift scans were TPU
// workarounds: here the lane that owns a hit writes it directly.
//
// The aligned loads may read up to 15 bytes before a row's start and after
// its end; those bytes lie in the 16-byte block of a byte of the row, so in
// the same allocation page, and are masked before use.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCombos = 16;
constexpr int kWarpsPerBlock = 8;
constexpr int kClasses = 64;  // class values 0-63; 63 and above hit no combo
constexpr int kStepChunks = 32;  // 16-byte chunks a warp step loads, one a lane
constexpr int kSparse = 32;  // a step with at most this many covered points takes them one at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEachByte = 0x01010101u;
constexpr unsigned kNibbles = 0x0f0f0f0fu;
constexpr unsigned kHalves = 0x00ff00ffu;
constexpr unsigned kTopBits = 0x80808080u;

// combo c's 16-bit field in a lane's 8 packed count words: the 4-bit sums
// hold combos 0-7 in word 0 and 8-15 in word 1, the 8-bit words (even
// nibbles, odd nibbles) x (word 0, word 1), the 16-bit words (even bytes,
// odd bytes) of each
__host__ __device__ constexpr int field_word(int c) { return 2 * (2 * (c >> 3) + (c & 1)) + ((c >> 1) & 1); }
__host__ __device__ constexpr int field_shift(int c) { return 16 * ((c >> 2) & 1); }

// the combos whose fields packed word w holds
__host__ __device__ constexpr unsigned word_combos(int w) {
  unsigned m = 0;
  for (int c = 0; c < kMaxCombos; ++c)
    if (field_word(c) == w) m |= 1u << c;
  return m;
}

// the lane's points (byte b of word i: point 4 i + b) that hit the combo
// whose thresholds are thr: x, (ri + 1) * 8 in every byte; y, hi + 1 in
// every byte. With a byte's top bit set beforehand, a subtraction leaves it
// set iff the byte is at least the threshold, and no borrow crosses bytes.
__device__ __forceinline__ unsigned hit_bits(const unsigned (&w)[4], uint2 thr) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned miss = ((w[i] | kTopBits) - thr.x) | (((w[i] & 0x07070707u) | kTopBits) - thr.y);
    const unsigned hit = (~miss & kTopBits) >> 7;      // bit 8 b: point 4 i + b hits
    bits |= ((hit * 0x10204080u) >> 28) << (4 * i);  // gathers bits 0, 8, 16, 24 into bits 28-31
  }
  return bits;
}

// a step's covered points one at a time, in index order (a step with few
// of them): the lowest lane holding one broadcasts its index and class,
// and lane c, which keeps combo c, takes it into its next slot if it hits c
__device__ __forceinline__ void step_sparse(const unsigned (&w)[4], unsigned covered, int n_cov, int first_index,
                                            const unsigned* s_mask, int k, int lane, int32_t* orow,
                                            int& my_count, int& my_first) {
  for (; n_cov > 0; --n_cov) {
    const int from = __ffs(__ballot_sync(kFull, covered != 0u)) - 1;
    const int j = max(__ffs(covered) - 1, 0);
    const unsigned word = j < 8 ? (j < 4 ? w[0] : w[1]) : (j < 12 ? w[2] : w[3]);
    const int jv = __shfl_sync(kFull, (j << 8) | static_cast<int>((word >> (8 * (j & 3))) & 63), from);
    if (lane == from) covered &= covered - 1u;
    const int i = first_index + 16 * from + (jv >> 8);
    if (((s_mask[jv & 63] >> lane) & 1u) && my_count < k) {
      orow[static_cast<size_t>(lane) * k + my_count] = i;
      if (my_count == 0) my_first = i;
      ++my_count;
    }
  }
}

// a step's covered points through packed counts (see the note at the top):
// per lane and combo the hits in 16-bit fields, their scan over the lanes,
// then for each open combo the slots of its hits
__device__ __forceinline__ void step_dense(const unsigned (&w)[4], unsigned covered, int base, unsigned open,
                                           const uint2* s_tab, const uint2* s_thr, int k, int lane,
                                           int32_t* orow, int& my_count, int& my_first) {
  // 1. the lane's hits per combo: points 0-7 and 8-15 in 4-bit fields,
  // widened to 8 bits, added, widened to 16 bits
  unsigned lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  for (unsigned rest = covered; rest != 0u; rest &= rest - 1u) {
    const int j = __ffs(rest) - 1;
    const unsigned word = j < 8 ? (j < 4 ? w[0] : w[1]) : (j < 12 ? w[2] : w[3]);
    const uint2 e = s_tab[(word >> (8 * (j & 3))) & 63];
    if (j < 8) {
      lo0 += e.x;
      hi0 += e.y;
    } else {
      lo1 += e.x;
      hi1 += e.y;
    }
  }
  const unsigned c8[4] = {
      (lo0 & kNibbles) + (lo1 & kNibbles), ((lo0 >> 4) & kNibbles) + ((lo1 >> 4) & kNibbles),
      (hi0 & kNibbles) + (hi1 & kNibbles), ((hi0 >> 4) & kNibbles) + ((hi1 >> 4) & kNibbles)};
  unsigned own[8], inc[8], tot[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    own[2 * i] = c8[i] & kHalves;
    own[2 * i + 1] = (c8[i] >> 8) & kHalves;
  }

  // 2. per packed word of an open combo with a hit, the inclusive scan
  // over lanes
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    inc[v] = tot[v] = 0;
    if ((open & word_combos(v)) && __any_sync(kFull, own[v] != 0u)) {
      unsigned s = own[v];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += up;
      }
      inc[v] = s;
      tot[v] = __shfl_sync(kFull, s, 31);
    }
  }

  // 3. the slots of each open combo's hits in this step
#pragma unroll
  for (int c = 0; c < kMaxCombos; ++c) {
    if (!((open >> c) & 1u)) continue;
    constexpr int kMask = 0xffff;
    const int v = field_word(c), sh = field_shift(c);
    const int total = static_cast<int>((tot[v] >> sh) & kMask);
    if (total == 0) continue;
    const int count = __shfl_sync(kFull, my_count, c);
    const int mine = static_cast<int>((own[v] >> sh) & kMask);
    int slot = count + static_cast<int>((inc[v] >> sh) & kMask) - mine;
    unsigned hits = 0;
    if (mine > 0 && slot < k) {
      hits = hit_bits(w, s_thr[c]);
      for (unsigned rest = hits; rest != 0u && slot < k; rest &= rest - 1u, ++slot)
        orow[static_cast<size_t>(c) * k + slot] = base + __ffs(rest) - 1;
    }
    if (count == 0) {  // the combo's first hit: the lowest lane with one
      const int from = __ffs(__ballot_sync(kFull, mine > 0)) - 1;
      const int f = __shfl_sync(kFull, base + __ffs(hits) - 1, from);
      if (lane == c) my_first = f;
    }
    if (lane == c) my_count = count + total;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    select_kernel(const uint8_t* __restrict__ cls, int rows, int n, int n_r, int n_h, int k,
                  int32_t* __restrict__ out) {
  __shared__ uint2 s_tab[kClasses];    // class value -> a 4-bit field per combo (x: 0-7, y: 8-15)
  __shared__ unsigned s_mask[kClasses];  // class value -> a bit per combo
  __shared__ uint2 s_thr[kMaxCombos];  // per combo the thresholds of hit_bits
  const int n_combos = n_r * n_h;
  if (threadIdx.x < kClasses) {
    const int rc = threadIdx.x >> 3, hc = threadIdx.x & 7;
    unsigned long long e = 0;
    unsigned mask = 0;
    for (int c = 0; c < n_combos; ++c) {
      const int ri = c / n_h, hi = c - ri * n_h;
      if (rc <= ri && hc <= hi) {
        e |= 1ull << (4 * c);
        mask |= 1u << c;
      }
    }
    s_tab[threadIdx.x] = make_uint2(static_cast<unsigned>(e), static_cast<unsigned>(e >> 32));
    s_mask[threadIdx.x] = mask;
  } else if (threadIdx.x < kClasses + kMaxCombos) {
    const int c = threadIdx.x - kClasses;
    const int ri = c / n_h, hi = c - ri * n_h;
    s_thr[c] = make_uint2((ri + 1) * 8 * kEachByte, (hi + 1) * kEachByte);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const uint8_t* cr = cls + static_cast<size_t>(row) * n;
  int32_t* orow = out + static_cast<size_t>(row) * n_combos * k;
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(cr) & 15);
  const uint4* chunk = reinterpret_cast<const uint4*>(cr - lead);
  const int n_chunks = (lead + n + 15) >> 4;
  const uint4 none = make_uint4(63 * kEachByte, 63 * kEachByte, 63 * kEachByte, 63 * kEachByte);

  int my_count = 0;  // lane c < n_combos: combo c's hits so far
  int my_first = 0;  // lane c: combo c's first hit (0 without one)
  unsigned open = (1u << n_combos) - 1u;  // the combos short of k hits, warp-uniform
  uint2 cover = s_thr[n_combos - 1];  // the thresholds of the smallest combo holding every open one
  uint4 next = lane < n_chunks ? __ldg(chunk + lane) : none;
  for (int q0 = 0; q0 < n_chunks; q0 += kStepChunks) {
    const int q = q0 + lane;
    unsigned w[4] = {next.x, next.y, next.z, next.w};
    next = q + kStepChunks < n_chunks ? __ldg(chunk + q + kStepChunks) : none;
    const int base = 16 * q - lead;  // the index of the lane's first byte
    if (base < 0 || base + 16 > n) {  // the row's first or last chunk, or past it
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int i = base + b;
        const int s = 8 * (b & 3);
        if (i < 0 || i >= n) w[b >> 2] = (w[b >> 2] & ~(0xffu << s)) | (63u << s);
      }
    }
    if ((w[0] | w[1] | w[2] | w[3]) & 0xc0c0c0c0u) {  // values above 63 hit nothing: make them 63
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned big = (((w[i] & 0xc0c0c0c0u) | ((w[i] & 0x40404040u) << 1)) & kTopBits) >> 7;
        w[i] = (w[i] & ~(big * 0xffu)) | (big * 63u);
      }
    }

    // the lane's points in the cover of the open combos; a step without one
    // changes nothing, a step with few takes them one at a time
    const unsigned covered = hit_bits(w, cover);
    const int n_cov = static_cast<int>(__reduce_add_sync(kFull, __popc(covered)));
    if (n_cov == 0) continue;
    if (n_cov <= kSparse)
      step_sparse(w, covered, n_cov, 16 * q0 - lead, s_mask, k, lane, orow, my_count, my_first);
    else
      step_dense(w, covered, base, open, s_tab, s_thr, k, lane, orow, my_count, my_first);

    // 4. stop once every combo is full
    const unsigned still = __ballot_sync(kFull, lane < n_combos && my_count < k);
    if (still == 0u) break;
    if (still != open) {  // the cover shrinks: the largest radius and depth still open
      open = still;
      const uint2 thr = (open >> lane) & 1u ? s_thr[lane] : make_uint2(0u, 0u);
      cover = make_uint2(__reduce_max_sync(kFull, thr.x), __reduce_max_sync(kFull, thr.y));
    }
  }

  // padding: slots past the count repeat the first hit (0 without one)
  for (int c = 0; c < n_combos; ++c) {
    const int count = __shfl_sync(kFull, my_count, c);
    const int f = __shfl_sync(kFull, my_first, c);
    for (int slot = min(count, k) + lane; slot < k; slot += 32) orow[static_cast<size_t>(c) * k + slot] = f;
  }
}

}  // namespace

// cls: (rows, N) uint8 class values, rows contiguous from any address; out:
// (rows, n_r * n_h, k) int32, fully written. 1 <= n_r, n_h <= 7,
// n_r * n_h <= 16, k >= 1.
extern "C" int gb_select(const uint8_t* cls, int32_t* out, int rows, int n, int n_r, int n_h, int k,
                         void* stream) {
  if (rows < 1 || n < 1 || k < 1 || n_r < 1 || n_h < 1 || n_r > 7 || n_h > 7 ||
      n_r * n_h > kMaxCombos)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (static_cast<unsigned>(rows) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  select_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cls, rows, n, n_r, n_h, k, out);
  return static_cast<int>(cudaGetLastError());
}
