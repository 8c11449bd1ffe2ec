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
// What bounds it on the H100: instruction issue. The plane is one byte per
// point (82 MB at the fused eval forward's 4 x 1024 rows of 20,000 points);
// every row is scanned until all combos hold k hits, which for the smallest
// cylinder usually means the whole row, at ~2 + 3 x 16 integer operations
// per point.
//
// Design: one warp per row, eight rows per block, as the cylinder query's
// kernel (multicyl.cu) walks its seeds: the warp reads 32 consecutive class
// bytes at a time, decodes rc and hc once, and for each combo __ballot_sync
// + __popc give every hitting lane its slot. The per-combo counts and first
// hits are warp-uniform registers; the walk stops once every combo is full.
// The TPU kernel's slot-tile one-hot matmuls and log-shift scans were TPU
// workarounds: here the lane that owns a hit writes it directly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCombos = 16;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    select_kernel(const uint8_t* __restrict__ cls, int rows, int n, int n_r, int n_h, int k,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int n_combos = n_r * n_h;
  const uint8_t* cr = cls + static_cast<size_t>(row) * n;
  int32_t* orow = out + static_cast<size_t>(row) * n_combos * k;

  int count[kMaxCombos];
  int first[kMaxCombos];
#pragma unroll
  for (int c = 0; c < kMaxCombos; ++c) count[c] = first[c] = 0;

  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int v = i < n ? __ldg(cr + i) : 63;
    const int rc = v >> 3, hc = v & 7;
    bool all_full = true;
#pragma unroll
    for (int c = 0; c < kMaxCombos; ++c) {
      if (c < n_combos && count[c] < k) {
        const int ri = c / n_h, hi = c - ri * n_h;
        const bool hit = rc <= ri && hc <= hi;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (count[c] == 0 && mask != 0u) first[c] = base + __ffs(mask) - 1;
        if (hit) {
          const int slot = count[c] + __popc(mask & ((1u << lane) - 1u));
          if (slot < k) orow[c * k + slot] = i;
        }
        count[c] += __popc(mask);
        all_full = all_full && count[c] >= k;
      }
    }
    if (all_full) break;  // counts are warp-uniform, so is the break
  }

  // padding: slots past the count repeat the first hit (0 without one)
#pragma unroll
  for (int c = 0; c < kMaxCombos; ++c) {
    if (c < n_combos) {
      for (int slot = min(count[c], k) + lane; slot < k; slot += 32) orow[c * k + slot] = first[c];
    }
  }
}

}  // namespace

// cls: (rows, N) uint8 class values; out: (rows, n_r * n_h, k) int32, fully
// written. 1 <= n_r, n_h <= 7, n_r * n_h <= 16, k >= 1.
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
