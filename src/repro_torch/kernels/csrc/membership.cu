// RR-set membership scan of the padded-store greedy, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference:
//   src/repro/kernels/membership.py: membership_rows (_membership_kernel)
//
// membership_rows: hit[r] = any(rows[r, :len_r] == *u), with len_r =
//   lengths[r] clamped to [0, L].  rows is (R, L) int32, padded past each
//   length (with n in the store); lanes at or past len_r are never read, so
//   the result does not depend on what the padding holds.
//   What bounds it: bytes.  It must read the 32-byte sectors of each row's
//   valid prefix, the lengths, and write R bytes; one compare per element
//   read.  The padded matrix is far larger: mean RR size is about 4 on the
//   exact cell, so a row of L >= 128 lanes is over 96% padding.
//   Design.  The Pallas kernel compares a whole (BR, L) tile, padding and
//   all, because the TPU wants rectangular blocks.  Here a group of 8 lanes
//   owns one row (8 int32 = one 32-byte sector a step) and walks only
//   [0, len_r); a warp scans 4 rows at once, and one ballot per warp
//   gathers the 4 answers.  u is read from device memory (the counterpart
//   of the TPU kernel's SMEM scalar), so a caller whose u comes from an
//   argmax on the card needs no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                     // lanes per row
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void membership_kernel(const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ u,
                                  int64_t n_rows, int64_t row_len,
                                  uint8_t* __restrict__ hit) {
  const int32_t target = *u;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kGroup - 1);
  const int grp = lane / kGroup;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  // every lane of a warp runs the same number of iterations, so the
  // full-mask ballot below always sees the whole warp
  for (int64_t base = warp * kRowsPerWarp; base < n_rows;
       base += n_warps * kRowsPerWarp) {
    const int64_t r = base + grp;
    bool found = false;
    if (r < n_rows) {
      int64_t len = lengths[r];
      len = len < 0 ? 0 : (len > row_len ? row_len : len);
      const int32_t* row = rows + r * row_len;
      for (int64_t i = sub; i < len && !found; i += kGroup)
        found = row[i] == target;
    }
    const unsigned votes = __ballot_sync(0xffffffffu, found);
    if (sub == 0 && r < n_rows)
      hit[r] = ((votes >> (grp * kGroup)) & ((1u << kGroup) - 1)) != 0;
  }
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launch.
// u points at one int32 on the card.
extern "C" int membership_rows(const void* rows, const void* lengths,
                               const void* u, int64_t n_rows, int64_t row_len,
                               void* hit, void* stream) {
  if (n_rows <= 0) return int(cudaGetLastError());
  const int64_t rows_per_block = (kThreads / 32) * kRowsPerWarp;
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  membership_kernel<<<unsigned(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(u), n_rows, row_len,
      static_cast<uint8_t*>(hit));
  return int(cudaGetLastError());
}
