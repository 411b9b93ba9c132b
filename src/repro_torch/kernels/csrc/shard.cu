// The sharded pool's flat selection for Hopper (sm_90a): occur_flat, the
// local Occur histogram of a rank's shard, and shard_flat_step, one seed
// step of the sharded fused scan on that shard.  The ranks' partial
// vectors are summed by one all_reduce a step outside the kernel
// (core/coverage.py::_sharded_flat), and the next seed is the argmax of
// the summed Occur, taken on the card, so a step reads nothing back.
//
// Replaces no Pallas kernel.  The JAX reference runs the sharded fused scan
// as XLA inside shard_map (src/repro/core/coverage.py:1359, fused): the
// Occur scatter-add at :1374 (and occur at :1443) is occur_flat, and the
// body of one scan step at :1379-1391 (the membership pass, the Covered OR,
// the popcount of the new words and the decrement scatter-add) is
// shard_flat_step.  The plain versions are kernels/ref.py::occur_flat_ref
// and shard_flat_step_ref.
//
// Inputs: a shard's live extent as the store holds it, flat (node ids),
// ids (row ids) and valid (a byte an element); an element counts when it
// is valid, its row lies in [0, rows) and its node in [0, n).
//
// occur_flat: out[v] = the valid elements of node v, v in [0, n).  The
//   entry point zeroes out (one memset) and launches the kernel.
//   Design.  One thread an element, grid-stride, one atomicAdd of global
//   memory a counted element.  Bound: bytes, the node id and valid byte of
//   every element read once and the n counts written once.
//
// shard_flat_step: with u = *u_ptr (the seed, the int64 argmax of the
//   summed Occur, read on the card), the rows that hold u and are not in
//   cov are ORed into cov in place; dec[n] = the number of them, and
//   dec[v] (v < n) = the valid elements of node v in those rows.  The entry
//   point zeroes dec (one memset) and launches the kernel once.
//   Contract: the rows of the shard lie in flat as contiguous runs of equal
//   ids (the store appends a row's elements together), so a row's elements
//   are the run around any one of them.
//   Design.  One thread an element, grid-stride, the loop's trip count the
//   same for every lane of a warp.  A lane whose element holds u flips its
//   row's bit in cov with atomicOr; where the bit was 0 the row is new (a
//   row that holds u twice flips once).  The warp adds its flips to dec[n]
//   (a ballot) and then walks each new row of its ballot together: the
//   run's elements on either side of the flipping one, 32 at a time, until
//   a lane leaves the run, each valid element one atomicAdd of dec.  So the
//   Covered bits and the decrement take one pass and one launch.
//   Bound: bytes, the node ids of the shard read once (4 bytes an
//   element), the row id, valid byte and node id of each element of the new
//   rows (9 bytes), and dec written once (4 (n + 1) bytes, the memset).

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr unsigned kFull = 0xffffffffu;

unsigned grid_of(int64_t t) {
  int64_t blocks = (t + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return unsigned(blocks < 1 ? 1 : blocks);
}

__global__ void __launch_bounds__(kThreads)
occur_flat_kernel(const int32_t* __restrict__ flat,
                  const uint8_t* __restrict__ valid, int64_t t, int32_t n,
                  int32_t* __restrict__ out) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < t;
       e += stride) {
    if (!valid[e]) continue;
    const int32_t v = flat[e];
    if (v >= 0 && v < n) atomicAdd(out + v, 1);
  }
}

// One element of a new row's run: its valid node's decrement.
__device__ __forceinline__ void take(const int32_t* flat,
                                     const uint8_t* valid, int64_t p,
                                     int32_t n, int32_t* dec) {
  if (!valid[p]) return;
  const int32_t v = flat[p];
  if (v >= 0 && v < n) atomicAdd(dec + v, 1);
}

__global__ void __launch_bounds__(kThreads)
shard_flat_step_kernel(const int32_t* __restrict__ flat,
                       const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ valid, int64_t t,
                       uint32_t* __restrict__ cov, int64_t rows,
                       const int64_t* __restrict__ u_ptr, int32_t n,
                       int32_t* __restrict__ dec) {
  const int64_t u = *u_ptr;
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  // every lane of a warp runs the same trips, so the ballots see them all
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < t;
       base += stride) {
    const int64_t e = base + threadIdx.x;
    bool flipped = false;
    int32_t r = 0;
    if (e < t && flat[e] == u && valid[e]) {
      r = ids[e];
      if (r >= 0 && r < rows) {
        const uint32_t bit = 1u << (r & 31);
        flipped = !(atomicOr(cov + (r >> 5), bit) & bit);
      }
    }
    unsigned votes = __ballot_sync(kFull, flipped);
    if (lane == 0 && votes) atomicAdd(dec + n, __popc(votes));
    while (votes) {
      const int src = __ffs(votes) - 1;
      votes &= votes - 1;
      const int64_t e0 = __shfl_sync(kFull, e, src);
      const int32_t r0 = __shfl_sync(kFull, r, src);
      // the run from e0 up, then the run below e0: a lane past the run
      // ends the walk, since the run's positions are a prefix of each
      // 32-wide window
      for (int64_t p = e0 + lane;; p += 32) {
        const bool in = p < t && ids[p] == r0;
        if (in) take(flat, valid, p, n, dec);
        if (__ballot_sync(kFull, in) != kFull) break;
      }
      for (int64_t p = e0 - 1 - lane;; p -= 32) {
        const bool in = p >= 0 && ids[p] == r0;
        if (in) take(flat, valid, p, n, dec);
        if (__ballot_sync(kFull, in) != kFull) break;
      }
    }
  }
}

}  // namespace

// flat: t int32; valid: t bytes (0 or 1); 0 <= t < 2^62, n >= 1; out: n
// int32 (zeroed here).  Launches on `stream` of card `device`; returns the
// cudaError_t of the launch.
extern "C" int occur_flat(const void* flat, const void* valid, int64_t t,
                          int32_t n, void* out, int device, void* stream) {
  if (n < 1 || t < 0) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * size_t(n), s);
  if (err != cudaSuccess) return int(err);
  occur_flat_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const uint8_t*>(valid),
      t, n, static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}

// flat, ids: t int32, rows contiguous runs of equal ids; valid: t bytes;
// cov: cov_words uint32 (rows = 32 cov_words, updated in place); u_ptr: one
// int64 on the card; n >= 1; dec: n + 1 int32 (zeroed here).  Launches on
// `stream` of card `device`; returns the cudaError_t of the launch.
extern "C" int shard_flat_step(const void* flat, const void* ids,
                               const void* valid, int64_t t, void* cov,
                               int64_t cov_words, const void* u_ptr,
                               int32_t n, void* dec, int device,
                               void* stream) {
  if (n < 1 || t < 0 || cov_words < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(dec, 0, sizeof(int32_t) * (size_t(n) + 1), s);
  if (err != cudaSuccess) return int(err);
  shard_flat_step_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), t, static_cast<uint32_t*>(cov),
      cov_words * 32, static_cast<const int64_t*>(u_ptr), n,
      static_cast<int32_t*>(dec));
  return int(cudaGetLastError());
}
