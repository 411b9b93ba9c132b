// Counter-hash Bernoulli edge trials, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference:
//   src/repro/kernels/bernoulli.py: bernoulli_edges (_bernoulli_kernel),
//   vmapped over a vector of seeds as src/repro/core/dense.py calls it.
//
// keep[b, e] = float32(h) * 2^-32 < w[e], with
//   h = fmix32(fmix32(e * 0x9E3779B9 + seed_b) ^ 0x9E3779B9)  (all uint32),
// the murmur3 finalizer applied twice.  seed_b is seeds[b] mod 2^32 (the
// seeds arrive as int64), e is the edge index.  The conversion is
// round-to-nearest-even (the reference's astype and the plain version's
// int64 -> float32 cast) and the scale by 2^-32 is exact, so u(h) =
// float32(h) * 2^-32 is non-decreasing in h and the h that keep edge e form
// a prefix [0, t_e) of [0, 2^32].  The kernel computes t_e once per edge
// (trial_limit in counter_hash.cuh, the formula of
// kernels/ref.py::trial_threshold_ref) and each trial ends in one integer
// compare: no conversion, no float multiply, no float compare.  The file is
// built without --use_fast_math, so denormal weights are not flushed.
//
// What bounds it: operations.  A trial moves one output byte (the weights
// are read once a block and the seeds once a row), and its value takes the
// two finalizers' 6 shifts and 7 xors, the compare, the predicated add that
// packs it and a quarter of the live-edge mask on the integer ALU (15.5),
// and the counter and 4 finalizer multiplies on the IMAD pipe, both at 64
// results per clock per SM: almost three times the time of the bytes.
// chip_smoke.py counts them from the SASS of the built library.  (Shifts
// written as __umulhi, to move them onto the IMAD pipe, measured slower:
// IMAD.HI does not issue at the full rate.)
//
// Design.  The Pallas kernel runs one seed over a 1-D grid of edge blocks,
// and the reference vmaps it over the B seeds.  Here one launch covers all
// B seeds.  A thread owns kGroups groups of 4 consecutive edges (the groups
// a block's width apart, so a warp's store covers 128 contiguous bytes),
// loads their weights once, forms e * 0x9E3779B9 and t_e once, and walks
// the rows blockIdx.y, blockIdx.y + gridDim.y, ...: per row and group one
// seed (a uniform load), four hashes, four compares packed into one 32-bit
// store.  The grid's y extent is sized for a few waves of blocks, so each
// thread makes tens to hundreds of trials and its setup is paid once.
// Rows start at r*E bytes: the word stores need E % 4 == 0 and a 4-byte
// aligned output (E = 607,012 on the epinions-like graph); otherwise the
// same loop stores bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                      // groups of 4 edges a thread
constexpr int64_t kEdgesPerBlock = int64_t(kThreads) * 4 * kGroups;
constexpr int64_t kTargetBlocks = 132 * 32;     // about 4 waves at 8 an SM
constexpr int64_t kMaxGridY = 65535;

// kWords: E % 4 == 0 and keep 4-byte aligned, one uint32 store a group and
// row; else one byte store a trial.
template <bool kWords>
__global__ void __launch_bounds__(kThreads)
bernoulli_kernel(const float* __restrict__ w,
                 const int64_t* __restrict__ seeds, int64_t rows,
                 int64_t edges, uint8_t* __restrict__ keep) {
  uint32_t ctr[kGroups][4], limit[kGroups][4], live[kGroups];
  int64_t first[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    first[g] = int64_t(blockIdx.x) * kEdgesPerBlock +
               int64_t(g) * kThreads * 4 + 4 * threadIdx.x;
    live[g] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = first[g] + j;
      ctr[g][j] = uint32_t(e) * kGolden;
      limit[g][j] = 0;
      if (e < edges && trial_limit(w[e], &limit[g][j])) live[g] |= 1u << (8 * j);
    }
  }
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t seed = uint32_t(seeds[r]);
    uint8_t* row = keep + r * edges;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t h = fmix32(fmix32(ctr[g][j] + seed) ^ kGolden);
        if (h <= limit[g][j]) word += 1u << (8 * j);   // a predicated add
      }
      word &= live[g];
      if (kWords) {
        if (first[g] < edges)
          *reinterpret_cast<uint32_t*>(row + first[g]) = word;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (first[g] + j < edges) row[first[g] + j] = uint8_t(word >> (8 * j));
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  w: `edges` float32 (edges < 2^32); seeds:
// `rows` int64; keep: rows*edges bytes.  Launches on `stream` of card
// `device`; returns the cudaError_t of the launch.
extern "C" int bernoulli_edges(const void* w, const void* seeds, int64_t rows,
                               int64_t edges, void* keep, int device,
                               void* stream) {
  if (rows <= 0 || edges <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const int64_t blocks_x = (edges + kEdgesPerBlock - 1) / kEdgesPerBlock;
  int64_t blocks_y = kTargetBlocks / blocks_x;
  if (blocks_y < 1) blocks_y = 1;
  if (blocks_y > rows) blocks_y = rows;
  if (blocks_y > kMaxGridY) blocks_y = kMaxGridY;
  const dim3 grid{unsigned(blocks_x), unsigned(blocks_y)};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* sd = static_cast<const int64_t*>(seeds);
  auto* out = static_cast<uint8_t*>(keep);
  if (edges % 4 == 0 && (reinterpret_cast<uintptr_t>(keep) & 3u) == 0) {
    bernoulli_kernel<true><<<grid, kThreads, 0, s>>>(wf, sd, rows, edges, out);
  } else {
    bernoulli_kernel<false><<<grid, kThreads, 0, s>>>(wf, sd, rows, edges, out);
  }
  return int(cudaGetLastError());
}
