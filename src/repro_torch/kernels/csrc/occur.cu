// Occur histograms of a packed bit matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX reference:
//   src/repro/kernels/bitset.py: occur_from_bitset        (_occur_kernel)
//   src/repro/kernels/bitset.py: occur_from_bitset_masked (_occur_masked_kernel)
//
// occur[w*32 + b] = sum over rows r (with rowmask[r] != 0 for the masked
// form) of bit b of words[r, w].  The words arrive as int32 tensors and are
// read here as uint32.
//
// What bounds it: bytes.  The histogram reads the (B, W) matrix once
// (B*W*4 bytes; the masked form only its selected rows plus B*4 bytes of
// mask) and writes W*32*4 bytes.  Per word it does 32 shift-and-add steps,
// about 16 integer operations per byte read, which the card's integer
// units absorb at memory speed.
//
// Design.  The Pallas kernels carry one histogram tile across a sequential
// grid over row blocks.  Blocks on the GPU run in parallel and in no
// order, so here:
//   * one thread owns one word column w: a warp reads 32 neighbouring words
//     of a row (128 bytes, coalesced);
//   * grid.y splits the rows into chunks; a thread walks its chunk with 32
//     per-bit counters in registers;
//   * each thread ends with one atomicAdd per non-zero counter.  Integer
//     atomics give the exact sum in any order, so the result is
//     bit-identical to the plain version.
// The masked form tests the mask before the load, so rows outside the mask
// cost no matrix bytes (the mask test is uniform across a block: every
// thread of a block walks the same rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kMasked>
__global__ void occur_kernel(const uint32_t* __restrict__ words,
                             const int32_t* __restrict__ rowmask,
                             int64_t rows, int64_t cols, int64_t rows_per_chunk,
                             int32_t* __restrict__ occur) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= cols) return;
  const int64_t r0 = int64_t(blockIdx.y) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  int32_t cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
  for (int64_t r = r0; r < r1; ++r) {
    if (kMasked && rowmask[r] == 0) continue;
    const uint32_t x = words[r * cols + w];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] += int32_t((x >> b) & 1u);
  }
  int32_t* out = occur + w * 32;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (cnt[b] != 0) atomicAdd(out + b, cnt[b]);
  }
}

constexpr int kThreads = 128;

template <bool kMasked>
int launch(const void* words, const void* rowmask, int64_t rows, int64_t cols,
           int64_t rows_per_chunk, void* occur, void* stream) {
  if (rows <= 0 || cols <= 0) return int(cudaGetLastError());
  const int64_t chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  dim3 grid(unsigned((cols + kThreads - 1) / kThreads), unsigned(chunks));
  occur_kernel<kMasked><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(rowmask), rows, cols, rows_per_chunk,
      static_cast<int32_t*>(occur));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  `occur` must hold cols*32 zeroed int32;
// the kernel adds into it.  Returns the cudaError_t of the launch.
extern "C" int occur_from_bitset(const void* words, int64_t rows, int64_t cols,
                                 int64_t rows_per_chunk, void* occur,
                                 void* stream) {
  return launch<false>(words, nullptr, rows, cols, rows_per_chunk, occur,
                       stream);
}

extern "C" int occur_from_bitset_masked(const void* words, const void* rowmask,
                                        int64_t rows, int64_t cols,
                                        int64_t rows_per_chunk, void* occur,
                                        void* stream) {
  return launch<true>(words, rowmask, rows, cols, rows_per_chunk, occur,
                      stream);
}
