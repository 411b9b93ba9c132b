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
// __uint2float_rn (round to nearest even, as the reference's astype and the
// plain version's int64 -> float32 cast), the scale by 2^-32 is exact, and
// the comparison is a plain `<`.  The file is built without --use_fast_math.
//
// What bounds it: operations.  Each trial moves one output byte (the
// weights are read once per block row and stay in L2), and its value takes
// 22 instructions of the compiled loop: 14 on the integer ALU (the shifts
// and xors of two finalizers, one LOP3 folding in the constant, the select),
// 5 IMADs (the counter multiply-add and 4 finalizer multiplies), the
// conversion, the scale and the compare.  At the ALU's 64 results per clock
// per SM that is almost three times the time of the bytes.  chip_smoke.py
// counts these from the SASS of the built library.
//
// Design.  The Pallas kernel runs one seed over a 1-D grid of edge blocks,
// and the reference vmaps it over the B seeds.  Here one launch covers all
// B seeds: a 2-D grid over (edge block, seed row), one thread per edge,
// one byte written per trial into a torch.bool tensor (a warp writes 32
// contiguous bytes).  grid.y strides over the rows when B exceeds the
// grid's y limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void bernoulli_kernel(const float* __restrict__ w,
                                 const int64_t* __restrict__ seeds,
                                 int64_t rows, int64_t edges,
                                 uint8_t* __restrict__ keep) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const float we = w[e];
  const uint32_t ctr = uint32_t(e) * kGolden;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t seed = uint32_t(seeds[r]);
    const uint32_t h = fmix32(fmix32(ctr + seed) ^ kGolden);
    const float u01 = __uint2float_rn(h) * 0x1p-32f;
    keep[r * edges + e] = uint8_t(u01 < we);
  }
}

}  // namespace

// Plain C interface for ctypes.  w: `edges` float32; seeds: `rows` int64;
// keep: rows*edges bytes.  Launches on `stream`; returns the cudaError_t
// of the launch.
extern "C" int bernoulli_edges(const void* w, const void* seeds, int64_t rows,
                               int64_t edges, void* keep, void* stream) {
  if (rows <= 0 || edges <= 0) return int(cudaGetLastError());
  dim3 grid(unsigned((edges + kThreads - 1) / kThreads),
            unsigned(rows < kMaxGridY ? rows : kMaxGridY));
  bernoulli_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int64_t*>(seeds), rows,
      edges, static_cast<uint8_t*>(keep));
  return int(cudaGetLastError());
}
