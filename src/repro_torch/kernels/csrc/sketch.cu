// Coverage-sketch kernels of the approximate (pool-free) mode, for Hopper
// (sm_90a).
//
// Replace the TPU kernels of the JAX reference:
//   src/repro/kernels/sketch.py: sketch_scatter_or     (_scatter_or_kernel)
//   src/repro/kernels/sketch.py: sketch_union_popcount (_union_popcount_kernel)
//
// Packed words arrive as int32 tensors and are read and written here as
// uint32: bit b of word w of row r is bucket w*32 + b of node r's sketch.
//
// sketch_scatter_or: words[v[e], bucket[e] >> 5] |= 1 << (bucket[e] & 31).
//   Pairs with v outside [0, R) are dropped; a bucket outside [0, 32W)
//   sets *bad and is skipped (the wrapper raises on it).
//   What bounds it: bytes.  It reads 8 bytes per pair and read-modify-writes
//   one 32-byte sector per distinct word sector it touches; it does one
//   atomic per pair and no arithmetic worth counting.
//   Design.  The Pallas kernel is a serial read-modify-write loop, because
//   one block owns the whole matrix.  Here one thread owns one pair and
//   commits it with atomicOr on the word.  OR is idempotent and
//   commutative, so the result is exact in any order and duplicates need
//   no dedup (the plain version dedups only because torch has no
//   OR-scatter).  The update is in place on the caller's words.
//
// sketch_union_popcount: out[r] = sum_w popcount(words[r, w] | cov[w]).
//   What bounds it: bytes.  It reads the (R, W) matrix once, cov once and
//   writes R int32; per word one OR and one popcount.
//   Design.  The Pallas kernel walks row blocks in a sequential grid.  Here
//   a group of L lanes (L = the least power of two >= W, at most 32) owns
//   one row: each lane strides over the row's words, neighbouring lanes on
//   neighbouring words, then the group sums with warp shuffles.  A warp
//   thus scores 32 / L rows at once, so a narrow sketch (W = 4 at the auto
//   sketch size of eps = 0.5) keeps every lane busy.  cov is staged in
//   shared memory when it fits (W <= kMaxSharedCov words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScatterThreads = 256;
constexpr int kUnionThreads = 256;
constexpr int kMaxSharedCov = 12288;   // 48 KB of uint32, the static limit
constexpr int64_t kMaxUnionBlocks = 132 * 8;

__global__ void scatter_or_kernel(uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ v,
                                  const int32_t* __restrict__ bucket,
                                  int64_t pairs, int64_t rows, int64_t cols,
                                  int32_t* __restrict__ bad) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const int64_t b = bucket[e];
  if (b < 0 || b >= cols * 32) {
    atomicOr(reinterpret_cast<unsigned int*>(bad), 1u);
    return;
  }
  const int64_t r = v[e];
  if (r < 0 || r >= rows) return;
  atomicOr(words + r * cols + (b >> 5), 1u << (b & 31));
}

template <bool kSharedCov>
__global__ void union_popcount_kernel(const uint32_t* __restrict__ words,
                                      const uint32_t* __restrict__ cov,
                                      int64_t rows, int64_t cols, int lanes,
                                      int32_t* __restrict__ out) {
  extern __shared__ uint32_t s_cov[];
  if (kSharedCov) {
    for (int64_t w = threadIdx.x; w < cols; w += blockDim.x) s_cov[w] = cov[w];
    __syncthreads();
  }
  const uint32_t* c = kSharedCov ? s_cov : cov;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);          // lane within the row group
  const int rows_per_warp = 32 / lanes;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  // every lane of a warp runs the same number of iterations, so the
  // full-mask shuffles below always see the whole warp
  for (int64_t base = warp * rows_per_warp; base < rows;
       base += n_warps * rows_per_warp) {
    const int64_t r = base + lane / lanes;
    int cnt = 0;
    if (r < rows) {
      const uint32_t* row = words + r * cols;
      for (int64_t w = sub; w < cols; w += lanes) cnt += __popc(row[w] | c[w]);
    }
    for (int off = lanes >> 1; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off, lanes);
    if (sub == 0 && r < rows) out[r] = cnt;
  }
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of its launch.

// `bad` must hold one zeroed int32; it is nonzero after the kernel iff some
// bucket lay outside [0, 32*cols).
extern "C" int sketch_scatter_or(void* words, const void* v,
                                 const void* bucket, int64_t pairs,
                                 int64_t rows, int64_t cols, void* bad,
                                 void* stream) {
  if (pairs <= 0) return int(cudaGetLastError());
  const int64_t blocks = (pairs + kScatterThreads - 1) / kScatterThreads;
  scatter_or_kernel<<<unsigned(blocks), kScatterThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<const int32_t*>(v),
      static_cast<const int32_t*>(bucket), pairs, rows, cols,
      static_cast<int32_t*>(bad));
  return int(cudaGetLastError());
}

extern "C" int sketch_union_popcount(const void* words, const void* cov,
                                     int64_t rows, int64_t cols, void* out,
                                     void* stream) {
  if (rows <= 0) return int(cudaGetLastError());
  int lanes = 1;
  while (lanes < 32 && lanes < cols) lanes <<= 1;
  const int64_t rows_per_block = (kUnionThreads / 32) * (32 / lanes);
  int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxUnionBlocks) blocks = kMaxUnionBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const uint32_t* c = static_cast<const uint32_t*>(cov);
  int32_t* o = static_cast<int32_t*>(out);
  if (cols <= kMaxSharedCov) {
    union_popcount_kernel<true><<<unsigned(blocks), kUnionThreads,
                                   size_t(cols) * sizeof(uint32_t), s>>>(
        w, c, rows, cols, lanes, o);
  } else {
    union_popcount_kernel<false><<<unsigned(blocks), kUnionThreads, 0, s>>>(
        w, c, rows, cols, lanes, o);
  }
  return int(cudaGetLastError());
}
