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
//   writes R int32; per word one OR and one popcount.  At the approximate
//   solve's shape (75,880 x 4 words, 300 sweeps a solve) a call moves 1.5 MB
//   and its time is the launch's and the host's, not the bytes'.
//   Design.  The Pallas kernel walks row blocks in a sequential grid.
//   Here, for W <= 4 (the auto sketch of eps = 0.5 has W = 4), one thread
//   owns one row: one 16-byte load at W = 4 when the words are 16-byte
//   aligned (rows are 16 bytes; scalar loads otherwise and at W < 4), cov
//   read once a thread through the cache, no shuffle and no barrier, a
//   grid of ceil(R / 256) blocks.  Wider rows keep the lane groups: L
//   lanes (the least power of two >= the row's loads, at most 32) own one
//   row, each lane strides over the row's words (16 bytes a load when W %
//   4 == 0 and the words are 16-byte aligned), neighbouring lanes on
//   neighbouring words, then the group sums with warp shuffles; cov is
//   staged in shared memory when it fits (W <= kMaxSharedCov words).

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

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

// one thread a row, W <= 4 words (kVector: W == 4, one 16-byte load)
template <bool kVector>
__global__ void union_popcount_row_kernel(const uint32_t* __restrict__ words,
                                          const uint32_t* __restrict__ cov,
                                          int64_t rows, int cols,
                                          int32_t* __restrict__ out) {
  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int cnt = 0;
  if (kVector) {
    const uint4 x = reinterpret_cast<const uint4*>(words)[r];
    cnt = __popc(x.x | __ldg(cov)) + __popc(x.y | __ldg(cov + 1)) +
          __popc(x.z | __ldg(cov + 2)) + __popc(x.w | __ldg(cov + 3));
  } else {
    const uint32_t* row = words + r * cols;
    for (int w = 0; w < cols; ++w) cnt += __popc(row[w] | __ldg(cov + w));
  }
  out[r] = cnt;
}

__device__ __forceinline__ int popc_or(uint4 x, const uint32_t* c) {
  return __popc(x.x | c[0]) + __popc(x.y | c[1]) + __popc(x.z | c[2]) +
         __popc(x.w | c[3]);
}

// a group of `lanes` lanes a row; kVector: W % 4 == 0, the lanes stride
// over 16-byte loads
template <bool kSharedCov, bool kVector>
__global__ void union_popcount_kernel(const uint32_t* __restrict__ words,
                                      const uint32_t* __restrict__ cov,
                                      int64_t rows, int64_t cols, int lanes,
                                      int32_t* __restrict__ out) {
  extern __shared__ uint4 s_cov4[];
  uint32_t* s_cov = reinterpret_cast<uint32_t*>(s_cov4);
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
      if (kVector) {
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
        for (int64_t q = sub; q < cols / 4; q += lanes) {
          if (kSharedCov) {
            const uint4 y = s_cov4[q];
            const uint32_t cy[4] = {y.x, y.y, y.z, y.w};
            cnt += popc_or(row4[q], cy);
          } else {
            cnt += popc_or(row4[q], c + 4 * q);
          }
        }
      } else {
        for (int64_t w = sub; w < cols; w += lanes) cnt += __popc(row[w] | c[w]);
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off, lanes);
    if (sub == 0 && r < rows) out[r] = cnt;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool kSharedCov>
void launch_groups(const uint32_t* w, const uint32_t* c, int64_t rows,
                   int64_t cols, bool vector, int32_t* o, cudaStream_t s) {
  const int64_t loads = vector ? cols / 4 : cols;
  int lanes = 1;
  while (lanes < 32 && lanes < loads) lanes <<= 1;
  const int64_t rows_per_block = (kUnionThreads / 32) * (32 / lanes);
  int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxUnionBlocks) blocks = kMaxUnionBlocks;
  const size_t smem = kSharedCov ? size_t(cols) * sizeof(uint32_t) : 0;
  if (vector) {
    union_popcount_kernel<kSharedCov, true>
        <<<unsigned(blocks), kUnionThreads, smem, s>>>(w, c, rows, cols,
                                                       lanes, o);
  } else {
    union_popcount_kernel<kSharedCov, false>
        <<<unsigned(blocks), kUnionThreads, smem, s>>>(w, c, rows, cols,
                                                       lanes, o);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream` of card
// `device` and returns the cudaError_t of its launch.

// `bad` must hold one zeroed int32; it is nonzero after the kernel iff some
// bucket lay outside [0, 32*cols).
extern "C" int sketch_scatter_or(void* words, const void* v,
                                 const void* bucket, int64_t pairs,
                                 int64_t rows, int64_t cols, void* bad,
                                 int device, void* stream) {
  if (pairs <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const int64_t blocks = (pairs + kScatterThreads - 1) / kScatterThreads;
  scatter_or_kernel<<<unsigned(blocks), kScatterThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<const int32_t*>(v),
      static_cast<const int32_t*>(bucket), pairs, rows, cols,
      static_cast<int32_t*>(bad));
  return int(cudaGetLastError());
}

// words: rows*cols uint32; cov: cols uint32 (any 4-byte alignment); out:
// rows int32.
extern "C" int sketch_union_popcount(const void* words, const void* cov,
                                     int64_t rows, int64_t cols, void* out,
                                     int device, void* stream) {
  if (rows <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const uint32_t* c = static_cast<const uint32_t*>(cov);
  int32_t* o = static_cast<int32_t*>(out);
  const bool vector = cols % 4 == 0 && aligned16(words);
  if (cols <= 4) {
    const unsigned blocks = unsigned((rows + kUnionThreads - 1) / kUnionThreads);
    if (cols == 4 && vector) {
      union_popcount_row_kernel<true><<<blocks, kUnionThreads, 0, s>>>(
          w, c, rows, int(cols), o);
    } else {
      union_popcount_row_kernel<false><<<blocks, kUnionThreads, 0, s>>>(
          w, c, rows, int(cols), o);
    }
  } else if (cols <= kMaxSharedCov) {
    launch_groups<true>(w, c, rows, cols, vector, o, s);
  } else {
    launch_groups<false>(w, c, rows, cols, vector, o, s);
  }
  return int(cudaGetLastError());
}
