// Coverage-sketch kernels of the approximate (pool-free) mode, for Hopper
// (sm_90a).
//
// Replace the TPU kernels of the JAX reference:
//   src/repro/kernels/sketch.py: sketch_scatter_or     (_scatter_or_kernel)
//   src/repro/kernels/sketch.py: sketch_union_popcount (_union_popcount_kernel)
// sketch_fold_rows is sketch_scatter_or's counterpart on its path: the
// reference's fold of a padded batch (src/repro/core/sketch.py:107
// fold_batch_packed, :163 fold_frontier_packed) builds the (node, bucket)
// pairs in XLA and scatters them with that kernel; here one launch does
// both, on the sampler's batch as it lies.
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
// sketch_fold_rows: for every row i with lens[i] > 0 and every lane j <
//   min(lens[i], W) of the (B, W) batch `nodes`, words[nodes[i, j],
//   b_i >> 5] |= 1 << (b_i & 31), b_i = bucket_of(row_base + rank_i), where
//   rank_i is the number of non-empty rows before row i; row ids wrap at
//   2^32, and "mix" multiplies by 2654435761 mod 2^32 before the modulo by
//   k (1 <= k <= 32 x cols, so a bucket is always in range).  Nodes
//   outside [0, R) are dropped.  Given `counts`, the batch's valid lanes
//   and non-empty rows go to counts[0] and counts[1] (int64).
//   What bounds it: bytes.  It reads the lengths and the valid lanes once
//   and read-modify-writes one 32-byte sector per distinct word sector
//   that the in-range lanes touch; one OR per lane.  At the approximate
//   cell a batch is 512 rows and ~2,000 lanes: the kernel's bytes take
//   well under a microsecond, and the launch, with what surrounded it
//   before, is the time.
//   Design.  The pair form (frontier_pairs + sketch_scatter_or) took about
//   a dozen PyTorch operations a fold to build and copy the flat pairs, a
//   copy of the sampler's strided queue view among them, and a torch
//   cumsum for the ranks.  Here a block of kFoldThreads owns as many
//   consecutive rows, one thread a row for its length and bucket:
//   - the ranks: each block counts the non-empty rows (and valid lanes)
//     before its own by reading the lengths ahead of it (B int32, from
//     L2), then scans its rows' flags and lengths, so no second launch
//     and no torch cumsum;
//   - the lanes: the block's valid lanes are laid end to end by that scan
//     and its threads walk them together (a position's row by a binary
//     search over the block's offsets in shared memory), so neighbouring
//     threads load neighbouring lanes of a row, with the row's word index
//     and bit from shared memory; a warp a row would leave 28 of 32 lanes
//     idle at the mean RR size of ~4 and serialise a block's rows;
//   - nodes are read through the row stride the caller gives, so the
//     sampler's (B, qcap) queue is read in place, not copied to (B, W);
//   - the last block has read every length before its own, so it writes
//     the batch's totals, with no atomics and no memset.
//   Hub nodes (ids 0-4 of the stand-in) sit in most rows, so a hub's few
//   words take one atomicOr from each of those rows; chip_smoke.py
//   measures that against the same batch with uniform node ids
//   (fold_hub_probe) before any aggregation is added.
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
constexpr int kFoldThreads = 128;      // threads and rows of a fold block
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr uint32_t kMixMultiplier = 2654435761u;
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

// The block's exclusive sum of its threads' x (.x) and the block's total
// (.y), in every thread.
__device__ __forceinline__ longlong2 fold_block_scan(int64_t x,
                                                     int64_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int64_t before = 0, total = 0;
  for (int w = 0; w < kFoldWarps; ++w) {
    before += w < warp ? part[w] : 0;
    total += part[w];
  }
  __syncthreads();
  return make_longlong2(before + incl - x, total);
}

__global__ void __launch_bounds__(kFoldThreads)
fold_rows_kernel(uint32_t* __restrict__ words,
                 const int32_t* __restrict__ nodes, int64_t row_stride,
                 const int32_t* __restrict__ lens, int64_t batch,
                 int64_t width, int64_t rows, int64_t cols,
                 uint32_t row_base, uint32_t k, bool mix,
                 int64_t* __restrict__ counts) {
  __shared__ int64_t part[kFoldWarps];
  __shared__ int64_t s_off[kFoldThreads + 1];
  __shared__ uint32_t s_word[kFoldThreads], s_bit[kFoldThreads];
  const int t = threadIdx.x;
  const int64_t r0 = int64_t(blockIdx.x) * kFoldThreads;
  // the non-empty rows and valid lanes before this block's rows
  int64_t rows_before = 0, lanes_before = 0;
  for (int64_t i = t; i < r0; i += kFoldThreads) {
    int64_t l = __ldg(lens + i);
    l = l < 0 ? 0 : (l > width ? width : l);
    rows_before += l > 0;
    lanes_before += l;
  }
  // this thread's row: its length, then both scans (a row's flag in the
  // low 8 bits: at most kFoldThreads of them)
  const int64_t i = r0 + t;
  int64_t len = i < batch ? int64_t(__ldg(lens + i)) : 0;
  len = len < 0 ? 0 : (len > width ? width : len);
  const longlong2 sum_rows = fold_block_scan(rows_before, part);
  const longlong2 sum_lanes = fold_block_scan(lanes_before, part);
  const longlong2 mine = fold_block_scan((len << 8) | (len > 0), part);
  const int64_t rows_ahead = sum_rows.y, lanes_ahead = sum_lanes.y;
  uint32_t h = row_base + uint32_t(rows_ahead) + uint32_t(mine.x & 0xFF);
  if (mix) h *= kMixMultiplier;
  const uint32_t b = h % k;
  s_word[t] = b >> 5;
  s_bit[t] = 1u << (b & 31);
  s_off[t] = mine.x >> 8;
  if (t == kFoldThreads - 1) s_off[kFoldThreads] = mine.y >> 8;
  __syncthreads();
  const int64_t total = s_off[kFoldThreads];
  if (counts != nullptr && t == 0 && blockIdx.x == gridDim.x - 1) {
    counts[0] = lanes_ahead + total;
    counts[1] = rows_ahead + (mine.y & 0xFF);
  }
  for (int64_t p = t; p < total; p += kFoldThreads) {
    int row = 0;                       // the last row whose offset <= p
    for (int half = kFoldThreads / 2; half > 0; half >>= 1)
      if (s_off[row + half] <= p) row += half;
    const int64_t j = p - s_off[row];
    const uint32_t v = uint32_t(__ldg(nodes + (r0 + row) * row_stride + j));
    if (v < uint64_t(rows))
      atomicOr(words + int64_t(v) * cols + s_word[row], s_bit[row]);
  }
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

// nodes: (batch, width) int32 at `row_stride` elements a row, lanes
// contiguous; lens: batch int32 (clamped to [0, width] here); words: rows
// x cols uint32, changed in place; row_base: the first row id mod 2^32;
// 1 <= k <= 32 x cols; mix: 0 ("mod") or 1 ("mix"); counts: 2 int64 or
// null.
extern "C" int sketch_fold_rows(void* words, const void* nodes,
                                int64_t row_stride, const void* lens,
                                int64_t batch, int64_t width, int64_t rows,
                                int64_t cols, uint32_t row_base, uint32_t k,
                                int mix, void* counts, int device,
                                void* stream) {
  if (batch <= 0 || k < 1 || int64_t(k) > 32 * cols)
    return int(batch == 0 ? cudaGetLastError() : cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const int64_t blocks = (batch + kFoldThreads - 1) / kFoldThreads;
  fold_rows_kernel<<<unsigned(blocks), kFoldThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<const int32_t*>(nodes),
      row_stride, static_cast<const int32_t*>(lens), batch, width, rows,
      cols, row_base, k, mix != 0, static_cast<int64_t*>(counts));
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
