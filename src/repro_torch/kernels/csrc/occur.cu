// Occur histograms of a packed bit matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX reference:
//   src/repro/kernels/bitset.py: occur_from_bitset        (_occur_kernel)
//   src/repro/kernels/bitset.py: occur_from_bitset_masked (_occur_masked_kernel)
//
// occur[w*32 + b] = sum over rows r (with rowmask[r] != 0 for the masked
// form) of bit b of words[r, w].  The words arrive as int32 tensors and are
// read here as uint32; the mask as bytes (a bool tensor) or as int32.
//
// What bounds it: bytes.  The histogram reads the (B, W) matrix once
// (B*W*4 bytes; the masked form only its selected rows, plus the mask) and
// writes W*32*4 bytes.  Counting 32 bit positions one shift-and-add each
// would cost about 88 integer instructions a word, which at the card's
// 64 ALU results a clock per SM is four times the byte time; so the
// counts are kept in bit planes instead.
//
// Design.  The Pallas kernels carry one histogram tile across a sequential
// grid over row blocks.  Blocks on the GPU run in parallel and in no
// order, so here:
//   * one thread owns one word column w: a warp reads 32 neighbouring words
//     of a row (128 bytes, coalesced); grid.y splits the rows into chunks
//     of rows_per_chunk rows;
//   * a thread counts in bit planes: plane k holds bit k of the 32 counts
//     of its column.  Rows are added 16 at a time by a Harley-Seal tree of
//     15 carry-save adders (sum = a^b^c, carry = maj(a,b,c): one LOP3 each)
//     into the planes of weight 1, 2, 4 and 8; the tree's carry of weight
//     16 ripples into planes 4 .. L-1 (two LOP3 a plane, stopping at the
//     first zero carry).  That is about 2 logic instructions a word, plus
//     the ripple's 2 per plane reached every 16 words.  A count never
//     exceeds rows_per_chunk < 2^L, so L = bit_length(rows_per_chunk)
//     planes hold it (the wrapper passes L);
//   * a group's 16 rows are loaded before they are added, so a thread has
//     16 independent loads in flight;
//   * the masked form compacts the selected rows first: each warp reads a
//     window of 256 mask entries with one coalesced load a lane and a
//     ballot per 32 rows, writes the selected rows' offsets to shared
//     memory, and loads and adds only those rows, 16 to a group (zeros pad
//     the window's last group).  Rows outside the mask cost no matrix
//     bytes;
//   * at the chunk's end a readout of 32 x L bit extractions turns the
//     planes into 32 counts; the block transposes them through shared
//     memory so that each warp's atomicAdds cover 128 contiguous output
//     bytes, one atomicAdd per non-zero count.  Integer atomics give the
//     exact sum in any order, so the result is bit-identical to the plain
//     version.  The C entry point zeroes the output first, on the same
//     stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;      // word columns a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;         // rows a carry-save tree adds
constexpr int kLowPlanes = 4;      // the tree's planes of weight 1, 2, 4, 8
constexpr int kMaxPlanes = 16;     // rows_per_chunk < 2^16
constexpr int kWindow = 256;       // mask entries a warp compacts at a time
constexpr int kPad = 33;           // readout row stride (no bank conflict)

// carry-save adder: h*2 + l = a + b + c, bit by bit
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// add 16 words into the planes p (Harley-Seal)
__device__ __forceinline__ void add_group(const uint32_t (&x)[kGroup],
                                          uint32_t (&p)[kMaxPlanes]) {
  uint32_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, carry;
  csa(twos_a, p[0], p[0], x[0], x[1]);
  csa(twos_b, p[0], p[0], x[2], x[3]);
  csa(fours_a, p[1], p[1], twos_a, twos_b);
  csa(twos_a, p[0], p[0], x[4], x[5]);
  csa(twos_b, p[0], p[0], x[6], x[7]);
  csa(fours_b, p[1], p[1], twos_a, twos_b);
  csa(eights_a, p[2], p[2], fours_a, fours_b);
  csa(twos_a, p[0], p[0], x[8], x[9]);
  csa(twos_b, p[0], p[0], x[10], x[11]);
  csa(fours_a, p[1], p[1], twos_a, twos_b);
  csa(twos_a, p[0], p[0], x[12], x[13]);
  csa(twos_b, p[0], p[0], x[14], x[15]);
  csa(fours_b, p[1], p[1], twos_a, twos_b);
  csa(eights_b, p[2], p[2], fours_a, fours_b);
  csa(carry, p[3], p[3], eights_a, eights_b);
#pragma unroll
  for (int k = kLowPlanes; k < kMaxPlanes; ++k) {
    if (carry == 0u) break;
    const uint32_t t = p[k] & carry;
    p[k] ^= carry;
    carry = t;
  }
}

// counts of the 32 bit positions from L planes, into out[0..31]
template <int L>
__device__ __forceinline__ void readout(const uint32_t (&p)[kMaxPlanes],
                                        uint32_t* out) {
#pragma unroll 4
  for (int b = 0; b < 32; ++b) {
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) c |= ((p[k] >> b) & 1u) << k;
    out[b] = c;
  }
}

__device__ __forceinline__ void readout_planes(
    const uint32_t (&p)[kMaxPlanes], int planes, uint32_t* out) {
  switch (planes) {
#define OCCUR_READOUT(L) \
  case L:                \
    readout<L>(p, out);  \
    break;
    OCCUR_READOUT(1) OCCUR_READOUT(2) OCCUR_READOUT(3) OCCUR_READOUT(4)
    OCCUR_READOUT(5) OCCUR_READOUT(6) OCCUR_READOUT(7) OCCUR_READOUT(8)
    OCCUR_READOUT(9) OCCUR_READOUT(10) OCCUR_READOUT(11) OCCUR_READOUT(12)
    OCCUR_READOUT(13) OCCUR_READOUT(14) OCCUR_READOUT(15)
    default:
      readout<kMaxPlanes>(p, out);
#undef OCCUR_READOUT
  }
}

// The block's counts (kThreads columns x 32) into occur: thread t's 32
// counts go through shared memory so that a warp adds 32 neighbouring
// int32 of the output at a time.
__device__ __forceinline__ void flush(const uint32_t (&p)[kMaxPlanes],
                                      int planes, int64_t w0, int64_t cols,
                                      uint32_t* cnt_s,
                                      int32_t* __restrict__ occur) {
  readout_planes(p, planes, cnt_s + threadIdx.x * kPad);
  __syncthreads();
  for (int i = threadIdx.x; i < kThreads * 32; i += kThreads) {
    const uint32_t c = cnt_s[(i >> 5) * kPad + (i & 31)];
    if (c != 0u && w0 + (i >> 5) < cols) atomicAdd(occur + w0 * 32 + i, int32_t(c));
  }
}

__global__ void __launch_bounds__(kThreads)
occur_kernel(const uint32_t* __restrict__ words, int64_t rows, int64_t cols,
             int64_t rows_per_chunk, int planes, int32_t* __restrict__ occur) {
  __shared__ uint32_t cnt_s[kThreads * kPad];
  const int64_t w0 = int64_t(blockIdx.x) * kThreads;
  const int64_t w = w0 + threadIdx.x;
  const bool active = w < cols;
  const int64_t r0 = int64_t(blockIdx.y) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  uint32_t p[kMaxPlanes];
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) p[k] = 0u;
  const uint32_t* col = words + (active ? w : 0);
  for (int64_t r = r0; r < r1; r += kGroup) {
    uint32_t x[kGroup];
    if (r + kGroup <= r1) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) x[j] = active ? col[(r + j) * cols] : 0u;
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        x[j] = active && r + j < r1 ? col[(r + j) * cols] : 0u;
    }
    add_group(x, p);
  }
  flush(p, planes, w0, cols, cnt_s, occur);
}

template <typename MaskT>
__global__ void __launch_bounds__(kThreads)
occur_masked_kernel(const uint32_t* __restrict__ words,
                    const MaskT* __restrict__ rowmask, int64_t rows,
                    int64_t cols, int64_t rows_per_chunk, int planes,
                    int32_t* __restrict__ occur) {
  __shared__ uint32_t cnt_s[kThreads * kPad];
  __shared__ uint8_t sel_s[kWarps][kWindow];   // offsets in the window
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = int64_t(blockIdx.x) * kThreads;
  const int64_t w = w0 + threadIdx.x;
  const bool active = w < cols;
  const int64_t r0 = int64_t(blockIdx.y) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  uint8_t* sel = sel_s[warp];
  uint32_t p[kMaxPlanes];
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) p[k] = 0u;
  const uint32_t* col = words + (active ? w : 0);
  bool any = false;
  for (int64_t win = r0; win < r1; win += kWindow) {
    // the warp's compaction of this window's selected rows (the same list
    // in every warp of the block)
    int n_sel = 0;
#pragma unroll
    for (int s = 0; s < kWindow / 32; ++s) {
      const int64_t r = win + 32 * s + lane;
      const bool on = r < r1 && rowmask[r] != MaskT(0);
      const uint32_t bits = __ballot_sync(0xffffffffu, on);
      if (on) sel[n_sel + __popc(bits & ((1u << lane) - 1u))] = uint8_t(32 * s + lane);
      n_sel += __popc(bits);
    }
    __syncwarp();
    any |= n_sel > 0;
    for (int g = 0; g < n_sel; g += kGroup) {
      uint32_t x[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        x[j] = active && g + j < n_sel ? col[(win + sel[g + j]) * cols] : 0u;
      add_group(x, p);
    }
    __syncwarp();
  }
  // every warp saw the same mask: the whole block skips an empty chunk
  if (!any) return;
  flush(p, planes, w0, cols, cnt_s, occur);
}

// rows_per_chunk must be at least 1 and below 2^planes; planes at most
// kMaxPlanes; the chunks must fit the grid's y dimension
bool valid_split(int64_t rows, int64_t rows_per_chunk, int planes) {
  return rows_per_chunk >= 1 && planes >= 1 && planes <= kMaxPlanes &&
         rows_per_chunk < (int64_t(1) << planes) &&
         (rows + rows_per_chunk - 1) / rows_per_chunk <= 65535;
}

dim3 grid_of(int64_t rows, int64_t cols, int64_t rows_per_chunk) {
  return dim3(unsigned((cols + kThreads - 1) / kThreads),
              unsigned((rows + rows_per_chunk - 1) / rows_per_chunk));
}

}  // namespace

// Plain C interface for ctypes.  Each function zeroes `occur` (cols*32
// int32) on `stream` of card `device`, launches the histogram there and
// returns the cudaError_t of the two calls.  `planes` is
// bit_length(rows_per_chunk) (kernels/bitset.py::occur_planes).
extern "C" int occur_from_bitset(const void* words, int64_t rows, int64_t cols,
                                 int64_t rows_per_chunk, int planes,
                                 void* occur, int device, void* stream) {
  if (cols <= 0) return int(cudaGetLastError());
  if (rows > 0 && !valid_split(rows, rows_per_chunk, planes))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(occur, 0, size_t(cols) * 32 * 4, s);
  if (err != cudaSuccess || rows <= 0) return int(err);
  occur_kernel<<<grid_of(rows, cols, rows_per_chunk), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(words), rows, cols, rows_per_chunk, planes,
      static_cast<int32_t*>(occur));
  return int(cudaGetLastError());
}

// mask_bytes: 1 (bool) or 4 (int32) bytes a mask entry
extern "C" int occur_from_bitset_masked(const void* words, const void* rowmask,
                                        int mask_bytes, int64_t rows,
                                        int64_t cols, int64_t rows_per_chunk,
                                        int planes, void* occur, int device,
                                        void* stream) {
  if (cols <= 0) return int(cudaGetLastError());
  if ((mask_bytes != 1 && mask_bytes != 4) ||
      (rows > 0 && !valid_split(rows, rows_per_chunk, planes)))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(occur, 0, size_t(cols) * 32 * 4, s);
  if (err != cudaSuccess || rows <= 0) return int(err);
  const dim3 grid = grid_of(rows, cols, rows_per_chunk);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* out = static_cast<int32_t*>(occur);
  if (mask_bytes == 1) {
    occur_masked_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        w, static_cast<const uint8_t*>(rowmask), rows, cols, rows_per_chunk,
        planes, out);
  } else {
    occur_masked_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        w, static_cast<const int32_t*>(rowmask), rows, cols, rows_per_chunk,
        planes, out);
  }
  return int(cudaGetLastError());
}
