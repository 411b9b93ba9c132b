// Bit-packed set kernels of the dense-frontier sampler, for Hopper (sm_90a).
//
// Replace the TPU kernels of the JAX reference:
//   src/repro/kernels/bitset.py: pack_bits       (_pack_kernel)
//   src/repro/kernels/bitset.py: bitset_or       (_or_kernel, _binary_op)
//   src/repro/kernels/bitset.py: bitset_andnot   (_andnot_kernel, _binary_op)
//   src/repro/kernels/bitset.py: popcount_words  (_popcount_kernel)
//
// Packed words arrive as int32 tensors and are read and written here as
// uint32: bit j of word w of row r is node w*32 + j of row r's set.
//
// pack_bits: (B, n) bytes of 0/1 -> (B, n/32) words, LSB first (n % 32 == 0,
//   checked by the wrapper).  A byte counts as set when it is not 0.
//   What bounds it: bytes (B*n read, B*n/8 written; about one operation per
//   byte read, well under the integer units' rate).
//   Design.  The Pallas kernel packs a row block with a (BB, W, 32) shift
//   and sum.  Here one thread owns one output word: it reads the word's 32
//   bytes as two 16-byte loads (the bytes of word w start at w*32, so every
//   word is 16-byte aligned when the tensor's base is; a scalar form runs
//   otherwise) and writes one uint32.  Neighbouring threads
//   read neighbouring 32-byte groups, so a warp reads 1 KB contiguously.
//
// bitset_binary<Op>: out = a | b (OR) or a & ~b (AND-NOT), elementwise on
//   the flat B*W words.
//   What bounds it: bytes (12 per word, one logic operation).
//   Design.  A grid-stride loop over uint4 groups when all three pointers
//   are 16-byte aligned, then a scalar loop over the tail (and over all
//   words when a pointer is not aligned).
//
// frontier_update: new = a & ~visited, and visited |= a in place: the
//   dense level's bitset_andnot and bitset_or in one launch (visited |
//   (a & ~visited) == visited | a, so visited ends as the two calls leave
//   it).  Replaces no Pallas kernel of its own: the pair above, as the
//   reference's dense level calls them (src/repro/core/dense.py:156).
//   What bounds it: bytes (16 per word: a and visited read, new and
//   visited written; two logic operations).
//   Design.  bitset_binary's loop, with the second output.
//
// popcount_words: out = __popc(words), elementwise -> int32.  Equal to the
//   reference's SWAR popcount on every word, bit 31 included.
//   What bounds it: bytes (8 per word, one instruction).
//   Design.  The same grid-stride loop as bitset_binary.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

inline unsigned blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return unsigned(b < 1 ? 1 : b);
}

__device__ __forceinline__ uint32_t bits_of(uint32_t four_bytes) {
  // bit k of the result is set when byte k of the argument is not 0
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) out |= uint32_t(((four_bytes >> (8 * k)) & 0xFFu) != 0u) << k;
  return out;
}

template <bool kVector>
__global__ void pack_bits_kernel(const uint8_t* __restrict__ bits,
                                 int64_t n_words_total,
                                 uint32_t* __restrict__ words) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       w < n_words_total; w += stride) {
    const uint8_t* src = bits + w * 32;
    uint32_t out = 0;
    if (kVector) {
      const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
      const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
      const uint32_t q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) out |= bits_of(q[i]) << (4 * i);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) out |= uint32_t(src[j] != 0) << j;
    }
    words[w] = out;
  }
}

struct OrOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a | b;
  }
};

struct AndNotOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a & ~b;
  }
};

template <typename Op>
__global__ void bitset_binary_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     int64_t n, bool vector,
                                     uint32_t* __restrict__ out) {
  Op op{};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vector) {
    const int64_t n4 = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t j = i; j < n4; j += stride) {
      const uint4 x = a4[j];
      const uint4 y = b4[j];
      o4[j] = make_uint4(op(x.x, y.x), op(x.y, y.y), op(x.z, y.z),
                         op(x.w, y.w));
    }
    done = n4 * 4;
  }
  for (int64_t j = done + i; j < n; j += stride) out[j] = op(a[j], b[j]);
}

// a may be visited itself (each word is read before it is written)
__global__ void frontier_update_kernel(const uint32_t* a, uint32_t* visited,
                                       int64_t n, bool vector,
                                       uint32_t* __restrict__ out) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vector) {
    const int64_t n4 = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    uint4* v4 = reinterpret_cast<uint4*>(visited);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t j = i; j < n4; j += stride) {
      const uint4 x = a4[j];
      const uint4 y = v4[j];
      o4[j] = make_uint4(x.x & ~y.x, x.y & ~y.y, x.z & ~y.z, x.w & ~y.w);
      v4[j] = make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
    }
    done = n4 * 4;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    const uint32_t x = a[j], y = visited[j];
    out[j] = x & ~y;
    visited[j] = x | y;
  }
}

__global__ void popcount_kernel(const uint32_t* __restrict__ words, int64_t n,
                                bool vector, int32_t* __restrict__ out) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vector) {
    const int64_t n4 = n / 4;
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int64_t j = i; j < n4; j += stride) {
      const uint4 x = w4[j];
      o4[j] = make_int4(__popc(x.x), __popc(x.y), __popc(x.z), __popc(x.w));
    }
    done = n4 * 4;
  }
  for (int64_t j = done + i; j < n; j += stride) out[j] = __popc(words[j]);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Op>
int launch_binary(const void* a, const void* b, int64_t n, void* out,
                  int device, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const bool vector = aligned16(a) && aligned16(b) && aligned16(out);
  bitset_binary_kernel<Op><<<blocks_for(vector ? (n + 3) / 4 : n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n,
      vector, static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each function launches on `stream` of
// card `device` and returns the cudaError_t of the launch.

// bits: rows*n bytes, n % 32 == 0; words: rows*(n/32) uint32.
extern "C" int pack_bits(const void* bits, int64_t rows, int64_t n,
                         void* words, int device, void* stream) {
  const int64_t total = rows * (n / 32);
  if (total <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(bits);
  auto* dst = static_cast<uint32_t*>(words);
  if (aligned16(bits)) {
    pack_bits_kernel<true><<<blocks_for(total), kThreads, 0, s>>>(src, total, dst);
  } else {
    pack_bits_kernel<false><<<blocks_for(total), kThreads, 0, s>>>(src, total, dst);
  }
  return int(cudaGetLastError());
}

// a, b, out: n uint32 words each.
extern "C" int bitset_or(const void* a, const void* b, int64_t n, void* out,
                         int device, void* stream) {
  return launch_binary<OrOp>(a, b, n, out, device, stream);
}

extern "C" int bitset_andnot(const void* a, const void* b, int64_t n,
                             void* out, int device, void* stream) {
  return launch_binary<AndNotOp>(a, b, n, out, device, stream);
}

// a, visited, out: n uint32 words each (visited updated in place; out
// another buffer than both).
extern "C" int frontier_update(const void* a, void* visited, int64_t n,
                               void* out, int device, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const bool vector = aligned16(a) && aligned16(visited) && aligned16(out);
  frontier_update_kernel<<<blocks_for(vector ? (n + 3) / 4 : n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(visited), n,
      vector, static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

// The device guard alone, with bitset_or's arguments: a probe for timing
// the wrappers' host parts (ctypes converts as many arguments).
extern "C" int bitops_guard(const void*, const void*, int64_t, void*,
                            int device, void*) {
  DeviceGuard guard(device);
  return int(guard.err);
}

// words: n uint32; out: n int32.
extern "C" int popcount_words(const void* words, int64_t n, void* out,
                              int device, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const bool vector = aligned16(words) && aligned16(out);
  popcount_kernel<<<blocks_for(vector ? (n + 3) / 4 : n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, vector,
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
