// The exact evaluations of the CELF lazy greedy, one launch each, for
// Hopper (sm_90a): celf_eval scores a batch of candidates against the
// Covered bitset, celf_apply commits a seed into it.
//
// Replaces no Pallas kernel.  The JAX reference computes both in XLA
// (src/repro/core/coverage.py:1451-1497, eval_batch and apply_seed over
// _newly_rows, :1329): the paper's Alg. 7 membership pass in its lazy
// form.  Every exact evaluation of CELF sits on its critical path (the host
// reads its gains before it picks the next batch), so each is one kernel.
// The plain versions are kernels/ref.py::celf_eval_ref and celf_apply_ref.
//
// Inputs: the pool's live extent as the store holds it, flat (node ids),
// ids (row ids) and valid (a byte an element); cov, the Covered bitset of
// cov_words uint32 words (bit r & 31 of word r >> 5 is row r; bit 31 is a
// row like any other).  An element counts when it is valid and its row lies
// in [0, 32 * cov_words).
//
// Count rows, not elements.  The reference counts a row once even where the
// row repeats a node (segment_max), so neither kernel counts elements: a
// row counts when an atomicOr flips its bit from 0, in Covered for
// celf_apply and in a scratch bitmap of the candidate's for celf_eval.  So
// no row-unique contract is needed.
//
// celf_eval: out[i] = number of rows not in Covered that hold cands[i]
//   (c <= kMaxCands; a candidate that is no node, the reference's -1
//   padding, matches nothing).  buf holds out (c int32) and then the c
//   candidates' scratch bitmaps (c x cov_words); the entry point zeroes
//   buf (one memset) and launches the kernel.
//   Design.  One thread an element, grid-stride.  Each block first builds
//   a hash table of the candidates in shared memory (open addressing, at
//   least twice as many entries as candidates, keyed by node, a duplicate
//   candidate in an entry of its own), so an element costs one probe of
//   shared memory, and most elements match no candidate.  A matching
//   element whose row is not covered sets the row's bit in its candidate's
//   bitmap; where that flips the bit, the block's shared count of the
//   candidate rises, and each block adds its nonzero counts to out once.
//   What bounds it: bytes, the node ids of the pool read once (4 bytes an
//   element), and only for the elements that hold a candidate their valid
//   byte, row id and Covered word; one probe an element.  At the stand-in's
//   pool (35,538 elements) that is about 0.15 MB, so a call costs its
//   launch.  The memset writes 4 * c * (1 + cov_words) bytes besides: it
//   grows with c and the row capacity, not with the pool (65 KB at c = 32
//   and 16,384 rows; 2 GB at c = 2,048 and 2^23 rows).
//
// celf_apply: the rows that hold u are ORed into cov in place; *gain =
//   the number of them whose bit was 0 before.  The entry point zeroes
//   gain (one memset) and launches the kernel.
//   Design.  One thread an element, grid-stride, the loop's trip count the
//   same for every lane of a warp: a lane whose atomicOr flipped a bit
//   votes, the warp adds its votes to the block's shared count, and each
//   block adds its count to *gain once.  Bound: bytes, the node ids of the
//   pool read once, and the valid byte, row id and Covered word (read and
//   written) of the elements that hold u.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCands = 2048;   // candidates a launch (celf.py MAX_CANDS)
constexpr int kMaxTable = 2 * kMaxCands;   // hash entries, a power of two
constexpr int kMinTable = 64;
constexpr int64_t kMaxBlocks = 132 * 4;
constexpr int32_t kEmpty = -1;

__device__ __forceinline__ int table_slot(int32_t v, int shift) {
  return int((uint32_t(v) * 2654435761u) >> shift);
}

__device__ __forceinline__ bool row_in(const uint8_t* valid,
                                       const int32_t* ids, int64_t e,
                                       int64_t rows, int32_t* row) {
  if (!valid[e]) return false;
  const int32_t r = ids[e];
  *row = r;
  return r >= 0 && r < rows;
}

__global__ void __launch_bounds__(kThreads)
celf_eval_kernel(const int32_t* __restrict__ flat,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ valid, int64_t t,
                 const uint32_t* __restrict__ cov, int64_t cov_words,
                 const int32_t* __restrict__ cands, int c, int table_bits,
                 int32_t* __restrict__ out, uint32_t* __restrict__ scratch) {
  __shared__ int32_t s_key[kMaxTable];
  __shared__ int32_t s_cand[kMaxTable];
  __shared__ int32_t s_cnt[kMaxCands];
  const int table = 1 << table_bits;
  const int shift = 32 - table_bits;
  for (int i = threadIdx.x; i < table; i += blockDim.x) s_key[i] = kEmpty;
  for (int i = threadIdx.x; i < c; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int32_t v = cands[i];
    if (v < 0) continue;                   // matches no element
    int h = table_slot(v, shift);
    // a duplicate candidate probes on to an entry of its own
    while (atomicCAS(&s_key[h], kEmpty, v) != kEmpty) h = (h + 1) & (table - 1);
    s_cand[h] = i;
  }
  __syncthreads();
  const int64_t rows = cov_words * 32;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < t;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int32_t v = flat[e];
    if (v < 0) continue;
    int h = table_slot(v, shift);
    int32_t key = s_key[h];
    if (key == kEmpty) continue;           // the common case: no candidate
    int32_t r;
    if (!row_in(valid, ids, e, rows, &r)) continue;
    const uint32_t bit = 1u << (r & 31);
    if (__ldg(cov + (r >> 5)) & bit) continue;
    for (; key != kEmpty; h = (h + 1) & (table - 1), key = s_key[h]) {
      if (key != v) continue;
      const int i = s_cand[h];
      const uint32_t old = atomicOr(scratch + int64_t(i) * cov_words + (r >> 5),
                                    bit);
      if (!(old & bit)) atomicAdd(&s_cnt[i], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    if (s_cnt[i]) atomicAdd(out + i, s_cnt[i]);
}

__global__ void __launch_bounds__(kThreads)
celf_apply_kernel(const int32_t* __restrict__ flat,
                  const int32_t* __restrict__ ids,
                  const uint8_t* __restrict__ valid, int64_t t,
                  uint32_t* __restrict__ cov, int64_t cov_words, int32_t u,
                  int32_t* __restrict__ gain) {
  __shared__ int32_t s_gain;
  if (threadIdx.x == 0) s_gain = 0;
  __syncthreads();
  const int64_t rows = cov_words * 32;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  // every lane of a warp runs the same trips, so the ballot sees them all
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < t;
       base += stride) {
    const int64_t e = base + threadIdx.x;
    bool flipped = false;
    int32_t r;
    if (e < t && flat[e] == u && row_in(valid, ids, e, rows, &r)) {
      const uint32_t bit = 1u << (r & 31);
      flipped = !(atomicOr(cov + (r >> 5), bit) & bit);
    }
    const unsigned votes = __ballot_sync(0xffffffffu, flipped);
    if ((threadIdx.x & 31) == 0 && votes) atomicAdd(&s_gain, __popc(votes));
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_gain) atomicAdd(gain, s_gain);
}

unsigned grid_of(int64_t t) {
  int64_t blocks = (t + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return unsigned(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream` of card
// `device` and returns the cudaError_t of its memset or its launch.

// buf: c + c * cov_words int32, zeroed here; out = buf[0:c].  1 <= c <=
// kMaxCands (kernels/celf.py::MAX_CANDS).
extern "C" int celf_eval(const void* flat, const void* ids, const void* valid,
                         int64_t t, const void* cov, int64_t cov_words,
                         const void* cands, int c, void* buf, int device,
                         void* stream) {
  if (c < 1 || c > kMaxCands || cov_words < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(buf);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * size_t(c) * size_t(1 + cov_words), s);
  if (err != cudaSuccess) return int(err);
  if (t <= 0) return int(cudaGetLastError());
  int bits = 0;
  while ((1 << bits) < 2 * c || (1 << bits) < kMinTable) ++bits;
  celf_eval_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), t,
      static_cast<const uint32_t*>(cov), cov_words,
      static_cast<const int32_t*>(cands), c, bits, out,
      reinterpret_cast<uint32_t*>(out + c));
  return int(cudaGetLastError());
}

// gain: one int32, zeroed here; cov: cov_words uint32, updated in place.
extern "C" int celf_apply(const void* flat, const void* ids, const void* valid,
                          int64_t t, void* cov, int64_t cov_words, int32_t u,
                          void* gain, int device, void* stream) {
  if (cov_words < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(gain, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  if (t <= 0) return int(cudaGetLastError());
  celf_apply_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), t, static_cast<uint32_t*>(cov),
      cov_words, u, static_cast<int32_t*>(gain));
  return int(cudaGetLastError());
}
