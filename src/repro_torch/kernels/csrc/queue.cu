// gIM's queue-based RR-set sampler (paper Alg. 3/6): one launch a sampling
// round, for Hopper (sm_90a).
//
// Replaces the torch sampler's host loop (kernels/ref.py::queue_round_ref,
// the plain version: row seeds, roots, then queue_bfs_ref, which syncs the
// host once a micro-step).  The JAX reference runs the same round as one
// jitted lax.while_loop in plain XLA (src/repro/core/rrset.py:230): it has
// no Pallas kernel.
//
// What it computes, lane for lane and byte for byte as the plain version.
// Lane b draws its row seed s = counter_uniform_u32(round_seed, b) and its
// bucket i = (uint64(counter_uniform_u32(s, 0xFFFFFFFF)) * n) >> 32, as
// core/roots.py::row_seeds and draw_roots do.  Without an alias table the
// bucket is the root; with one (prob, alias: weighted roots) the root is i
// when float32(counter_uniform_u32(s, 0xFFFFFFFE)) * 2^-32 < prob[i], else
// alias[i].  It writes the root out.  It
// samples the RR set of s from that root on the reverse CSR (offsets,
// indices, weights), whose rows are simple (no destination repeats in a
// row).  Its queue row (qcap int32) starts with the root; the queue is
// FIFO, each dequeued node's row is scanned in CSR order, and the
// destinations accepted from it are appended in edge order (Alg. 3 L21's
// rank-ordered atomic_enqueue).  Edge e is live iff float32(h) * 2^-32 <
// w[e], h = counter_uniform_u32(s, e); a live edge is accepted iff its
// destination's visited bit is clear.  Of the accepted nodes, the first
// qcap - tail are taken: they are written to the queue and get their
// visited bit; if any accepted node is not taken, the lane's overflowed
// flag is set, and the lane goes on dequeuing and testing edges, as the
// plain version's lane does.  The row is zero past the lane's length.
// steps[b] is the plain version's lock-step count of the lane: the sum
// over the nodes it dequeues of max(1, ceil(deg / ec)); ec is used for
// nothing else.
//
// Design.  One block of kThreads runs one lane.  Because a row is simple,
// whether an edge of it is accepted depends only on the visited bits at
// the start of the row: no edge of the row sets a bit that another edge of
// the row reads.  So a dequeued row is one block-wide stream compaction,
// and the only dependent chain of a lane is its rows.
// - A row of more than 32 edges goes in segments of kSegmentEdges; each
//   warp takes a contiguous run of at most 32 of a segment's 32-edge
//   tiles.  Pass 1: the warp loads kBatch tiles' weights at once and runs
//   their trials with no branch between them, into one bit a tile, so
//   their hash chains overlap; only when one is live does it test the
//   visited bits of the live edges' destinations.  Lane i keeps tile i's
//   __ballot_sync.  A scan of the tiles' counts inside the warp and one of
//   the warps' counts in shared memory (one __syncthreads) rank every
//   accepted edge in edge order.  Pass 2: each warp walks its non-empty
//   tiles and writes the accepted destinations at tail + rank while rank
//   < qcap - tail, reloading each one's index (the L1 has it).
// - A row of at most 32 edges is one tile: every warp runs its trials;
//   when any is live, warp 0 alone tests the visited bits (another warp
//   could see a bit that warp 0 sets for this very row), ranks by one
//   ballot, writes, and hands the ballot to the others through shared
//   memory and one __syncthreads.  A short row with no live edge costs no
//   barrier.
// - One __syncthreads after a long row that took nodes orders its queue
//   and visited writes before the next row's reads; a row that took none
//   wrote nothing.  Every use of the shared count buffers is followed by a
//   barrier, and the buffers alternate, so no warp overwrites a count that
//   another has yet to read.
// - The visited bits live in shared memory (9,488 bytes at n = 75,879)
//   when ceil(n / 32) words fit in kMaxSharedVisitedBytes (n up to
//   1,843,200), else in a (B, ceil(n / 32)) global scratch that the
//   wrapper allocates and each block zeroes itself, read with __ldcg since
//   atomics write it; the wrapper picks by n.  The first kMirror queue
//   entries are mirrored in shared memory, so a dequeue reads no global
//   memory.  Each block writes its row's zeros past its length at its end,
//   in 16-byte evict-first stores, so short lanes write theirs while the
//   hub lanes still run.
// - The trial is the float compare, one conversion and two float
//   operations, and not bernoulli.cu's integer threshold (trial_limit),
//   which costs about 15 integer operations: that threshold pays where
//   several seeds share an edge's, and here each trial has its own edge.
//   The two keep the same edges (tests/test_torch_trials.py).
//
// What bounds it.  The trials' integer operations (the hash), on the SMs
// that hold the lanes that walk the hub rows: on the stand-in about 143
// of 512 lanes walk all five rows of in-degree about 42,000 (211,322
// trials), the rest a few short rows.  A lane's work stays on one SM, so
// the round takes at least its longest lane's trials at one SM's rates
// (about 0.023 ms), and an SM that holds two or three such lanes takes
// that much longer; the queue's zeros (155 MB at B = 512, qcap = n) are
// the byte side.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;                    // a block runs one lane
constexpr int kWarps = kThreads / 32;
constexpr int kWarpTiles = 32;                   // a warp's tiles: one a lane
constexpr int kSegmentEdges = kWarps * kWarpTiles * 32;   // 16,384
constexpr int kBatch = 8;                        // tiles loaded before ranked
constexpr int kMirror = 256;                     // queue head in shared
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kRootCounter = 0xFFFFFFFFu;   // core/roots.py ROOT_COUNTER
constexpr uint32_t kAliasCounter = 0xFFFFFFFEu;  // core/roots.py ALIAS_COUNTER
// the 227 KB of shared memory a block can opt in to on sm_90, less room
// for the static arrays below (kernels/queue.py MAX_SHARED_VISITED_BYTES)
constexpr int kStaticShared = 2048;
constexpr int64_t kMaxSharedVisitedBytes = 232448 - kStaticShared;
static_assert(sizeof(int32_t) * (2 * kWarps + kMirror) <= kStaticShared,
              "static shared arrays outgrow their reserve");

__device__ __forceinline__ int32_t warp_inclusive_sum(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The lane's visited bits: in shared memory (vis_g null) or in its row of
// the global scratch.
struct Visited {
  uint32_t* shared;
  uint32_t* global;

  __device__ __forceinline__ bool seen(int32_t v) const {
    const uint32_t word = global ? __ldcg(global + (v >> 5)) : shared[v >> 5];
    return (word >> (v & 31)) & 1u;
  }
  __device__ __forceinline__ void mark(int32_t v) const {
    const uint32_t bit = 1u << (v & 31);
    if (global)
      atomicOr(global + (v >> 5), bit);
    else
      atomicOr(shared + (v >> 5), bit);
  }
};

// Whether edge e is live for `seed`: the trial's own float compare,
// float32(h) * 2^-32 < w, which keeps the same edges as h <= trial_limit
// (tests/test_torch_trials.py), in one conversion and two float operations
// with no branch.  Each trial here has its own edge, so an integer
// threshold, which bernoulli.cu shares among the seeds of an edge, would
// cost more integer operations than the compare saves.  w = 0 stands for
// an edge outside the row.
__device__ __forceinline__ bool is_live(float w, uint32_t seed, uint32_t e) {
  return __uint2float_rn(counter_uniform_u32(seed, e)) * 0x1p-32f < w;
}

__global__ void __launch_bounds__(kThreads, 2)
queue_bfs_kernel(const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ indices,
                 const float* __restrict__ weights, uint32_t round_seed,
                 int32_t n, int32_t qcap, int64_t ec, int64_t n_words,
                 int32_t* __restrict__ queue, uint32_t* visited,
                 int32_t* __restrict__ roots, int32_t* __restrict__ lengths,
                 bool* __restrict__ overflowed,
                 int64_t* __restrict__ steps,
                 const float* __restrict__ alias_prob,
                 const int32_t* __restrict__ alias_node) {
  extern __shared__ uint32_t vis_shared[];
  __shared__ int32_t warp_count[2][kWarps];
  __shared__ int32_t mirror[kMirror];
  const uint32_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t below = (1u << lane) - 1u;     // lanemask_lt
  const Visited vis{vis_shared,
                    visited ? visited + int64_t(b) * n_words : nullptr};
  int32_t* q = queue + int64_t(b) * qcap;

  // the row seed and root, in every thread: the bucket, then with an alias
  // table its accept draw (the edge trial's conversion and scale)
  const uint32_t seed = counter_uniform_u32(round_seed, b);
  int32_t root = int32_t(
      (uint64_t(counter_uniform_u32(seed, kRootCounter)) * uint32_t(n)) >> 32);
  if (alias_prob != nullptr &&
      !(__uint2float_rn(counter_uniform_u32(seed, kAliasCounter)) * 0x1p-32f <
        __ldg(alias_prob + root)))
    root = __ldg(alias_node + root);
  uint32_t* words = vis.global ? vis.global : vis.shared;
  for (int64_t i = tid; i < n_words; i += kThreads) words[i] = 0u;
  __syncthreads();
  if (tid == 0) {
    vis.mark(root);
    q[0] = root;
    mirror[0] = root;
    roots[b] = root;
  }
  __syncthreads();

  // write an accepted destination at queue position pos
  auto enqueue = [&](int32_t pos, int32_t v) {
    q[pos] = v;
    if (pos < kMirror) mirror[pos] = v;
    vis.mark(v);
  };

  int32_t head = 0, tail = 1;                   // the same in every thread
  int parity = 0;                               // warp_count's buffer
  bool over = false;
  int64_t lane_steps = 0;
  while (head < tail) {
    const int32_t u = head < kMirror ? mirror[head] : __ldcg(q + head);
    ++head;
    const int32_t start = __ldg(offsets + u);
    const int32_t deg = __ldg(offsets + u + 1) - start;
    lane_steps += deg > ec ? (int64_t(deg) + ec - 1) / ec : 1;
    int32_t row_taken = 0;
    const uint32_t e0 = uint32_t(start + lane);
    const bool live0 = deg <= 32 && lane < deg &&
                       is_live(__ldg(weights + e0), seed, e0);
    if (deg <= 32 && __any_sync(kFullMask, live0)) {
      // one tile with a live edge: warp 0 ranks and writes it
      int32_t* slot = &warp_count[parity][0];
      if (warp == 0) {
        int32_t v = -1;
        if (live0) {
          v = __ldg(indices + e0);
          if (vis.seen(v)) v = -1;
        }
        const uint32_t mask = __ballot_sync(kFullMask, v >= 0);
        const int32_t take = min(__popc(mask), qcap - tail);
        const int32_t rank = __popc(mask & below);
        if (v >= 0 && rank < take) enqueue(tail + rank, v);
        if (lane == 0) *slot = int32_t(mask);
      }
      __syncthreads();
      parity ^= 1;
      const int32_t total = __popc(uint32_t(*slot));
      const int32_t take = min(total, qcap - tail);
      over |= total > take;
      tail += take;
    }
    for (int32_t base = 0; deg > 32 && base < deg; base += kSegmentEdges) {
      const int32_t seg = min(deg - base, kSegmentEdges);
      const int32_t per_warp = (((seg + 31) >> 5) + kWarps - 1) / kWarps;
      const uint32_t first = uint32_t(start + base) + warp * per_warp * 32u;
      // the end of the warp's run of tiles, inside the segment
      const uint32_t end = min(uint32_t(start + base + seg),
                               first + per_warp * 32u);
      // pass 1: lane i keeps the ballot of the warp's tile i
      uint32_t tile_mask = 0;
      for (int32_t i0 = 0; i0 < per_warp; i0 += kBatch) {
        float w[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const uint32_t e = first + uint32_t(i0 + t) * 32u + lane;
          w[t] = e < end ? __ldg(weights + e) : 0.f;
        }
        // the batch's trials, with no branch between their hash chains,
        // as one bit a tile; a tile with no live edge accepts none
        uint32_t live = 0;
#pragma unroll
        for (int t = 0; t < kBatch; ++t)
          live |= uint32_t(is_live(w[t], seed,
                                   first + uint32_t(i0 + t) * 32u + lane))
                  << t;
        if (__any_sync(kFullMask, live != 0)) {
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            bool acc = false;
            if ((live >> t) & 1u)
              acc = !vis.seen(__ldg(indices + first +
                                    uint32_t(i0 + t) * 32u + lane));
            const uint32_t m = __ballot_sync(kFullMask, acc);
            if (lane == i0 + t) tile_mask = m;
          }
        }
      }
      // ranks: tiles inside the warp, then the warps
      const int32_t count = __popc(tile_mask);
      const int32_t incl = warp_inclusive_sum(count, lane);
      if (lane == 31) warp_count[parity][warp] = incl;
      __syncthreads();
      const int32_t wc = lane < kWarps ? warp_count[parity][lane] : 0;
      const int32_t wincl = warp_inclusive_sum(wc, lane);
      parity ^= 1;
      const int32_t total = __shfl_sync(kFullMask, wincl, kWarps - 1);
      const int32_t take = min(total, qcap - tail);
      const int32_t warp_base = __shfl_sync(kFullMask, wincl - wc, warp);
      // pass 2: the warp's accepted edges at tail + rank, rank < take
      uint32_t busy = __ballot_sync(kFullMask, count > 0);
      if (warp_base >= take) busy = 0;
      while (busy) {
        const int i = __ffs(busy) - 1;
        busy &= busy - 1;
        const uint32_t m = __shfl_sync(kFullMask, tile_mask, i);
        const int32_t rank = warp_base +
            __shfl_sync(kFullMask, incl - count, i) + __popc(m & below);
        if (((m >> lane) & 1u) && rank < take)
          enqueue(tail + rank, __ldg(indices + first + i * 32u + lane));
      }
      over |= total > take;
      tail += take;
      row_taken += take;
    }
    if (row_taken) __syncthreads();
  }
  // zeros past the length: 16-byte evict-first stores between a 4-byte
  // head and tail (a row is 16-byte aligned only where b * qcap is)
  {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(q + tail);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(q + qcap);
    const uintptr_t a = min(hi, (lo + 15) & ~uintptr_t(15));
    const uintptr_t z = max(a, hi & ~uintptr_t(15));
    for (uintptr_t p = lo + 4 * tid; p < a; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);
    for (uintptr_t p = a + 16 * tid; p < z; p += 16 * kThreads)
      __stcs(reinterpret_cast<int4*>(p), make_int4(0, 0, 0, 0));
    for (uintptr_t p = z + 4 * tid; p < hi; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);
  }
  if (tid == 0) {
    lengths[b] = tail;
    overflowed[b] = over;
    steps[b] = lane_steps;
  }
}

}  // namespace

// Plain C interface for ctypes.  offsets: n + 1 int32, indices and
// weights: m int32 / float32 (m < 2^31); round_seed: the round's 32-bit
// seed; queue: batch x qcap int32 (written in full); visited: null, for
// the bits in shared memory (4 * ceil(n / 32) <= kMaxSharedVisitedBytes),
// or batch x ceil(n / 32) uint32 scratch (zeroed by the kernel); roots,
// lengths (int32), overflowed (bool), steps (int64): batch each; prob,
// alias: null for uniform roots, or an alias table of n float32 / int32
// (alias values in [0, n)), both or neither.  n >= 1, qcap >= 1, ec >= 1,
// batch < 2^31.  Launches on `stream` of card `device`; returns the
// cudaError_t of the launch.
extern "C" int queue_bfs(const void* offsets, const void* indices,
                         const void* weights, uint32_t round_seed,
                         int64_t batch, int32_t n, int32_t qcap, int64_t ec,
                         void* queue, void* visited, void* roots,
                         void* lengths, void* overflowed, void* steps,
                         const void* prob, const void* alias, int device,
                         void* stream) {
  if (batch <= 0) return int(cudaGetLastError());
  if (n < 1 || qcap < 1 || ec < 1 || batch > 0x7FFFFFFF ||
      (prob == nullptr) != (alias == nullptr))
    return int(cudaErrorInvalidValue);
  const int64_t n_words = (int64_t(n) + 31) / 32;
  const int64_t shared = visited ? 0 : 4 * n_words;
  if (shared > kMaxSharedVisitedBytes) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_bfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(shared));
    if (err != cudaSuccess) return int(err);
  }
  queue_bfs_kernel<<<unsigned(batch), kThreads, size_t(shared),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), round_seed, n, qcap, ec, n_words,
      static_cast<int32_t*>(queue), static_cast<uint32_t*>(visited),
      static_cast<int32_t*>(roots), static_cast<int32_t*>(lengths),
      static_cast<bool*>(overflowed), static_cast<int64_t*>(steps),
      static_cast<const float*>(prob), static_cast<const int32_t*>(alias));
  return int(cudaGetLastError());
}
