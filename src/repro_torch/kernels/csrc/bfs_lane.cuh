// One lane's RR-set BFS of gIM's queue sampler (paper Alg. 3), run by a
// whole block: the loop that csrc/queue.cu (a lane a sampling round) and
// csrc/refill.cu (a persistent lane that samples set after set) share.
// queue.cu's note says what a lane computes and how the block splits a
// row; this header holds that loop and its pieces, with the chunk dedup of
// rows that repeat a destination as a template parameter.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace bfs {

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
// for the static arrays (kernels/queue.py MAX_SHARED_VISITED_BYTES)
constexpr int kStaticShared = 2048;
constexpr int64_t kMaxSharedVisitedBytes = 232448 - kStaticShared;
static_assert(sizeof(int32_t) * (2 * kWarps + kMirror + 1) <= kStaticShared,
              "static shared arrays outgrow their reserve");

// the chunk dedup of core/rrset.py::detect_dedup_mode
enum Dedup : int { kNone = 0, kSegmented = 1, kSort = 2 };

// the block's shared state of a lane besides its visited bits
struct LaneShared {
  int32_t warp_count[2][kWarps];   // the warps' counts, two buffers
  int32_t mirror[kMirror];         // the first queue entries
};

__device__ __forceinline__ int32_t warp_inclusive_sum(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The lane's visited bits: in shared memory (global null) or in its row of
// the global scratch.
struct Visited {
  uint32_t* shared;
  uint32_t* global;

  __device__ __forceinline__ uint32_t* words() const {
    return global ? global : shared;
  }
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
  // zero the word of node v (a finished set's nodes, before the next set)
  __device__ __forceinline__ void clear_word(int32_t v) const {
    if (global)
      __stcg(global + (v >> 5), 0u);
    else
      shared[v >> 5] = 0u;
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

// The root of row seed `seed` (core/roots.py::draw_roots): the bucket of
// the counter 0xFFFFFFFF and, with an alias table, its accept draw on the
// counter 0xFFFFFFFE (the edge trial's conversion and scale).
__device__ __forceinline__ int32_t draw_root(uint32_t seed, int32_t n,
                                             const float* alias_prob,
                                             const int32_t* alias_node) {
  int32_t root = int32_t(
      (uint64_t(counter_uniform_u32(seed, kRootCounter)) * uint32_t(n)) >> 32);
  if (alias_prob != nullptr &&
      !(__uint2float_rn(counter_uniform_u32(seed, kAliasCounter)) * 0x1p-32f <
        __ldg(alias_prob + root)))
    root = __ldg(alias_node + root);
  return root;
}

// Of a warp's 32 edges of one row in edge order, v >= 0 the destination of
// a candidate (a live edge whose destination was unseen at the row's
// start), -1 elsewhere: whether this lane's candidate is the first of the
// tile with its destination.  Every lane of the warp calls it.
// kSegmented (destination-sorted rows, where equal destinations are
// adjacent): the nearest candidate below has another destination.  kSort
// (any order): no lane below holds the same destination
// (__match_any_sync; the other lanes' keys are distinct negatives).
template <int kDedup>
__device__ __forceinline__ bool first_in_tile(int32_t v, int lane,
                                              uint32_t below) {
  if constexpr (kDedup == kSegmented) {
    const uint32_t c = __ballot_sync(kFullMask, v >= 0) & below;
    const int32_t prev = __shfl_sync(kFullMask, v, c ? 31 - __clz(c) : lane);
    return c == 0 || prev != v;
  } else {
    const uint32_t g = __match_any_sync(kFullMask, v >= 0 ? v : -2 - lane);
    return (g & below) == 0;
  }
}

// One lane's BFS, by the whole block, from the root in q[0] (also in
// sh.mirror[0] and marked visited, before a barrier) to the end of its
// queue: the nodes go to q[0, tail), at most `cap` of them.  tail starts
// at 1; `over` is set when an accepted node finds no room; `steps` gets the
// lane's lock-step count at chunk width ec.  Every thread returns the same
// tail, over and steps, after a barrier that orders the queue's and the
// visited bits' writes before any later read.  kDedup: queue.cu's note.
template <int kDedup>
__device__ __forceinline__ void lane_bfs(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
    const float* __restrict__ weights, uint32_t seed, int64_t ec,
    int32_t cap, int32_t* q, const Visited& vis, LaneShared& sh,
    int& parity, int32_t& tail, bool& over, int64_t& lane_steps) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t below = (1u << lane) - 1u;     // lanemask_lt

  // write an accepted destination at queue position pos
  auto enqueue = [&](int32_t pos, int32_t v) {
    q[pos] = v;
    if (pos < kMirror) sh.mirror[pos] = v;
    vis.mark(v);
  };

  int32_t head = 0;                             // the same in every thread
  while (head < tail) {
    const int32_t u = head < kMirror ? sh.mirror[head] : __ldcg(q + head);
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
      int32_t* slot = &sh.warp_count[parity][0];
      if (warp == 0) {
        int32_t v = -1;
        if (live0) {
          v = __ldg(indices + e0);
          if (vis.seen(v)) v = -1;
        }
        if constexpr (kDedup != kNone) {
          if (!first_in_tile<kDedup>(v, lane, below)) v = -1;
        }
        const uint32_t mask = __ballot_sync(kFullMask, v >= 0);
        const int32_t take = min(__popc(mask), cap - tail);
        const int32_t rank = __popc(mask & below);
        if (v >= 0 && rank < take) enqueue(tail + rank, v);
        if (lane == 0) *slot = int32_t(mask);
      }
      __syncthreads();
      parity ^= 1;
      const int32_t total = __popc(uint32_t(*slot));
      const int32_t take = min(total, cap - tail);
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
      // ranks: tiles inside the warp, then the warps; with a dedup, once
      // more after the candidates of a segment that holds two or more are
      // cut to the first of each destination
      int32_t count, incl, wc, wincl;
      bool deduped = false;
      for (;;) {
        count = __popc(tile_mask);
        incl = warp_inclusive_sum(count, lane);
        if (lane == 31) sh.warp_count[parity][warp] = incl;
        __syncthreads();
        wc = lane < kWarps ? sh.warp_count[parity][lane] : 0;
        wincl = warp_inclusive_sum(wc, lane);
        parity ^= 1;
        if constexpr (kDedup == kNone) {
          break;
        } else {
          if (deduped || __shfl_sync(kFullMask, wincl, kWarps - 1) < 2) break;
          // the warps with candidates, in order (the same mask in every
          // warp): each walks its non-empty tiles in edge order and keeps a
          // candidate only when it is the first of its tile with its
          // destination and no earlier tile of the row took that
          // destination; a kept node is marked at once, so the later tiles
          // see it, and a barrier hands the marks to the next warp
          uint32_t todo = __ballot_sync(kFullMask, wc > 0);
          while (todo) {
            const int w_next = __ffs(todo) - 1;
            todo &= todo - 1;
            if (warp == w_next) {
              uint32_t busy = __ballot_sync(kFullMask, tile_mask != 0);
              while (busy) {
                const int i = __ffs(busy) - 1;
                busy &= busy - 1;
                const uint32_t m = __shfl_sync(kFullMask, tile_mask, i);
                int32_t v = ((m >> lane) & 1u)
                                ? __ldg(indices + first + i * 32u + lane)
                                : -1;
                if (!first_in_tile<kDedup>(v, lane, below) ||
                    (v >= 0 && vis.seen(v)))
                  v = -1;
                const uint32_t kept = __ballot_sync(kFullMask, v >= 0);
                if (v >= 0) vis.mark(v);
                __syncwarp();
                if (lane == i) tile_mask = kept;
              }
            }
            __syncthreads();
          }
          deduped = true;
        }
      }
      const int32_t total = __shfl_sync(kFullMask, wincl, kWarps - 1);
      const int32_t take = min(total, cap - tail);
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
      // with a dedup the next segment's visited reads follow these writes
      if constexpr (kDedup != kNone) {
        if (take) __syncthreads();
      }
    }
    if constexpr (kDedup == kNone) {
      if (row_taken) __syncthreads();
    }
  }
}

// Zeros over q[tail, cap): 16-byte evict-first stores between a 4-byte head
// and tail (a row is 16-byte aligned only where its offset is), by the
// whole block.
__device__ __forceinline__ void zero_tail(int32_t* q, int32_t tail,
                                          int32_t cap) {
  const int tid = threadIdx.x;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(q + tail);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(q + cap);
  const uintptr_t a = min(hi, (lo + 15) & ~uintptr_t(15));
  const uintptr_t z = max(a, hi & ~uintptr_t(15));
  for (uintptr_t p = lo + 4 * tid; p < a; p += 4 * kThreads)
    __stcs(reinterpret_cast<int32_t*>(p), 0);
  for (uintptr_t p = a + 16 * tid; p < z; p += 16 * kThreads)
    __stcs(reinterpret_cast<int4*>(p), make_int4(0, 0, 0, 0));
  for (uintptr_t p = z + 4 * tid; p < hi; p += 4 * kThreads)
    __stcs(reinterpret_cast<int32_t*>(p), 0);
}

}  // namespace bfs
