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
// Lane b draws its row seed s = counter_uniform_u32(round_seed, row0 + b)
// (row0 = 0 for a whole round; rank d's b lanes of a round that D ranks
// share start at row0 = d b; uint32 arithmetic) and its
// bucket i = (uint64(counter_uniform_u32(s, 0xFFFFFFFF)) * n) >> 32, as
// core/roots.py::row_seeds and draw_roots do.  Without an alias table the
// bucket is the root; with one (prob, alias: weighted roots) the root is i
// when float32(counter_uniform_u32(s, 0xFFFFFFFE)) * 2^-32 < prob[i], else
// alias[i].  It writes the root out.  It
// samples the RR set of s from that root on the reverse CSR (offsets,
// indices, weights).  Its queue row (qcap int32) starts with the root; the
// queue is FIFO, each dequeued node's row is scanned in CSR order, and the
// destinations accepted from it are appended in edge order (Alg. 3 L21's
// rank-ordered atomic_enqueue).  Edge e is live iff float32(h) * 2^-32 <
// w[e], h = counter_uniform_u32(s, e); a live edge is accepted iff its
// destination's visited bit was clear at the start of the row and, in a
// row that repeats destinations, it is the first live edge of the row
// with that destination.  Of the accepted nodes, the first qcap - tail
// are taken: they are written to the queue and get their visited bit; if
// any accepted node is not taken, the lane's overflowed flag is set, and
// the lane goes on dequeuing and testing edges, as the plain version's
// lane does.  The row is zero past the lane's length.  steps[b] is the
// plain version's lock-step count of the lane: the sum over the nodes it
// dequeues of max(1, ceil(deg / ec)); ec is used for nothing else.
//
// Two template parameters give the forms beside the plain one (kNone,
// untiled), which is the kernel of a simple-row graph:
// - kDedup (core/rrset.py::detect_dedup_mode) serves rows with parallel
//   edges, each edge with its own trial.  kSegmented takes rows sorted by
//   destination (the reference's segmented prefix-OR); kSort any order
//   (its stable sort).  A short row's warp keeps a candidate only when no
//   lane below holds its destination: the nearest candidate below
//   (kSegmented, a ballot and a shuffle) or __match_any_sync (kSort).  A
//   long row's segment with two or more candidates is cut once more: the
//   warps that hold candidates walk their tiles in edge order, one warp
//   after another with a barrier between, and keep a candidate only when
//   it is the first of its tile and no earlier tile of the row took its
//   destination, whose visited bit each kept node sets at once; the
//   segment is then ranked again.  A barrier after each segment that took
//   nodes hands its marks to the next segment.  The plain version cuts
//   EC-wide chunks with the reference's _first_occurrence, and the visited
//   bits that one chunk sets reject the later chunks' duplicates, so for
//   any EC it keeps the same edges; the first-candidate rule is the
//   reference's on rows where equal destinations are adjacent, and
//   segmented and sort give the same bytes there.
// - kTiled (MRIM, paper §4.8) gives lanes b in [tT, tT + T), T =
//   root_tile, the root that lane tT draws (its bucket and accept draw
//   from that lane's row seed), and each its own trials, so the T lanes of
//   a sample share a root.  At T = 1 the launch takes the untiled form.
//
// Design.  One block of kThreads runs one lane (bfs_lane.cuh::lane_bfs,
// which csrc/refill.cu shares).  On a simple row, whether an edge of it is
// accepted depends only on the visited bits at the start of the row: no
// edge of the row sets a bit that another edge of the row reads.  So a
// dequeued row is one block-wide stream compaction, and the only dependent
// chain of a lane is its rows.
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
// the byte side.  The dedup forms add, on a multigraph, the second
// rank's barrier and a barrier a warp with candidates in a segment that
// holds two or more; the tiled form one hash a lane.

#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_lane.cuh"
#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

using namespace bfs;

template <int kDedup, bool kTiled>
__global__ void __launch_bounds__(kThreads, 2)
queue_bfs_kernel(const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ indices,
                 const float* __restrict__ weights, uint32_t round_seed,
                 int32_t n, int32_t qcap, int64_t ec, int64_t n_words,
                 int32_t root_tile, uint32_t row0,
                 int32_t* __restrict__ queue,
                 uint32_t* visited, int32_t* __restrict__ roots,
                 int32_t* __restrict__ lengths,
                 bool* __restrict__ overflowed,
                 int64_t* __restrict__ steps,
                 const float* __restrict__ alias_prob,
                 const int32_t* __restrict__ alias_node) {
  extern __shared__ uint32_t vis_shared[];
  __shared__ LaneShared sh;
  const uint32_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const Visited vis{vis_shared,
                    visited ? visited + int64_t(b) * n_words : nullptr};
  int32_t* q = queue + int64_t(b) * qcap;

  // the row seed and root, in every thread; tiled, the root is the one
  // that the first lane of the tile draws
  const uint32_t seed = counter_uniform_u32(round_seed, row0 + b);
  const uint32_t root_seed =
      kTiled ? counter_uniform_u32(round_seed,
                                   row0 + b - b % uint32_t(root_tile))
             : seed;
  const int32_t root = draw_root(root_seed, n, alias_prob, alias_node);
  uint32_t* words = vis.words();
  for (int64_t i = tid; i < n_words; i += kThreads) words[i] = 0u;
  __syncthreads();
  if (tid == 0) {
    vis.mark(root);
    q[0] = root;
    sh.mirror[0] = root;
    roots[b] = root;
  }
  __syncthreads();

  int parity = 0;                               // warp_count's buffer
  int32_t tail = 1;
  bool over = false;
  int64_t lane_steps = 0;
  lane_bfs<kDedup>(offsets, indices, weights, seed, ec, qcap, q, vis, sh,
                   parity, tail, over, lane_steps);
  zero_tail(q, tail, qcap);                     // zeros past the length
  if (tid == 0) {
    lengths[b] = tail;
    overflowed[b] = over;
    steps[b] = lane_steps;
  }
}

template <int kDedup, bool kTiled>
cudaError_t launch(unsigned grid, size_t shared, cudaStream_t stream,
                   const void* offsets, const void* indices,
                   const void* weights, uint32_t round_seed, int32_t n,
                   int32_t qcap, int64_t ec, int64_t n_words,
                   int32_t root_tile, uint32_t row0, void* queue,
                   void* visited, void* roots,
                   void* lengths, void* overflowed, void* steps,
                   const void* prob, const void* alias) {
  auto kernel = queue_bfs_kernel<kDedup, kTiled>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, shared, stream>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), round_seed, n, qcap, ec, n_words,
      root_tile, row0, static_cast<int32_t*>(queue),
      static_cast<uint32_t*>(visited), static_cast<int32_t*>(roots),
      static_cast<int32_t*>(lengths), static_cast<bool*>(overflowed),
      static_cast<int64_t*>(steps), static_cast<const float*>(prob),
      static_cast<const int32_t*>(alias));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  offsets: n + 1 int32, indices and
// weights: m int32 / float32 (m < 2^31); round_seed: the round's 32-bit
// seed; queue: batch x qcap int32 (written in full); visited: null, for
// the bits in shared memory (4 * ceil(n / 32) <= kMaxSharedVisitedBytes),
// or batch x ceil(n / 32) uint32 scratch (zeroed by the kernel); roots,
// lengths (int32), overflowed (bool), steps (int64): batch each; prob,
// alias: null for uniform roots, or an alias table of n float32 / int32
// (alias values in [0, n)), both or neither; dedup: 0 none, 1 segmented,
// 2 sort; root_tile >= 1 (1: every lane its own root); row0: the round's
// row of lane 0 (0 for a whole round).  n >= 1, qcap >= 1,
// ec >= 1, batch < 2^31.  Launches on `stream` of card `device`; returns
// the cudaError_t of the launch.
extern "C" int queue_bfs(const void* offsets, const void* indices,
                         const void* weights, uint32_t round_seed,
                         int64_t batch, int32_t n, int32_t qcap, int64_t ec,
                         void* queue, void* visited, void* roots,
                         void* lengths, void* overflowed, void* steps,
                         const void* prob, const void* alias, int dedup,
                         int32_t root_tile, uint32_t row0, int device,
                         void* stream) {
  if (batch <= 0) return int(cudaGetLastError());
  if (n < 1 || qcap < 1 || ec < 1 || batch > 0x7FFFFFFF || root_tile < 1 ||
      dedup < kNone || dedup > kSort ||
      (prob == nullptr) != (alias == nullptr))
    return int(cudaErrorInvalidValue);
  const int64_t n_words = (int64_t(n) + 31) / 32;
  const int64_t shared = visited ? 0 : 4 * n_words;
  if (shared > kMaxSharedVisitedBytes) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const bool tiled = root_tile > 1;
  auto go = dedup == kSegmented
                ? (tiled ? launch<kSegmented, true> : launch<kSegmented, false>)
            : dedup == kSort ? (tiled ? launch<kSort, true> : launch<kSort, false>)
                             : (tiled ? launch<kNone, true> : launch<kNone, false>);
  return int(go(unsigned(batch), size_t(shared),
                static_cast<cudaStream_t>(stream), offsets, indices, weights,
                round_seed, n, qcap, ec, n_words, root_tile, row0, queue,
                visited, roots, lengths, overflowed, steps, prob, alias));
}
