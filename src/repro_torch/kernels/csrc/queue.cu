// gIM's queue-based RR-set sampler (paper Alg. 3/6): one launch a sampling
// round, for Hopper (sm_90a).
//
// Replaces the torch sampler's host loop (kernels/ref.py::queue_bfs_ref,
// the plain version, which syncs the host once a micro-step).  The JAX
// reference runs the same round as one jitted lax.while_loop
// (src/repro/core/rrset.py:227-304, plain XLA): it has no Pallas kernel.
//
// What it computes, lane for lane and byte for byte as the plain version.
// Lane b samples the RR set of row seed seeds[b] from root roots[b] on the
// reverse CSR (offsets, indices, weights), whose rows are simple (no
// destination repeats in a row).  Its queue row (qcap int32, zeros from
// the wrapper) starts with the root; the queue is FIFO, each dequeued
// node's row is scanned in CSR order, and the destinations accepted from
// it are appended in edge order (Alg. 3 L21's rank-ordered
// atomic_enqueue).  Edge e is live iff counter_uniform_u32(seed, e) <= its
// trial_limit (counter_hash.cuh: the float compare float32(h) * 2^-32 <
// w[e] as one integer compare); a live edge is accepted iff its
// destination's visited bit is clear.  Of the accepted nodes, the first
// qcap - tail are taken: they are written to the queue and get their
// visited bit; if any accepted node is not taken, the lane's overflowed
// flag is set, and the lane goes on dequeuing and testing edges, as the
// plain version's lane does.  Since the rows are simple, the visit order
// is the sequential edge-by-edge BFS whatever the pass width, so the plain
// version's EC-wide chunks and this kernel's 32-wide passes write the
// same queue.  steps[b] is the plain version's lock-step count of the
// lane: the sum over the nodes it dequeues of max(1, ceil(deg / ec)); ec
// is used for nothing else.
//
// Design.  One warp runs one lane's BFS to its end (gIM's
// `for i = tx; i < deg; i += N_th` loop with N_th = 32); a block holds
// kWarps warps.  A pass loads 32 consecutive edges' destinations and
// weights, runs their trials, reads the visited word of each live edge's
// destination, ranks the accepted edges with __ballot_sync and
// __popc(mask & lanemask_lt), stores the taken destinations at
// tail + rank and sets their visited bits with atomicOr (two edges of one
// pass can share a word), then __syncwarp() orders those writes before the
// next pass's reads and every lane advances tail by the same count.  Every
// visited read in a pass comes before the pass's writes, as the plain
// version gathers the visited words before it scatters.  Visited bits are
// a (B, ceil(n/32)) word scratch from the wrapper (4.9 MB at B = 512 on
// the 75,879-node graph, so it stays in the 50 MB L2), read with __ldcg
// (L2, not L1) since other lanes' atomics write it.
//
// What bounds it: latency.  The work is small (each examined edge reads 8
// bytes and hashes once), but a warp's passes run one after another and
// each waits on its loads, so a round takes as long as its longest lane's
// chain of passes: a lane that reaches a hub of in-degree 56,751 walks
// 1,774 passes.  Splitting such rows over a block is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kWarps = 4;                       // lanes (warps) a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
queue_bfs_kernel(const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ indices,
                 const float* __restrict__ weights,
                 const int64_t* __restrict__ seeds,
                 const int32_t* __restrict__ roots, int64_t batch,
                 int32_t qcap, int64_t ec, int64_t n_words, int32_t* queue,
                 uint32_t* visited, int32_t* lengths, bool* overflowed,
                 int64_t* steps) {
  const int64_t b = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (b >= batch) return;                       // whole warps leave
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;     // lanemask_lt
  const uint32_t seed = uint32_t(seeds[b]);
  int32_t* q = queue + b * int64_t(qcap);
  uint32_t* vis = visited + b * n_words;
  if (lane == 0) {
    const int32_t root = roots[b];
    q[0] = root;
    vis[root >> 5] = 1u << (root & 31);
  }
  __syncwarp();
  int32_t head = 0, tail = 1;                   // the same in every lane
  bool over = false;
  int64_t lane_steps = 0;
  while (head < tail) {
    const int32_t u = __ldcg(q + head);
    const int32_t start = offsets[u];
    const int32_t deg = offsets[u + 1] - start;
    lane_steps += deg > ec ? (int64_t(deg) + ec - 1) / ec : 1;
    for (int32_t base = 0; base < deg; base += 32) {
      const int32_t i = base + lane;
      bool accept = false;
      int32_t v = 0;
      if (i < deg) {
        const uint32_t e = uint32_t(start + i);
        v = indices[e];
        uint32_t limit;
        if (trial_limit(weights[e], &limit) &&
            counter_uniform_u32(seed, e) <= limit) {
          const uint32_t word = __ldcg(vis + (v >> 5));
          accept = ((word >> (v & 31)) & 1u) == 0;
        }
      }
      const uint32_t mask = __ballot_sync(kFullMask, accept);
      const int32_t count = __popc(mask);
      const int32_t take = min(count, qcap - tail);
      const int32_t rank = __popc(mask & below);
      if (accept && rank < take) {
        q[tail + rank] = v;
        atomicOr(vis + (v >> 5), 1u << (v & 31));
      }
      over |= count > take;
      tail += take;
      __syncwarp();
    }
    ++head;
  }
  if (lane == 0) {
    lengths[b] = tail;
    overflowed[b] = over;
    steps[b] = lane_steps;
  }
}

}  // namespace

// Plain C interface for ctypes.  offsets: n + 1 int32, indices and
// weights: m int32 / float32 (m < 2^31), seeds: batch int64, roots: batch
// int32 in [0, n); queue: batch x qcap int32 zeros, visited: batch x
// n_words uint32 zeros, n_words = ceil(n / 32); lengths (int32),
// overflowed (bool), steps (int64): batch each.  qcap >= 1, ec >= 1.
// Launches on `stream` of card `device`; returns the cudaError_t of the
// launch.
extern "C" int queue_bfs(const void* offsets, const void* indices,
                         const void* weights, const void* seeds,
                         const void* roots, int64_t batch, int32_t qcap,
                         int64_t ec, int64_t n_words, void* queue,
                         void* visited, void* lengths, void* overflowed,
                         void* steps, int device, void* stream) {
  if (batch <= 0) return int(cudaGetLastError());
  if (qcap < 1 || ec < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const unsigned blocks = unsigned((batch + kWarps - 1) / kWarps);
  queue_bfs_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), static_cast<const int64_t*>(seeds),
      static_cast<const int32_t*>(roots), batch, qcap, ec, n_words,
      static_cast<int32_t*>(queue), static_cast<uint32_t*>(visited),
      static_cast<int32_t*>(lengths), static_cast<bool*>(overflowed),
      static_cast<int64_t*>(steps));
  return int(cudaGetLastError());
}
