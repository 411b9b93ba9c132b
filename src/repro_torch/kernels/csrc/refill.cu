// gIM's persistent-lane RR-set sampler (paper Alg. 6's worker loop): one
// launch samples `quota` RR sets, for Hopper (sm_90a).
//
// Replaces the torch sampler's host loop (kernels/ref.py::refill_round_ref,
// the plain version, which syncs the host once a micro-step).  The JAX
// reference runs the loop as one jitted lax.while_loop in plain XLA
// (src/repro/core/rrset.py:356-457, _sample_refill): it has no Pallas
// kernel.
//
// What it computes.  Lane b (a block) claims row ids from a global counter
// (an atomicAdd on `counter`, which the wrapper zeroes on the stream) and
// stops when the id reaches `quota` or its max_sets slots are full.  Row r
// is the RR set of row seed s = counter_uniform_u32(round_seed, r) from the
// root drawn from s (with an alias table, its accept draw too): the seed
// and root of queue.cu's lane r, sampled by the same loop
// (bfs_lane.cuh::lane_bfs, with the same dedup forms), so row r equals
// queue_bfs's lane r byte for byte.  The lane writes its sets one after
// another into its out_cap row of `flat`, each root first: set j at the
// sum of the lengths before it, lengths[b, j], rows[b, j] = r and
// row_steps[b, j] its lock-step count at chunk width ec.  A set that finds
// no room (a node, or the root at tail == out_cap) sets overflowed[b] and
// ends the lane; it is not emitted, and its claimed id is lost.  n_done[b]
// counts the emitted sets; slots past it hold length 0, row -1 and steps
// 0, and the row is zero past the emitted sets.  Which lane runs which row
// depends on the schedule of the blocks, but each row does not: where no
// lane overflows, every row below quota is emitted once, and the caller
// orders them by row id (core/rrset.py).  The reference's lanes race for a
// global count in lock step and emit quota to quota + lanes - 1 sets; here
// the count is exactly quota, each row with the same law.
//
// Design.  One block of bfs::kThreads runs one lane, as in queue.cu, and
// the grid is the lanes (256 at the stand-in's batch 512: all resident,
// two blocks an SM; more lanes wait for a free slot, and no block waits
// for another, so any grid is safe).  Thread 0 claims an id and hands it
// over shared memory; the lane then runs lane_bfs from the row's root at
// flat + tail with cap out_cap - tail.  After a set the block clears the
// visited words of its nodes only (a few words where the set is short,
// not the n / 32 of the whole bitset), then a barrier.  The visited bits
// live in shared memory or a global scratch by the rule of queue.cu.
//
// What bounds it.  Per row, what bounds queue.cu's lane: the trials'
// hash on one SM for the rows that walk hub rows.  A persistent lane
// starts its next row as soon as its last ends, so the hub rows spread
// over the lanes instead of waiting for the longest lane of a round.  The
// bytes are the flat rows (out_cap int32 a lane, 1 MB at 256 lanes and
// out_cap 1,024), the slots and the CSR rows the sets read.

#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_lane.cuh"
#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

using namespace bfs;

template <int kDedup>
__global__ void __launch_bounds__(kThreads, 2)
refill_bfs_kernel(const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ weights, uint32_t round_seed,
                  int32_t n, int32_t out_cap, int64_t ec, int64_t n_words,
                  int32_t quota, int32_t max_sets,
                  int32_t* __restrict__ flat, uint32_t* visited,
                  int32_t* counter, int32_t* __restrict__ lengths,
                  int32_t* __restrict__ n_done,
                  bool* __restrict__ overflowed, int32_t* __restrict__ rows,
                  int64_t* __restrict__ row_steps,
                  const float* __restrict__ alias_prob,
                  const int32_t* __restrict__ alias_node) {
  extern __shared__ uint32_t vis_shared[];
  __shared__ LaneShared sh;
  __shared__ int32_t claimed;
  const uint32_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const Visited vis{vis_shared,
                    visited ? visited + int64_t(b) * n_words : nullptr};
  int32_t* out = flat + int64_t(b) * out_cap;
  const int64_t slot0 = int64_t(b) * max_sets;

  uint32_t* words = vis.words();
  for (int64_t i = tid; i < n_words; i += kThreads) words[i] = 0u;
  int parity = 0;                               // warp_count's buffer
  int32_t tail = 0, done = 0;                   // the same in every thread
  bool over = false;
  while (done < max_sets) {
    if (tid == 0) claimed = atomicAdd(counter, 1);
    __syncthreads();              // also orders the visited words' zeros
    const int32_t r = claimed;
    if (r >= quota) break;
    if (tail >= out_cap) {        // no room for the root
      over = true;
      break;
    }
    const uint32_t seed = counter_uniform_u32(round_seed, uint32_t(r));
    const int32_t root = draw_root(seed, n, alias_prob, alias_node);
    int32_t* q = out + tail;
    if (tid == 0) {
      vis.mark(root);
      q[0] = root;
      sh.mirror[0] = root;
    }
    __syncthreads();
    int32_t len = 1;
    bool set_over = false;
    int64_t set_steps = 0;
    lane_bfs<kDedup>(offsets, indices, weights, seed, ec, out_cap - tail, q,
                     vis, sh, parity, len, set_over, set_steps);
    if (set_over) {
      over = true;
      break;
    }
    // the next set starts from clear bits: zero the words of this set's
    // nodes (written before lane_bfs's last barrier)
    for (int32_t i = tid; i < len; i += kThreads) vis.clear_word(q[i]);
    if (tid == 0) {
      lengths[slot0 + done] = len;
      rows[slot0 + done] = r;
      row_steps[slot0 + done] = set_steps;
    }
    ++done;
    tail += len;
    // the claim's barrier at the top of the loop orders the zeros (and
    // the read of `claimed`) before the next set
  }
  for (int32_t j = done + tid; j < max_sets; j += kThreads) {
    lengths[slot0 + j] = 0;
    rows[slot0 + j] = -1;
    row_steps[slot0 + j] = 0;
  }
  zero_tail(out, tail, out_cap);                // zeros past the sets
  if (tid == 0) {
    n_done[b] = done;
    overflowed[b] = over;
  }
}

template <int kDedup>
cudaError_t launch(unsigned grid, size_t shared, cudaStream_t stream,
                   const void* offsets, const void* indices,
                   const void* weights, uint32_t round_seed, int32_t n,
                   int32_t out_cap, int64_t ec, int64_t n_words,
                   int32_t quota, int32_t max_sets, void* flat,
                   void* visited, void* counter, void* lengths, void* n_done,
                   void* overflowed, void* rows, void* row_steps,
                   const void* prob, const void* alias) {
  auto kernel = refill_bfs_kernel<kDedup>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, shared, stream>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights), round_seed, n, out_cap, ec,
      n_words, quota, max_sets, static_cast<int32_t*>(flat),
      static_cast<uint32_t*>(visited), static_cast<int32_t*>(counter),
      static_cast<int32_t*>(lengths), static_cast<int32_t*>(n_done),
      static_cast<bool*>(overflowed), static_cast<int32_t*>(rows),
      static_cast<int64_t*>(row_steps), static_cast<const float*>(prob),
      static_cast<const int32_t*>(alias));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  offsets: n + 1 int32, indices and
// weights: m int32 / float32 (m < 2^31); round_seed: the round's 32-bit
// seed; lanes: the grid; flat: lanes x out_cap int32 (written in full);
// visited: null, for the bits in shared memory (4 * ceil(n / 32) <=
// kMaxSharedVisitedBytes), or lanes x ceil(n / 32) uint32 scratch (zeroed
// by the kernel); counter: one int32, zero at the launch; lengths, rows
// (int32) and row_steps (int64): lanes x max_sets each (written in full);
// n_done (int32), overflowed (bool): lanes each; prob, alias: null for
// uniform roots, or an alias table of n float32 / int32 (alias values in
// [0, n)), both or neither; dedup: 0 none, 1 segmented, 2 sort.  n >= 1,
// out_cap >= 1, ec >= 1, quota >= 0, max_sets >= 1, lanes < 2^31.
// Launches on `stream` of card `device`; returns the cudaError_t of the
// launch.
extern "C" int refill_bfs(const void* offsets, const void* indices,
                          const void* weights, uint32_t round_seed,
                          int64_t lanes, int32_t n, int32_t out_cap,
                          int64_t ec, int32_t quota, int32_t max_sets,
                          void* flat, void* visited, void* counter,
                          void* lengths, void* n_done, void* overflowed,
                          void* rows, void* row_steps, const void* prob,
                          const void* alias, int dedup, int device,
                          void* stream) {
  if (lanes <= 0) return int(cudaGetLastError());
  if (n < 1 || out_cap < 1 || ec < 1 || quota < 0 || max_sets < 1 ||
      lanes > 0x7FFFFFFF || dedup < kNone || dedup > kSort ||
      (prob == nullptr) != (alias == nullptr))
    return int(cudaErrorInvalidValue);
  const int64_t n_words = (int64_t(n) + 31) / 32;
  const int64_t shared = visited ? 0 : 4 * n_words;
  if (shared > kMaxSharedVisitedBytes) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  auto go = dedup == kSegmented ? launch<kSegmented>
            : dedup == kSort    ? launch<kSort>
                                : launch<kNone>;
  return int(go(unsigned(lanes), size_t(shared),
                static_cast<cudaStream_t>(stream), offsets, indices, weights,
                round_seed, n, out_cap, ec, n_words, quota, max_sets, flat,
                visited, counter, lengths, n_done, overflowed, rows,
                row_steps, prob, alias));
}
