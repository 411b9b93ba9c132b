// The LT-model RR sampler (paper §3.7): one launch a sampling round, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX reference runs the walk as one jitted
// lax.while_loop in plain XLA (src/repro/core/lt.py:53-112, _sample_lt:
// a vectorised bisection over the row's cumulative weights a step); the
// plain version here is kernels/ref.py::lt_round_ref (row seeds, roots,
// then lt_walk_ref, which syncs the host once a draw).  The paper's GPU
// sampler does the in-edge choice as a warp-parallel scan of the row; this
// kernel keeps that warp and turns the scan into a 32-way search of the
// precomputed cumulative weights.
//
// What it computes, lane for lane and byte for byte as the plain version.
// Lane b draws its row seed s = counter_uniform_u32(round_seed, b) and its
// root exactly as queue.cu does (a bucket from the counter 0xFFFFFFFF and,
// with an alias table, the accept draw on 0xFFFFFFFE).  Standing on node
// cur with in-row [e0, e1), its draw number t (0, 1, ...) is u =
// float32(counter_uniform_u32(s, t)) * 2^-32.  The walk stops when the row
// is empty or u >= rowcum[e1 - 1]; else it takes edge j, the smallest in
// [e0, e1) with rowcum[j] > u, and stops when indices[j] is on the walk
// already, or, with overflowed set, when the walk holds qcap nodes; else
// indices[j] joins the walk.  The walk row is zero past its length.
// steps[b] is the lane's draws (t at its end).  rowcum must rise within a
// row (weights >= 0, as LT's are), where the 32-way search and the
// reference's bisection find the same j.
//
// Design.  A walk is a chain of dependent loads: offsets[cur] (and the
// row's end), then the row's cumulative weights, then indices[j], then
// the revisit test, and only then the next node.  So the round is bound by
// latency, not bytes: its time is its longest lane's chain.  The kernel
// keeps that chain short and many chains in flight.
// - A warp walks a lane, kLanes lanes a block, so the lanes spread over
//   the SMs (128 blocks at B = 512) and each SM keeps several chains in
//   flight; no barrier joins two walks.
// - The search is 32-way: each lane of the warp loads one probe of the
//   row's cumulative weights, one ballot says which 32nd of the row holds
//   j, and the next round searches that part.  A row of at most 32 edges
//   takes one load round (its last probe is also the row's total, so the
//   stop test costs no load of its own); the stand-in's hub rows of about
//   42,000 edges take four, where a bisection takes sixteen.
// - The revisit test scans the walk so far, 32 entries a round, from a
//   copy of its first kMirror entries that the warp keeps in shared memory
//   (kMirror x 4 bytes a warp), and from the walk row past them.  Of the
//   three choices for the visited set (a scan of the walk, a small hash a
//   lane in shared memory, or queue.cu's bit set of ceil(n / 32) words a
//   lane), the scan needs no clearing and no state but the walk itself, and
//   it costs ceil(L / 32) shared-memory reads a step, which at the walks'
//   lengths (tens of nodes under WC weights on the stand-in) is far below
//   one global load; a bit set would cost 9.5 KB a lane of zeroing at the
//   stand-in, more than the walk.  The scan's cost grows as L^2 / 32 for a
//   walk of length L, which only matters for walks of thousands of nodes.
// - The walks' zeros past their lengths are the round's bytes, and one
//   warp a row cannot keep enough stores in flight for them: once its
//   kLanes walks end (a barrier), the block's kThreads threads write all
//   their zeros, in 16-byte evict-first stores.
//
// What bounds it.  Bytes: the walk rows (B x qcap int32, written once: 155
// MB at B = 512, qcap = n at the stand-in) dominate, the reads are a few
// words a step.  Latency: the longest lane's chain of dependent global
// loads, 2 + (search rounds) a step; chip_smoke.py counts that chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kLanes = 4;                        // lanes (walks) a block
constexpr int kThreads = 512;                    // the zeros' writers
constexpr int kMirror = 1024;                    // walk entries in shared
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kRootCounter = 0xFFFFFFFFu;   // core/roots.py ROOT_COUNTER
constexpr uint32_t kAliasCounter = 0xFFFFFFFEu;  // core/roots.py ALIAS_COUNTER

// The smallest j in [lo, hi) with rowcum[j] > u, in every lane of the warp,
// or -1 when there is none (an empty row, or u >= rowcum[hi - 1]).  Each
// round loads 32 probes; probe i of a part of len > 32 entries is its
// entry ((i + 1) * len) / 32 - 1, so probe 31 is the part's last entry.
__device__ __forceinline__ int32_t pick_edge(const float* __restrict__ rowcum,
                                             int32_t lo, int32_t hi, float u,
                                             int lane) {
  while (hi > lo) {
    const int32_t len = hi - lo;
    const int32_t p =
        len <= 32 ? lo + lane
                  : lo + int32_t((int64_t(lane + 1) * len) >> 5) - 1;
    const bool above = (len > 32 || lane < len) && __ldg(rowcum + p) > u;
    const unsigned mask = __ballot_sync(kFullMask, above);
    // none above: only in the first round, where the last probe is the
    // row's total
    if (mask == 0) return -1;
    const int f = __ffs(mask) - 1;
    const int32_t pf = __shfl_sync(kFullMask, p, f);
    if (len <= 32) return pf;
    const int32_t before = __shfl_sync(kFullMask, p, f > 0 ? f - 1 : 0);
    lo = f > 0 ? before + 1 : lo;
    hi = pf + 1;
  }
  return -1;
}

// Lane b's walk by one warp: its row seed and root, the walk into q, its
// length (also into *walked), overflow flag and draws.
__device__ __forceinline__ void walk_lane(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
    const float* __restrict__ rowcum, uint32_t round_seed, int64_t b,
    int32_t n, int32_t qcap, int32_t* __restrict__ q, int32_t* mir,
    int lane, int32_t* __restrict__ roots, int32_t* __restrict__ lengths,
    bool* __restrict__ overflowed, int64_t* __restrict__ steps,
    const float* __restrict__ alias_prob,
    const int32_t* __restrict__ alias_node, int32_t* walked) {
  // the row seed and root, in every lane, as queue.cu draws them
  const uint32_t seed = counter_uniform_u32(round_seed, uint32_t(b));
  int32_t root = int32_t(
      (uint64_t(counter_uniform_u32(seed, kRootCounter)) * uint32_t(n)) >> 32);
  if (alias_prob != nullptr &&
      !(__uint2float_rn(counter_uniform_u32(seed, kAliasCounter)) * 0x1p-32f <
        __ldg(alias_prob + root)))
    root = __ldg(alias_node + root);
  if (lane == 0) {
    q[0] = root;
    mir[0] = root;
    roots[b] = root;
  }
  __syncwarp();

  int32_t cur = root, len = 1;              // the same in every lane
  uint32_t t = 0;                           // draws so far
  bool over = false;
  while (true) {
    const float u = __uint2float_rn(counter_uniform_u32(seed, t)) * 0x1p-32f;
    ++t;
    const int32_t j = pick_edge(rowcum, __ldg(offsets + cur),
                                __ldg(offsets + cur + 1), u, lane);
    if (j < 0) break;
    const int32_t v = __ldg(indices + j);
    // the revisit test: v among the walk's len entries, 32 a round
    bool seen = false;
    for (int32_t i0 = 0; i0 < len && !seen; i0 += 32) {
      const int32_t i = i0 + lane;
      const int32_t x = i >= len ? -1 : i < kMirror ? mir[i] : __ldcg(q + i);
      seen = __any_sync(kFullMask, x == v);
    }
    if (seen) break;
    if (len >= qcap) {
      over = true;
      break;
    }
    if (lane == 0) {
      q[len] = v;
      if (len < kMirror) mir[len] = v;
    }
    __syncwarp();                           // orders the write before reads
    ++len;
    cur = v;
  }
  if (lane == 0) {
    lengths[b] = len;
    overflowed[b] = over;
    steps[b] = t;
    *walked = len;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lt_walk_kernel(const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ indices,
               const float* __restrict__ rowcum, uint32_t round_seed,
               int64_t batch, int32_t n, int32_t qcap,
               int32_t* __restrict__ walk, int32_t* __restrict__ roots,
               int32_t* __restrict__ lengths, bool* __restrict__ overflowed,
               int64_t* __restrict__ steps,
               const float* __restrict__ alias_prob,
               const int32_t* __restrict__ alias_node) {
  __shared__ int32_t mirror[kLanes][kMirror];
  __shared__ int32_t walked[kLanes];        // the lanes' lengths
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t b = int64_t(blockIdx.x) * kLanes + w;
  if (w < kLanes && b < batch) walk_lane(offsets, indices, rowcum, round_seed,
                                         b, n, qcap, walk + b * qcap,
                                         mirror[w], lane, roots, lengths,
                                         overflowed, steps, alias_prob,
                                         alias_node, &walked[w]);
  __syncthreads();
  // zeros past each length: 16-byte evict-first stores between a 4-byte
  // head and tail (a row is 16-byte aligned only where b * qcap is)
  for (int r = 0; r < kLanes; ++r) {
    const int64_t br = int64_t(blockIdx.x) * kLanes + r;
    if (br >= batch) break;
    int32_t* q = walk + br * qcap;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(q + walked[r]);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(q + qcap);
    const uintptr_t a = min(hi, (lo + 15) & ~uintptr_t(15));
    const uintptr_t z = max(a, hi & ~uintptr_t(15));
    for (uintptr_t p = lo + 4 * threadIdx.x; p < a; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);
    for (uintptr_t p = a + 16 * threadIdx.x; p < z; p += 16 * kThreads)
      __stcs(reinterpret_cast<int4*>(p), make_int4(0, 0, 0, 0));
    for (uintptr_t p = z + 4 * threadIdx.x; p < hi; p += 4 * kThreads)
      __stcs(reinterpret_cast<int32_t*>(p), 0);
  }
}

}  // namespace

// Plain C interface for ctypes.  offsets: n + 1 int32, indices and rowcum:
// m int32 / float32 (m < 2^31; rowcum rising within each row); round_seed:
// the round's 32-bit seed; walk: batch x qcap int32 (written in full);
// roots, lengths (int32), overflowed (bool), steps (int64): batch each;
// prob, alias: null for uniform roots, or an alias table of n float32 /
// int32 (alias values in [0, n)), both or neither.  n >= 1, qcap >= 1,
// batch < 2^31.  Launches on `stream` of card `device`; returns the
// cudaError_t of the launch.
extern "C" int lt_walk(const void* offsets, const void* indices,
                       const void* rowcum, uint32_t round_seed, int64_t batch,
                       int32_t n, int32_t qcap, void* walk, void* roots,
                       void* lengths, void* overflowed, void* steps,
                       const void* prob, const void* alias, int device,
                       void* stream) {
  if (batch <= 0) return int(cudaGetLastError());
  if (n < 1 || qcap < 1 || batch > 0x7FFFFFFF ||
      (prob == nullptr) != (alias == nullptr))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const unsigned blocks = unsigned((batch + kLanes - 1) / kLanes);
  lt_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(rowcum), round_seed, batch, n, qcap,
      static_cast<int32_t*>(walk), static_cast<int32_t*>(roots),
      static_cast<int32_t*>(lengths), static_cast<bool*>(overflowed),
      static_cast<int64_t*>(steps), static_cast<const float*>(prob),
      static_cast<const int32_t*>(alias));
  return int(cudaGetLastError());
}
