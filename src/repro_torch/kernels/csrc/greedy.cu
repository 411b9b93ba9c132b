// Greedy max-coverage on the flat RR pool (paper Alg. 7, the reference's
// fused scan): all k seed steps in one cooperative launch, for Hopper
// (sm_90a).
//
// Replaces the torch selection's host loop (kernels/ref.py::greedy_flat_ref,
// the plain version: about 25 device operations a step, among them two
// scatter-adds over the whole pool and a popcount_words launch).  The JAX
// reference runs the same scan as plain XLA (src/repro/core/coverage.py:1359,
// the fused scan): it has no Pallas kernel.
//
// What it computes, seed for seed and gain for gain as the plain version.
// Occur[v] starts as the number of rows that hold node v.  Step s takes
// u_s, the first maximum of Occur (the lowest id on ties; 0 when Occur is
// all zero), marks as covered the rows that hold u_s and are not covered
// yet, and takes one off Occur at each valid element of each such row.
// The elements of a row are unique, so Occur[v] is at every step the
// number of uncovered rows that hold v, and the gain of step s (the rows
// it newly covers) is Occur[u_s] at its argmax: gains[s] is read off the
// argmax's key, and no step counts rows.
//
// Inputs (kernels/greedy.py::flat_index builds them with torch on the
// card): the elements nodes[row_start[r]:row_start[r+1]] of each row r
// (invalid ones as n, which no step touches) and the rows
// inv_rows[inv_start[v]:inv_start[v+1]] that hold each node v.
//
// Design.  One cooperative launch (cudaLaunchCooperativeKernel): by
// default one block of kThreads on each SM (the caller may ask for more,
// up to what stays resident), the k steps inside it separated by grid
// barriers (cooperative_groups' grid sync: a release add and acquire polls
// on one counter in a workspace that the cooperative launch provides, so
// no -rdc is needed).
// - Phase 0: Occur[v] = inv_start[v+1] - inv_start[v], Covered and the
//   step keys zeroed.  Barrier.
// - Argmax of step s: each thread folds its grid-strided slice of Occur
//   into one (occur, ~v) pair, a warp reduces with two redux.sync (the
//   largest occur, then the largest ~v among the lanes that hold it), a
//   block likewise over its warps, and each block makes one atomicMax of
//   the 64-bit key (occur << 32) | (0xFFFFFFFF - v) into the step's own
//   slot keys[s], so no slot is reset between steps.  Barrier.
// - Cover of step s: every block reads u_s from keys[s].  Each of u_s's
//   rows has one owner, a warp (a row appears once in u_s's list); if the
//   row is not covered yet, lane 0 sets its flag and the lanes take one
//   off Occur at each of its elements by atomicSub, 32 at a time.
//   Barrier, except after the last step.
// So a launch runs 2k grid barriers, and a step's work is u_s's rows and
// their elements, not the pool.  Occur (n int32: 303,516 bytes at n =
// 75,879), the keys and Covered live in global memory and stay in L2;
// what the kernel itself writes it reads with __ldcg (from L2, never a
// stale L1 line).  Covered is a byte a row: a row has one owner a step,
// so its flag is a plain load and store, where bits would need an
// atomicOr (two rows of one word have different owners).
//
// What bounds it.  Not bytes: Occur read once a step, u_s's rows and
// their elements, and the indices once come to about 16 MB at k = 50,
// 0.005 ms at 3.35 TB/s.  The 2k grid barriers and a step's chain of
// dependent loads (inv_rows, then Covered and row_start, then nodes) set
// its time; greedy_grid_barriers runs the same grid with the barriers
// alone, the floor.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

// The warp's first maximum as the key (occur << 32) | low, low = 0xFFFFFFFF
// - v; a lane that holds no node passes 0, below every node's key.
__device__ __forceinline__ uint64_t warp_max_key(uint32_t occ, uint32_t low) {
  const uint32_t best = __reduce_max_sync(kFullMask, occ);
  const uint32_t first = __reduce_max_sync(kFullMask, occ == best ? low : 0u);
  return (uint64_t(best) << 32) | first;
}

// The block's first maximum of its threads' (occ, low) pairs, in thread
// 0 (the others get an undefined value).  `red` is reused after a barrier.
__device__ __forceinline__ uint64_t block_max_key(uint32_t occ, uint32_t low,
                                                  uint64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t key = warp_max_key(occ, low);
  if (lane == 0) red[warp] = key;
  __syncthreads();
  if (warp == 0) {
    const uint64_t w = lane < kWarps ? red[lane] : 0;
    key = warp_max_key(uint32_t(w >> 32), uint32_t(w));
  }
  return key;
}

__global__ void __launch_bounds__(kThreads)
greedy_flat_kernel(const int32_t* __restrict__ nodes,
                   const int32_t* __restrict__ row_start,
                   const int32_t* __restrict__ inv_start,
                   const int32_t* __restrict__ inv_rows, int32_t n,
                   int64_t num_rows, int32_t k, unsigned long long* keys,
                   int32_t* occur, uint8_t* covered, int32_t* seeds,
                   int32_t* gains) {
  __shared__ uint64_t red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t gtid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gsize = int64_t(gridDim.x) * kThreads;
  const int64_t gwarp = gtid >> 5, nwarps = gsize >> 5;

  for (int64_t v = gtid; v < n; v += gsize)
    occur[v] = __ldg(inv_start + v + 1) - __ldg(inv_start + v);
  for (int64_t r = gtid; r < num_rows; r += gsize) covered[r] = 0;
  for (int64_t s = gtid; s < k; s += gsize) keys[s] = 0;
  grid.sync();

  for (int32_t s = 0; s < k; ++s) {
    // argmax: v ascends in a thread's slice, so a later v wins only when
    // its count is larger; low == 0 marks an empty slice (v < 2^31 - 1)
    uint32_t occ = 0, low = 0;
    for (int64_t v = gtid; v < n; v += gsize) {
      const uint32_t o = uint32_t(__ldcg(occur + v));
      if (low == 0 || o > occ) {
        occ = o;
        low = 0xFFFFFFFFu - uint32_t(v);
      }
    }
    const uint64_t best = block_max_key(occ, low, red);
    if (threadIdx.x == 0 && best != 0) atomicMax(keys + s, best);
    grid.sync();

    // cover: a warp owns each of u's rows
    const unsigned long long key = __ldcg(keys + s);
    const int32_t u = int32_t(0xFFFFFFFFu - uint32_t(key));
    if (gtid == 0) {
      seeds[s] = u;
      gains[s] = int32_t(key >> 32);
    }
    const int32_t end = __ldg(inv_start + u + 1);
    for (int64_t i = __ldg(inv_start + u) + gwarp; i < end; i += nwarps) {
      const int32_t r = __ldg(inv_rows + i);
      const int32_t e0 = __ldg(row_start + r), e1 = __ldg(row_start + r + 1);
      uint32_t fresh = 0;
      if (lane == 0) {
        fresh = __ldcg(covered + r) == 0;
        if (fresh) covered[r] = 1;
      }
      if (__shfl_sync(kFullMask, fresh, 0)) {
        for (int32_t e = e0 + lane; e < e1; e += 32) {
          const uint32_t v = uint32_t(__ldg(nodes + e));
          if (v < uint32_t(n)) atomicSub(occur + v, 1);
        }
      }
    }
    if (s + 1 < k) grid.sync();
  }
}

// The same grid with its barriers alone: the floor of greedy_flat_kernel.
__global__ void __launch_bounds__(kThreads) grid_barriers_kernel(int32_t count) {
  cg::grid_group grid = cg::this_grid();
  for (int32_t i = 0; i < count; ++i) grid.sync();
}

// greedy_flat_kernel's grid on card `device`: blocks_per_sm blocks on each
// SM (0: as many as stay resident, which also caps a larger request).  The
// SM count and the resident blocks are read once a card.
cudaError_t grid_for(int blocks_per_sm, int device, int* blocks) {
  static int sms[kMaxDevices], resident[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int coop = 0, count = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, greedy_flat_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    sms[device] = count;
    resident[device] = per_sm;
  }
  const int per_sm = blocks_per_sm > 0 ? min(blocks_per_sm, resident[device])
                                       : resident[device];
  *blocks = per_sm * sms[device];
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes.  nodes: t int32 (invalid elements as n);
// row_start: num_rows + 1 int32; inv_start: n + 1 int32; inv_rows: t
// int32.  scratch: 8 * k + 4 * n + num_rows bytes (the keys, Occur and
// Covered; the kernel initialises them); out: 2 * k int32, seeds then
// gains.  1 <= n < 2^31 - 1, 1 <= num_rows < 2^31, k >= 1.  Launches on
// `stream` of card `device`; returns the cudaError_t of the launch.
extern "C" int greedy_flat(const void* nodes, const void* row_start,
                           const void* inv_start, const void* inv_rows,
                           int32_t n, int64_t num_rows, int32_t k,
                           void* scratch, void* out, int blocks_per_sm,
                           int device, void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || num_rows < 1 || num_rows > 0x7FFFFFFF ||
      k < 1)
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  cudaError_t err = grid_for(blocks_per_sm, device, &blocks);
  if (err != cudaSuccess) return int(err);
  const int32_t* p_nodes = static_cast<const int32_t*>(nodes);
  const int32_t* p_row_start = static_cast<const int32_t*>(row_start);
  const int32_t* p_inv_start = static_cast<const int32_t*>(inv_start);
  const int32_t* p_inv_rows = static_cast<const int32_t*>(inv_rows);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  int32_t* occur = reinterpret_cast<int32_t*>(base + 8 * int64_t(k));
  uint8_t* covered = base + 8 * int64_t(k) + 4 * int64_t(n);
  int32_t* seeds = static_cast<int32_t*>(out);
  int32_t* gains = seeds + k;
  void* args[] = {&p_nodes, &p_row_start, &p_inv_start, &p_inv_rows, &n,
                  &num_rows, &k, &keys, &occur, &covered, &seeds, &gains};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(greedy_flat_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// greedy_flat's grid running `count` grid barriers and nothing else.
extern "C" int greedy_grid_barriers(int32_t count, int blocks_per_sm,
                                    int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  cudaError_t err = grid_for(blocks_per_sm, device, &blocks);
  if (err != cudaSuccess) return int(err);
  void* args[] = {&count};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_barriers_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The blocks of greedy_flat's grid on card `device`, into *blocks.
extern "C" int greedy_grid_blocks(int blocks_per_sm, int device,
                                  int* blocks) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(grid_for(blocks_per_sm, device, blocks));
}
