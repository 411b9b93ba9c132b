// Greedy max-coverage in one cooperative launch each, for Hopper (sm_90a):
// greedy_flat on the flat RR pool (paper Alg. 7, the reference's fused
// scan) and, further down, greedy_sketch on the approximate mode's
// coverage sketch.  Both run all k seed steps inside the launch.
//
// greedy_flat.
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

// greedy_sketch: the approximate mode's greedy on sketch estimates
// (core/coverage.py::select_seeds_sketch), all k steps in one cooperative
// launch.
//
// Replaces the torch selection's host loop, which launched
// sketch_union_popcount (csrc/sketch.cu) and popcount_words (csrc/
// bitops.cu) and read (u, score[u]) back every step; its plain version is
// kernels/ref.py::greedy_sketch_ref.  The JAX reference runs the same
// greedy as a host loop of XLA sweeps (src/repro/core/coverage.py:2223,
// select_seeds_sketch), each sweep the Pallas kernel
// src/repro/kernels/sketch.py::sketch_union_popcount.
//
// What it computes, seed for seed and gain for gain as the plain version.
// The sketch is (R, W) words, rows v < n the nodes'.  cov starts at zero.
// Step s: delta(v) = popcount(sk[v] | cov) - popcount(cov); u_s is the
// first maximum of delta over the nodes not picked yet (the lowest id on
// ties); with no node left the greedy stops.  Otherwise seeds[s] = u_s,
// gains[s] = delta(u_s), u_s is picked and cov |= sk[u_s].  The steps not
// taken get seed n and gain 0, and out[2k] is the number of steps taken.
//
// Design.  One block of kThreads on each SM, cooperative, as greedy_flat.
// - popcount(cov) is the sum of the gains taken so far (cov starts at 0 and
//   each gain is the bits it adds), so each thread keeps it as a running
//   sum `base` and no step counts cov.
// - Each block keeps its own copy of cov: in dynamic shared memory when W
//   words fit (the attribute is raised once a card), else in its own slice
//   of the scratch, read through L1/L2.  After the argmax barrier of step
//   s every block reads u_s off the step's key and ORs sk[u_s] into its own
//   copy, so nothing that another block reads is written between two
//   barriers except the step's key slot, by atomicMax before the barrier:
//   one grid barrier a step, k + 1 in all.
// - Rows: a group of `lanes` lanes owns rows group, group + G, ... (G the
//   grid's groups): a thread a row at W <= 4 (one 16-byte load at W = 4),
//   else the least power of two >= the row's loads, at most 32, striding
//   over the row (16 bytes a load when W % 4 == 0 and the words are
//   16-byte aligned) and summing with shuffles; the wrapper chooses
//   (kernels/greedy.py::sketch_layout).  The sketch is read with __ldg: the
//   launch never writes it, and a block's rows stay in its SM's L1 from one
//   step to the next where they fit.
// - The argmax key is greedy_flat's with the score shifted by one:
//   ((delta + 1) << 32) | (0xFFFFFFFF - v), atomicMax'ed into the step's own
//   slot (zeroed in phase 0).  A picked node takes no part, so a step whose
//   key has a high word of 0 found no node: every block reads the same key
//   and leaves at the same step, and the barrier counts agree.
// - picked[v] is written and read by one thread only, the first lane of
//   v's group, so it needs no barrier.
//
// What bounds it.  Each step reads the n sketch rows (1.21 MB at the
// approximate cell, 75,880 x 4 words; it stays in L2) and does an OR, a
// popcount and an add a word: a few microseconds of the whole card.  The
// k + 1 grid barriers (about 1.2 us each on the H100) and each step's
// chain (the argmax, the barrier, the key, then sk[u_s]) set its time;
// greedy_grid_barriers runs the same grid with the barriers alone.

__device__ __forceinline__ uint32_t popc_or4(uint4 x, uint4 c) {
  return __popc(x.x | c.x) + __popc(x.y | c.y) + __popc(x.z | c.z) +
         __popc(x.w | c.w);
}

template <bool kSharedCov>
__global__ void __launch_bounds__(kThreads)
greedy_sketch_kernel(const uint32_t* __restrict__ sk, int32_t n, int32_t cols,
                     int32_t lanes, bool vector, int32_t k,
                     unsigned long long* keys, uint8_t* picked,
                     uint32_t* cov_copies, int32_t* out) {
  extern __shared__ uint4 s_cov4[];
  __shared__ uint64_t red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t(cols) + 3) & ~int64_t(3);
  uint32_t* cov = kSharedCov ? reinterpret_cast<uint32_t*>(s_cov4)
                             : cov_copies + int64_t(blockIdx.x) * stride;
  const uint4* cov4 = reinterpret_cast<const uint4*>(cov);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);          // lane within the row group
  const int rows_per_warp = 32 / lanes;
  const int64_t gtid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gsize = int64_t(gridDim.x) * kThreads;
  const int64_t gwarp = gtid >> 5, nwarps = gsize >> 5;
  const int64_t group = gtid / lanes, groups = gsize / lanes;

  for (int w = threadIdx.x; w < cols; w += kThreads) cov[w] = 0;
  for (int64_t s = gtid; s < k; s += gsize) keys[s] = 0;
  if (sub == 0)
    for (int64_t v = group; v < n; v += groups) picked[v] = 0;
  grid.sync();

  uint32_t base = 0;                           // popcount(cov)
  int32_t s = 0;
  for (; s < k; ++s) {
    // argmax: the rows of a group ascend, so a later row wins only when its
    // score is larger; low == 0 marks a slice with no candidate.  Every
    // lane of a warp runs the same iterations, so the full-mask shuffles
    // see the whole warp.
    uint32_t best = 0, low = 0;
    for (int64_t r0 = gwarp * rows_per_warp; r0 < n;
         r0 += nwarps * rows_per_warp) {
      const int64_t v = r0 + lane / lanes;
      uint32_t cnt = 0;
      if (v < n) {
        const uint32_t* row = sk + v * cols;
        if (vector) {
          const uint4* row4 = reinterpret_cast<const uint4*>(row);
          for (int q = sub; q < cols / 4; q += lanes)
            cnt += popc_or4(__ldg(row4 + q), cov4[q]);
        } else {
          for (int w = sub; w < cols; w += lanes)
            cnt += __popc(__ldg(row + w) | cov[w]);
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1)
        cnt += __shfl_down_sync(kFullMask, cnt, off, lanes);
      if (sub == 0 && v < n && !picked[v]) {
        const uint32_t score = cnt - base + 1;
        if (low == 0 || score > best) {
          best = score;
          low = 0xFFFFFFFFu - uint32_t(v);
        }
      }
    }
    const uint64_t top = block_max_key(best, low, red);
    if (threadIdx.x == 0 && top != 0) atomicMax(keys + s, top);
    grid.sync();

    const unsigned long long key = __ldcg(keys + s);
    if ((key >> 32) == 0) break;               // no node left
    const uint32_t u = 0xFFFFFFFFu - uint32_t(key);
    const uint32_t gain = uint32_t(key >> 32) - 1;
    if (gtid == 0) {
      out[s] = int32_t(u);
      out[k + s] = int32_t(gain);
    }
    if (gtid == (int64_t(u) % groups) * lanes) picked[u] = 1;
    base += gain;
    const uint32_t* row = sk + int64_t(u) * cols;
    for (int w = threadIdx.x; w < cols; w += kThreads) cov[w] |= __ldg(row + w);
    __syncthreads();
  }
  if (gtid == 0) out[2 * k] = s;
  for (int64_t j = s + gtid; j < k; j += gsize) {
    out[j] = n;
    out[k + j] = 0;
  }
}

// greedy_sketch_kernel's grid on card `device`, read once a card: one
// block on each SM, and the widest cov (in words) that its dynamic shared
// memory holds.  The first call raises the shared-memory kernel's dynamic
// limit to all that a block may have beside its static shared memory, and
// checks that a block of each form stays resident at its largest shared
// memory.
cudaError_t sketch_grid_for(int device, int* blocks, int64_t* shared_words) {
  static int sms[kMaxDevices];
  static int64_t words[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    int coop = 0, count = 0, optin = 0, resident = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, greedy_sketch_kernel<true>);
    if (err != cudaSuccess) return err;
    const int bytes = (optin - int(attr.sharedSizeBytes)) & ~15;
    err = cudaFuncSetAttribute(greedy_sketch_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, greedy_sketch_kernel<true>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, greedy_sketch_kernel<false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
    words[device] = bytes / 4;
    sms[device] = count;
  }
  *blocks = sms[device];
  *shared_words = words[device];
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

// greedy_sketch_kernel's grid on card `device`: its blocks, and the widest
// cov in words that stays in shared memory (a wider one takes the scratch
// copies below).
extern "C" int greedy_sketch_grid(int device, int* blocks,
                                  int64_t* shared_words) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(sketch_grid_for(device, blocks, shared_words));
}

// Plain C interface for ctypes.  words: the sketch, rows of `cols` uint32
// (rows v < n are read; 1 <= n < 2^31 - 1, 1 <= cols < 2^26); lanes: a
// power of two in [1, 32]; vector: 16-byte loads (cols % 4 == 0, words
// 16-byte aligned); k >= 1.  scratch: the keys (8k bytes), picked (n
// bytes) and, when cols exceeds greedy_sketch_grid's shared_words, a copy
// of cov for each block (blocks x round_up(cols, 4) uint32 from the next
// 16-byte boundary); the kernel initialises what it reads.  out: 2k + 1
// int32, seeds, gains, then the steps taken.  Launches on `stream` of card
// `device`; returns the cudaError_t of the launch.
extern "C" int greedy_sketch(const void* words, int32_t n, int32_t cols,
                             int lanes, int vector, int32_t k, void* scratch,
                             void* out, int device, void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || cols < 1 || cols >= (1 << 26) || k < 1 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (vector && (cols % 4 != 0 ||
                  (reinterpret_cast<uintptr_t>(words) & 15u) != 0)))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_words = 0;
  cudaError_t err = sketch_grid_for(device, &blocks, &shared_words);
  if (err != cudaSuccess) return int(err);
  const uint32_t* p_words = static_cast<const uint32_t*>(words);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  uint8_t* picked = base + 8 * int64_t(k);
  const int64_t copies = (8 * int64_t(k) + n + 15) & ~int64_t(15);
  uint32_t* cov_copies = reinterpret_cast<uint32_t*>(base + copies);
  int32_t* p_out = static_cast<int32_t*>(out);
  bool vec = vector != 0;
  void* args[] = {&p_words, &n, &cols, &lanes, &vec, &k, &keys, &picked,
                  &cov_copies, &p_out};
  const int64_t stride = (int64_t(cols) + 3) & ~int64_t(3);
  if (stride <= shared_words) {
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(greedy_sketch_kernel<true>),
        dim3(blocks), dim3(kThreads), args, size_t(stride) * 4,
        static_cast<cudaStream_t>(stream));
  } else {
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(greedy_sketch_kernel<false>),
        dim3(blocks), dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
