// RR-set membership scan of the padded-store greedy, and that whole greedy
// in one cooperative launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference:
//   src/repro/kernels/membership.py: membership_rows (_membership_kernel)
// membership_rows is its counterpart call for call; padded_greedy is its
// counterpart on its one path, the reference's select_seeds_padded
// (src/repro/core/coverage.py:2510), which scans with it once a seed.
//
// membership_rows: hit[r] = any(rows[r, :len_r] == u), with len_r =
//   lengths[r] clamped to [0, L].  rows is (R, L) int32, padded past each
//   length (with n in the store); lanes at or past len_r are never read, so
//   the result does not depend on what the padding holds.
//   What bounds it: bytes.  It must read the 32-byte sectors of each row's
//   valid prefix, the lengths, and write R bytes; one compare per element
//   read.  The padded matrix is far larger: mean RR size is about 4 on the
//   exact cell, so a row of L >= 128 lanes is over 96% padding.
//   Design.  The Pallas kernel compares a whole (BR, L) tile, padding and
//   all, because the TPU wants rectangular blocks.  Here a group of 8 lanes
//   owns one row (8 int32 = one 32-byte sector a step) and walks only
//   [0, len_r); a warp scans 4 rows at once, and one ballot per warp
//   gathers the 4 answers.  u is a value of the call, or is read from
//   device memory (the counterpart of the TPU kernel's SMEM scalar), so a
//   caller whose u comes from an argmax on the card needs no host sync.
//
// padded_greedy: all k steps of the padded store's greedy (the plain loop
//   is kernels/ref.py::padded_greedy_ref), seed for seed and gain for gain.
//   Occur[v] starts as the number of valid lanes that hold v (a node twice
//   in a row counts twice).  Step s takes u_s, the first maximum of Occur
//   over all n nodes (picked nodes are not left out: once Occur is all
//   zero it is node 0, gain 0, again); the rows that hold u_s and are not
//   covered yet are newly covered, gains[s] is their number, and each of
//   their valid lanes takes one off its node's Occur.  A lane holding x
//   counts for the node the reference's dropping scatter-add gives it
//   (lane_node: x + n + 1 for a negative x, as NumPy wraps an index; none
//   outside [0, n) after that, so n, the padding value, and -1 count for
//   none), while the scan compares x itself with u_s.
//   Design.  One cooperative launch, one block of kGreedyThreads on each SM
//   (the grid of greedy_flat and celf_select, coop_grid.cuh), 2k + 1 grid
//   barriers.  Occur lives once, in global memory, changed by atomics and
//   read with __ldcg; block b owns the rows [b * rpb, (b + 1) * rpb) and
//   the nodes [b * slots, (b + 1) * slots).  The chosen form is the shared
//   Occur with two barriers a step.  The other form, each block's own
//   Occur slice with one barrier a step, has every block find u_s's rows
//   itself: without an index of the rows by node that is a scan of every
//   row's valid prefix by every block (at the exact cell 8,704 row sectors,
//   278 KB, a block a step, 37 MB a step out of the L2 across the grid,
//   several microseconds, more than the second barrier's ~1.2), and with
//   one it is greedy_flat's prologue (three more barriers, five index
//   arrays), whose own covers at a hub's step are its slowest part.  Here
//   a block scans only its own ~66 rows a step.
//   - Prologue: Occur, the gains and the flag zeroed; barrier; each
//     block's rows' valid lanes added into Occur (a warp's lanes on one
//     node add once, __match_any_sync: a hub's counter would take an
//     atomic a lane), the covered flags of its rows cleared; barrier.
//   - Step s, the argmax: each block's first maximum of its node slice as
//     greedy_flat's 64-bit key, (occur << 32) | (0xFFFFFFFF - v), into its
//     record; barrier; every block reduces all the records to the same u_s.
//   - Step s, the scan (membership_rows' 8-lane groups and ballot, over the
//     block's uncovered rows only): a row that holds u_s is marked covered
//     and counted; then the warp walks the newly covered rows' valid lanes
//     together and takes one off each lane's node (a warp's lanes on one
//     node subtract once), u_s's own lanes too: a wrapped negative lane
//     may count for u_s in a row that stays uncovered, so Occur[u_s] is
//     not simply set to 0.  The block adds its count into gains[s];
//     barrier (not after the last step).
//   A block's record is written after the step's scan barrier and read
//   between the next argmax barrier and the next scan barrier, so one
//   record a block serves every step.  The covered flag of a row is read
//   and written only by its own lane group, so it needs no barrier.
//   What bounds it.  Not bytes nor compares (the valid prefixes' sectors
//   once, 0.28 MB at the exact cell, and k x 35,538 compares): the 2k + 1
//   grid barriers (greedy.cu's greedy_grid_barriers runs the same grid
//   with the barriers alone) and each step's chain of dependent reads.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop_grid.cuh"
#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                     // lanes per row
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// the cooperative greedy's block: greedy_flat's, so its barrier floor is
// greedy_grid_barriers' on the identical grid
constexpr int kGreedyThreads = 512;
constexpr int kGreedyWarps = kGreedyThreads / 32;
constexpr int kRowsPerPass = kGreedyWarps * kRowsPerWarp;

__global__ void membership_kernel(const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ u_ptr,
                                  int32_t u_value, int64_t n_rows,
                                  int64_t row_len, uint8_t* __restrict__ hit) {
  const int32_t target = u_ptr ? *u_ptr : u_value;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kGroup - 1);
  const int grp = lane / kGroup;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  // every lane of a warp runs the same number of iterations, so the
  // full-mask ballot below always sees the whole warp
  for (int64_t base = warp * kRowsPerWarp; base < n_rows;
       base += n_warps * kRowsPerWarp) {
    const int64_t r = base + grp;
    bool found = false;
    if (r < n_rows) {
      int64_t len = lengths[r];
      len = len < 0 ? 0 : (len > row_len ? row_len : len);
      const int32_t* row = rows + r * row_len;
      for (int64_t i = sub; i < len && !found; i += kGroup)
        found = row[i] == target;
    }
    const unsigned votes = __ballot_sync(kFullMask, found);
    if (sub == 0 && r < n_rows)
      hit[r] = ((votes >> (grp * kGroup)) & ((1u << kGroup) - 1)) != 0;
  }
}

// The warp's first maximum as the key (occur << 32) | low, low = 0xFFFFFFFF
// - v; a lane that holds no node passes 0, below every node's key.
__device__ __forceinline__ uint64_t warp_max_key(uint32_t occ, uint32_t low) {
  const uint32_t best = __reduce_max_sync(kFullMask, occ);
  const uint32_t first = __reduce_max_sync(kFullMask, occ == best ? low : 0u);
  return (uint64_t(best) << 32) | first;
}

// The block's first maximum of its threads' (occ, low) pairs, in every
// thread.  `red` is reused after a barrier.
__device__ __forceinline__ uint64_t block_max_key(uint32_t occ, uint32_t low,
                                                  uint64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t key = warp_max_key(occ, low);
  if (lane == 0) red[warp] = key;
  __syncthreads();
  if (warp == 0) {
    const uint64_t w = lane < kGreedyWarps ? red[lane] : 0;
    key = warp_max_key(uint32_t(w >> 32), uint32_t(w));
    if (lane == 0) red[kGreedyWarps] = key;
  }
  __syncthreads();
  key = red[kGreedyWarps];
  __syncthreads();
  return key;
}

// Add `delta` to Occur[v] for each lane whose v >= 0; the warp's lanes on
// one node add together.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(int32_t* occur, int32_t v,
                                         int32_t delta) {
  const unsigned peers = __match_any_sync(kFullMask, v);
  const int lane = threadIdx.x & 31;
  if (v >= 0 && lane == __ffs(peers) - 1)
    atomicAdd(occur + v, delta * __popc(peers));
}

__device__ __forceinline__ int32_t clamped_len(const int32_t* lengths,
                                               int64_t r, int64_t row_len) {
  int64_t len = __ldg(lengths + r);
  return int32_t(len < 0 ? 0 : (len > row_len ? row_len : len));
}

// The node a valid lane holding x counts for, -1 for none (kernels/ref.py::
// padded_lane_node): a negative x wraps to x + n + 1, then only [0, n)
// counts.
__device__ __forceinline__ int32_t lane_node(int32_t x, int32_t n) {
  const int64_t v = x < 0 ? int64_t(x) + n + 1 : int64_t(x);
  return v >= 0 && v < n ? int32_t(v) : -1;
}

__global__ void __launch_bounds__(kGreedyThreads, 1)
padded_greedy_kernel(const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ lengths, int64_t n_rows,
                     int64_t row_len, int32_t n, int32_t k, int32_t slots,
                     int64_t rows_per_block, unsigned long long* records,
                     int32_t* occur, uint8_t* covered, int32_t* out) {
  __shared__ uint64_t red[kGreedyWarps + 1];
  __shared__ int32_t block_new;
  cg::grid_group grid = cg::this_grid();
  const int32_t blocks = gridDim.x, me = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (kGroup - 1), grp = lane / kGroup;
  const int64_t gtid = int64_t(me) * kGreedyThreads + threadIdx.x;
  const int64_t gsize = int64_t(blocks) * kGreedyThreads;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  const int64_t r_lo = min(int64_t(me) * rows_per_block, n_rows);
  const int64_t r_hi = min(r_lo + rows_per_block, n_rows);
  int32_t* seeds = out;
  int32_t* gains = out + k;

  // prologue (A): Occur and the gains zeroed
  for (int64_t v = gtid; v < n; v += gsize) occur[v] = 0;
  for (int64_t i = gtid; i < k; i += gsize) gains[i] = 0;
  grid.sync();

  // prologue (B): the block's rows' valid lanes into Occur, whole warps
  // stepping together over the longest of their four rows
  for (int64_t base = r_lo + int64_t(warp) * kRowsPerWarp; base < r_hi;
       base += kRowsPerPass) {
    const int64_t r = base + grp;
    const int32_t len = r < r_hi ? clamped_len(lengths, r, row_len) : 0;
    if (sub == 0 && r < r_hi) covered[r] = 0;
    const int32_t most = __reduce_max_sync(kFullMask, len);
    const int32_t* row = rows + r * row_len;
    for (int32_t j0 = 0; j0 < most; j0 += kGroup) {
      const int32_t j = j0 + sub;
      warp_add(occur, j < len ? lane_node(__ldg(row + j), n) : -1, 1);
    }
  }
  grid.sync();

  for (int32_t s = 0;; ++s) {
    // the argmax: this block's slice, its record, the barrier, then every
    // block reduces all the records
    {
      uint32_t best = 0, low = 0;
      for (int64_t j = threadIdx.x; j < held; j += kGreedyThreads) {
        const uint32_t o = uint32_t(__ldcg(occur + lo + j));
        if (low == 0 || o > best) {
          best = o;
          low = 0xFFFFFFFFu - uint32_t(lo + j);
        }
      }
      const uint64_t mine = block_max_key(best, low, red);
      if (threadIdx.x == 0) records[me] = mine;
    }
    grid.sync();
    const uint64_t theirs = threadIdx.x < blocks ? __ldcg(records +
                                                          threadIdx.x) : 0;
    const uint64_t key = block_max_key(uint32_t(theirs >> 32),
                                       uint32_t(theirs), red);
    const int32_t u = int32_t(0xFFFFFFFFu - uint32_t(key));
    if (threadIdx.x == 0) block_new = 0;
    if (gtid == 0) seeds[s] = u;
    __syncthreads();

    // the scan of the block's uncovered rows, then the new rows' lanes off
    // Occur
    for (int64_t base = r_lo + int64_t(warp) * kRowsPerWarp; base < r_hi;
         base += kRowsPerPass) {
      const int64_t r = base + grp;
      int32_t len = 0;
      if (r < r_hi && !covered[r]) len = clamped_len(lengths, r, row_len);
      const int32_t* row = rows + r * row_len;
      bool found = false;
      for (int32_t j = sub; j < len && !found; j += kGroup)
        found = __ldg(row + j) == u;
      const unsigned votes = __ballot_sync(kFullMask, found);
      const bool fresh = ((votes >> (grp * kGroup)) & 0xFFu) != 0;
      if (!fresh) len = 0;
      if (sub == 0 && fresh) covered[r] = 1;
      if (lane == 0) {
        int32_t rows_new = 0;
        for (int g = 0; g < kRowsPerWarp; ++g)
          rows_new += ((votes >> (g * kGroup)) & 0xFFu) != 0;
        if (rows_new) atomicAdd(&block_new, rows_new);
      }
      const int32_t most = __reduce_max_sync(kFullMask, len);
      for (int32_t j0 = 0; j0 < most; j0 += kGroup) {
        const int32_t j = j0 + sub;
        warp_add(occur, j < len ? lane_node(__ldg(row + j), n) : -1, -1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && block_new) atomicAdd(gains + s, block_new);
    if (s + 1 == k) break;
    grid.sync();
  }
}

// padded_greedy_kernel's grid on card `device`, read once a card: one
// block on each SM.
cudaError_t greedy_grid_for(int device, int* blocks) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    cudaError_t err = cooperative_sms(
        reinterpret_cast<const void*>(padded_greedy_kernel), kGreedyThreads,
        device, &sms[device]);
    if (err == cudaSuccess && sms[device] > kGreedyThreads)
      err = cudaErrorNotSupported;     // a thread reads each block's record
    if (err != cudaSuccess) {
      sms[device] = 0;
      return err;
    }
  }
  *blocks = sms[device];
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream` of card
// `device` and returns the cudaError_t of its launch.

// u_ptr points at one int32 on the card, or is null and u_value is u.
extern "C" int membership_rows(const void* rows, const void* lengths,
                               const void* u_ptr, int32_t u_value,
                               int64_t n_rows, int64_t row_len, void* hit,
                               int device, void* stream) {
  if (n_rows <= 0) return int(cudaGetLastError());
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const int64_t rows_per_block = (kThreads / 32) * kRowsPerWarp;
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  membership_kernel<<<unsigned(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(u_ptr), u_value, n_rows, row_len,
      static_cast<uint8_t*>(hit));
  return int(cudaGetLastError());
}

// The blocks of padded_greedy's grid on card `device` (one on each SM).
extern "C" int padded_greedy_grid(int device, int* blocks) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(greedy_grid_for(device, blocks));
}

// rows: (n_rows, row_len) int32, lengths: n_rows int32 (clamped to [0,
// row_len] here); 1 <= n < 2^31 - 1, k >= 1.  scratch: the blocks'
// records (8 bytes a block), Occur (4n bytes) and the covered flags
// (n_rows bytes), in that order; the kernel writes all it reads of them.
// out: 2k int32, the seeds, then the gains.
extern "C" int padded_greedy(const void* rows, const void* lengths,
                             int64_t n_rows, int64_t row_len, int32_t n,
                             int32_t k, void* scratch, void* out, int device,
                             void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || k < 1 || n_rows < 0 || row_len < 0 ||
      row_len >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  cudaError_t err = greedy_grid_for(device, &blocks);
  if (err != cudaSuccess) return int(err);
  int32_t slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  int64_t rows_per_block = (n_rows + blocks - 1) / blocks;
  const int32_t* p_rows = static_cast<const int32_t*>(rows);
  const int32_t* p_lens = static_cast<const int32_t*>(lengths);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  unsigned long long* records = reinterpret_cast<unsigned long long*>(base);
  int32_t* occur = reinterpret_cast<int32_t*>(base + 8 * int64_t(blocks));
  uint8_t* covered = base + 8 * int64_t(blocks) + 4 * int64_t(n);
  int32_t* p_out = static_cast<int32_t*>(out);
  void* args[] = {&p_rows, &p_lens, &n_rows, &row_len, &n, &k, &slots,
                  &rows_per_block, &records, &occur, &covered, &p_out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(padded_greedy_kernel), dim3(blocks),
      dim3(kGreedyThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
