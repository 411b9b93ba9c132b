// The earlier design of the fused greedy (src/repro_torch/kernels/csrc/
// greedy.cu's greedy_flat), timed against it by
// examples/torch_greedy_variants.py, and greedy_flat with clock stamps of
// its phases.  Built with the port's nvcc flags and
// -I src/repro_torch/kernels/csrc; it includes greedy.cu, so the kernel
// and the helpers are the checkout's.
//
// Stamps: GREEDY_STAMP(i) makes the first thread of each block write its
// SM's clock64() to stamps[block][i] (0: start; 1-3: after the prologue's
// barriers A to C; then each step s: 4 + 3s after the block's record is
// out, 5 + 3s once the step's seed is known, and but at the last step 6 +
// 3s after its cover), so this library's greedy_flat is the kernel under
// test with stamps; greedy_flat_stamps copies them out.
//
// The earlier design computes greedy_flat's seeds and gains from the
// pool's indices built beforehand by torch operations
// (kernels/ref.py::flat_index).
//
// two_barrier_flat_kernel: one cooperative launch, one block of kThreads
// on each SM, 2k grid barriers.  Phase 0 sets a global Occur from the
// node-major index.  Each step: the argmax of the whole Occur, a thread a
// grid-strided share, into the step's key slot; a barrier; then every
// warp of the grid owns some of u_s's rows, sets each uncovered row's flag
// (a byte a row, global) and takes one off Occur at its elements by a
// global atomicSub; a barrier.  The cover writes Occur, which the next
// argmax reads across blocks, so each step needs both barriers.

constexpr int kStamps = 5 + 3 * 256, kStampBlocks = 256;
__device__ long long stamps[kStampBlocks][kStamps];
#define GREEDY_STAMP(i)                                                 \
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks && (i) < kStamps)   \
    stamps[blockIdx.x][i] = clock64()

#include "greedy.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
two_barrier_flat_kernel(const int32_t* __restrict__ nodes,
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

}  // namespace

// The index (kernels/ref.py::flat_index: nodes, row_start, inv_start,
// inv_rows), n, num_rows, k; scratch: 8 * k + 4 * n + num_rows bytes (the
// keys, Occur and Covered); out: 2 * k int32.  A block on each SM.
extern "C" int two_barrier_flat(const void* nodes, const void* row_start,
                                const void* inv_start, const void* inv_rows,
                                int32_t n, int64_t num_rows, int32_t k,
                                void* scratch, void* out, int device,
                                void* stream) {
  if (n < 1 || num_rows < 1 || k < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int sms = 0, resident = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, two_barrier_flat_kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  if (resident < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  const int32_t* p_nodes = static_cast<const int32_t*>(nodes);
  const int32_t* p_row_start = static_cast<const int32_t*>(row_start);
  const int32_t* p_inv_start = static_cast<const int32_t*>(inv_start);
  const int32_t* p_inv_rows = static_cast<const int32_t*>(inv_rows);
  uint8_t* at = static_cast<uint8_t*>(scratch);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(at);
  int32_t* occur = reinterpret_cast<int32_t*>(at + 8 * int64_t(k));
  uint8_t* covered = at + 8 * int64_t(k) + 4 * int64_t(n);
  int32_t* seeds = static_cast<int32_t*>(out);
  int32_t* gains = seeds + k;
  void* args[] = {&p_nodes, &p_row_start, &p_inv_start, &p_inv_rows, &n,
                  &num_rows, &k, &keys, &occur, &covered, &seeds, &gains};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(two_barrier_flat_kernel), dim3(sms),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The stamps of the last greedy_flat launch of this library, block by
// block: kStamps of each of the first `blocks` blocks into `out` (host
// memory).
extern "C" int greedy_flat_stamps(long long* out, int blocks) {
  if (blocks < 0 || blocks > kStampBlocks) return int(cudaErrorInvalidValue);
  return int(cudaMemcpyFromSymbol(out, stamps,
                                  sizeof(long long) * kStamps * blocks));
}
