// Variants of the fused greedy (src/repro_torch/kernels/csrc/greedy.cu),
// timed against it by examples/torch_greedy_variants.py.  Built with the
// port's nvcc flags and -I src/repro_torch/kernels/csrc; it includes
// greedy.cu, so the kernel under test and its helpers are the checkout's.
// Each variant computes greedy_flat's seeds and gains from the same inputs
// (kernels/greedy.py::flat_index).
//
// greedy_steps: one launch a step, no grid barrier.  Launch s first does
// step s - 1's cover (phase 0 at s = 0) in every block; then each block
// makes a __threadfence and takes a ticket, and the last block to finish
// runs step s's whole argmax alone and writes u_s, its gain, and resets
// the ticket.  The launches' stream order stands in for the barriers, at
// one host enqueue a step (the loop of launches runs in C).
//
// greedy_cluster: one thread-block cluster of C CTAs (8 portable, 16
// non-portable) of 1,024 threads, Occur and Covered split over the CTAs'
// shared memory: CTA c holds Occur[c * slice, (c + 1) * slice) and the
// flags of rows [c * rslice, (c + 1) * rslice).  The argmax reduces each
// CTA's slice into a key in its own shared memory, and after the barrier
// every warp reads the C keys through cluster.map_shared_rank and takes
// their maximum; the decrements are atomicSub on cluster.map_shared_rank
// addresses; barrier.cluster (cluster.sync) between the phases.  It works
// only where n * 4 bytes fit in the cluster's shared memory.

#include "greedy.cu"

namespace {

constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;

// the argmax of Occur[0, n) by one block, into keys[s], seeds and gains
__device__ void block_argmax_all(const int32_t* occur, int32_t n, int32_t s,
                                 unsigned long long* keys, int32_t* seeds,
                                 int32_t* gains, uint64_t* red) {
  uint32_t occ = 0, low = 0;
  for (int64_t v = threadIdx.x; v < n; v += kThreads) {
    const uint32_t o = uint32_t(__ldcg(occur + v));
    if (low == 0 || o > occ) {
      occ = o;
      low = 0xFFFFFFFFu - uint32_t(v);
    }
  }
  const uint64_t key = block_max_key(occ, low, red);
  if (threadIdx.x == 0) {
    keys[s] = key;
    seeds[s] = int32_t(0xFFFFFFFFu - uint32_t(key));
    gains[s] = int32_t(key >> 32);
  }
}

__global__ void __launch_bounds__(kThreads)
greedy_step_kernel(const int32_t* __restrict__ nodes,
                   const int32_t* __restrict__ row_start,
                   const int32_t* __restrict__ inv_start,
                   const int32_t* __restrict__ inv_rows, int32_t n,
                   int64_t num_rows, int32_t s, unsigned long long* keys,
                   int32_t* occur, uint8_t* covered, unsigned* ticket,
                   int32_t* seeds, int32_t* gains) {
  __shared__ uint64_t red[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int64_t gtid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gsize = int64_t(gridDim.x) * kThreads;
  const int64_t gwarp = gtid >> 5, nwarps = gsize >> 5;
  if (s == 0) {
    for (int64_t v = gtid; v < n; v += gsize)
      occur[v] = __ldg(inv_start + v + 1) - __ldg(inv_start + v);
    for (int64_t r = gtid; r < num_rows; r += gsize) covered[r] = 0;
  } else {
    const unsigned long long key = __ldcg(keys + s - 1);
    const int32_t u = int32_t(0xFFFFFFFFu - uint32_t(key));
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
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  block_argmax_all(occur, n, s, keys, seeds, gains, red);
  if (threadIdx.x == 0) *ticket = 0;
}

__global__ void __launch_bounds__(kClusterThreads)
greedy_cluster_kernel(const int32_t* __restrict__ nodes,
                      const int32_t* __restrict__ row_start,
                      const int32_t* __restrict__ inv_start,
                      const int32_t* __restrict__ inv_rows, int32_t n,
                      int64_t num_rows, int32_t k, int32_t slice,
                      int32_t rslice, int32_t* seeds, int32_t* gains) {
  extern __shared__ int32_t occ_local[];          // slice, then the flags
  __shared__ uint64_t red[kClusterWarps];
  __shared__ uint64_t slot;                       // this CTA's key
  uint8_t* cov_local = reinterpret_cast<uint8_t*>(occ_local + slice);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), ctas = cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = int64_t(rank) * slice;

  for (int i = tid; i < slice; i += kClusterThreads) {
    const int64_t v = base + i;
    occ_local[i] = v < n ? __ldg(inv_start + v + 1) - __ldg(inv_start + v)
                         : 0;
  }
  for (int i = tid; i < rslice; i += kClusterThreads) cov_local[i] = 0;
  cluster.sync();

  const int64_t cwarp = int64_t(rank) * kClusterWarps + warp;
  const int64_t nwarps = int64_t(ctas) * kClusterWarps;
  for (int32_t s = 0; s < k; ++s) {
    uint32_t occ = 0, low = 0;
    for (int i = tid; i < slice && base + i < n; i += kClusterThreads) {
      const uint32_t o = uint32_t(occ_local[i]);
      if (low == 0 || o > occ) {
        occ = o;
        low = 0xFFFFFFFFu - uint32_t(base + i);
      }
    }
    // block_max_key's reduction over 32 warps
    uint64_t key = warp_max_key(occ, low);
    if (lane == 0) red[warp] = key;
    __syncthreads();
    if (warp == 0) {
      const uint64_t w = red[lane];
      key = warp_max_key(uint32_t(w >> 32), uint32_t(w));
      if (lane == 0) slot = key;  // read by all before the last barrier
    }
    cluster.sync();

    // every warp: the maximum of the C keys (lane c reads CTA c's)
    const uint64_t theirs =
        lane < int(ctas)
            ? *static_cast<volatile uint64_t*>(
                  cluster.map_shared_rank(&slot, unsigned(lane)))
            : 0;
    const uint64_t best =
        warp_max_key(uint32_t(theirs >> 32), uint32_t(theirs));
    const int32_t u = int32_t(0xFFFFFFFFu - uint32_t(best));
    if (rank == 0 && tid == 0) {
      seeds[s] = u;
      gains[s] = int32_t(best >> 32);
    }
    const int32_t end = __ldg(inv_start + u + 1);
    for (int64_t i = __ldg(inv_start + u) + cwarp; i < end; i += nwarps) {
      const int32_t r = __ldg(inv_rows + i);
      const int32_t e0 = __ldg(row_start + r), e1 = __ldg(row_start + r + 1);
      uint32_t fresh = 0;
      if (lane == 0) {
        volatile uint8_t* flag =
            cluster.map_shared_rank(cov_local, unsigned(r / rslice)) +
            r % rslice;
        fresh = *flag == 0;
        if (fresh) *flag = 1;
      }
      if (__shfl_sync(kFullMask, fresh, 0)) {
        for (int32_t e = e0 + lane; e < e1; e += 32) {
          const uint32_t v = uint32_t(__ldg(nodes + e));
          if (v < uint32_t(n))
            atomicSub(cluster.map_shared_rank(occ_local, v / slice) +
                          v % slice,
                      1);
        }
      }
    }
    cluster.sync();               // also keeps every CTA's memory alive
  }
}

}  // namespace

// greedy_flat's arguments; scratch: 8 * k + 4 * n + num_rows bytes, then a
// zeroed 4-byte ticket.
extern "C" int greedy_steps(const void* nodes, const void* row_start,
                            const void* inv_start, const void* inv_rows,
                            int32_t n, int64_t num_rows, int32_t k,
                            void* scratch, void* out, int blocks_per_sm,
                            int device, void* stream) {
  if (n < 1 || num_rows < 1 || k < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  cudaError_t err = grid_for(blocks_per_sm, device, &blocks);
  if (err != cudaSuccess) return int(err);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  auto* keys = reinterpret_cast<unsigned long long*>(base);
  auto* occur = reinterpret_cast<int32_t*>(base + 8 * int64_t(k));
  uint8_t* covered = base + 8 * int64_t(k) + 4 * int64_t(n);
  auto* ticket = reinterpret_cast<unsigned*>(
      base + ((8 * int64_t(k) + 4 * int64_t(n) + num_rows + 3) & ~int64_t(3)));
  int32_t* seeds = static_cast<int32_t*>(out);
  for (int32_t s = 0; s < k; ++s) {
    greedy_step_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(nodes),
        static_cast<const int32_t*>(row_start),
        static_cast<const int32_t*>(inv_start),
        static_cast<const int32_t*>(inv_rows), n, num_rows, s, keys, occur,
        covered, ticket, seeds, seeds + k);
  }
  return int(cudaGetLastError());
}

// greedy_flat's arguments but scratch; `cluster` CTAs (8 or 16).
extern "C" int greedy_cluster(const void* nodes, const void* row_start,
                              const void* inv_start, const void* inv_rows,
                              int32_t n, int64_t num_rows, int32_t k,
                              void* out, int cluster, int device,
                              void* stream) {
  if (n < 1 || num_rows < 1 || k < 1 || cluster < 1 || cluster > 16)
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  const int32_t slice = int32_t((int64_t(n) + cluster - 1) / cluster);
  const int32_t rslice = int32_t((num_rows + cluster - 1) / cluster);
  const size_t shared = 4 * size_t(slice) + size_t(rslice);
  if (shared > 232448 - 2048) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(greedy_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(shared));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = shared;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int32_t* seeds = static_cast<int32_t*>(out);
  err = cudaLaunchKernelEx(&config, greedy_cluster_kernel,
                           static_cast<const int32_t*>(nodes),
                           static_cast<const int32_t*>(row_start),
                           static_cast<const int32_t*>(inv_start),
                           static_cast<const int32_t*>(inv_rows), n, num_rows,
                           k, slice, rslice, seeds, seeds + k);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
