// Two variants of greedy_sketch (src/repro_torch/kernels/csrc/greedy.cu)
// at W <= 4 words a row, timed against it in turns by
// examples/torch_sketch_variants.py.  Built with the port's nvcc flags
// and -I src/repro_torch/kernels/csrc; it includes greedy.cu for its
// helpers.
//
// sketch_poll: the port's register form (a thread's rows and cov in
// registers) with the records as the barrier: each block publishes its
// step record as 64-bit words that each carry the step's tag (s + 1)
// above 32 bits of payload, stored with relaxed (volatile) 16-byte stores
// and no fence, and thread i of every block polls record i with relaxed
// loads until all its words carry the tag; one grid barrier in all, after
// the prologue zeroes the k steps' slots.
//
// sketch_cluster: one cluster of `cluster_blocks` blocks (8, the portable
// size, or 16) of kClusterThreads, the rows in the blocks' shared memory
// (a uint4 each), cov in registers, and a step's exchange of the blocks'
// records through distributed shared memory behind one cluster barrier
// (barrier.cluster): no grid-wide synchronisation at all.  The records
// of a step are in the slot of its parity: a block writes step s + 2's
// only after the cluster barrier of step s + 1, which every reader of
// step s's passes after its reads.
#include "greedy.cu"

namespace {

// A poll record: six 64-bit words, the step's tag above each 32-bit word
// of the key (high, low) and of the winner's row.
struct alignas(64) PollRecord {
  unsigned long long w[8];
};

__device__ __forceinline__ void store_pair(unsigned long long* p,
                                           unsigned long long a,
                                           unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a),
               "l"(b)
               : "memory");
}

__device__ __forceinline__ ulonglong2 load_pair(const unsigned long long* p) {
  ulonglong2 x;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(x.x), "=l"(x.y)
               : "l"(p)
               : "memory");
  return x;
}

__device__ __forceinline__ unsigned long long tagged(uint32_t tag,
                                                     uint32_t payload) {
  return (uint64_t(tag) << 32) | payload;
}

__device__ __forceinline__ bool has_tag(ulonglong2 x, uint32_t tag) {
  return uint32_t(x.x >> 32) == tag && uint32_t(x.y >> 32) == tag;
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
sketch_poll_kernel(const uint32_t* __restrict__ sk, int32_t n, int32_t cols,
                   bool vector, int32_t k, int32_t slots, PollRecord* records,
                   int32_t* out) {
  __shared__ uint64_t s_wkey[kWarps], s_xkey[kWarps];
  __shared__ uint4 s_wrow[kWarps], s_xrow[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int32_t blocks = gridDim.x, me = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t gtid = int64_t(me) * kThreads + tid;
  const int64_t gsize = int64_t(blocks) * kThreads;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  {
    unsigned long long* words = reinterpret_cast<unsigned long long*>(records);
    for (int64_t i = gtid; i < 8 * int64_t(k) * blocks; i += gsize)
      words[i] = 0;
  }
  uint4 rows[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t j = tid + int64_t(i) * kThreads;
    rows[i] = j < held ? load_row4(sk + (lo + j) * cols, cols, vector)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  uint4 c4 = make_uint4(0u, 0u, 0u, 0u);
  uint32_t mine_picked = 0, base = 0;
  grid.sync();
  int32_t s = 0;
  for (; s < k; ++s) {
    const uint32_t tag = uint32_t(s) + 1;
    uint32_t best = 0, low = 0;
    uint4 best_row = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t j = tid + int64_t(i) * kThreads;
      if (j < held) {
        const uint32_t d = popc_or4(rows[i], c4) - base;
        if ((low == 0 || d + 1 > best) &&
            (d != 0 || !((mine_picked >> i) & 1u))) {
          best = d + 1;
          low = 0xFFFFFFFFu - uint32_t(lo + j);
          best_row = rows[i];
        }
      }
    }
    PollRecord* rec = records + int64_t(s) * blocks;
    {
      const uint64_t key = (uint64_t(best) << 32) | low;
      const uint64_t top = warp_max_u64(key);
      if (key == top && top != 0) s_wrow[warp] = best_row;
      if (lane == 0) s_wkey[warp] = top;
      __syncthreads();
      if (warp == 0) {
        const uint64_t mine = lane < kWarps ? s_wkey[lane] : 0;
        const uint64_t block_top = warp_max_u64(mine);
        if (block_top != 0 ? mine == block_top : lane == 0) {
          const uint4 r = block_top != 0 ? s_wrow[lane]
                                         : make_uint4(0u, 0u, 0u, 0u);
          const uint64_t key_out = block_top != 0 ? block_top : 1;
          unsigned long long* w = rec[me].w;
          store_pair(w + 2, tagged(tag, r.x), tagged(tag, r.y));
          store_pair(w + 4, tagged(tag, r.z), tagged(tag, r.w));
          store_pair(w, tagged(tag, uint32_t(key_out >> 32)),
                     tagged(tag, uint32_t(key_out)));
        }
      }
    }
    uint64_t theirs = 0;
    uint4 their_row = make_uint4(0u, 0u, 0u, 0u);
    if (tid < blocks) {
      const unsigned long long* w = rec[tid].w;
      ulonglong2 a, b, c;
      do {
        a = load_pair(w);
        b = load_pair(w + 2);
        c = load_pair(w + 4);
      } while (!(has_tag(a, tag) && has_tag(b, tag) && has_tag(c, tag)));
      theirs = (uint64_t(uint32_t(a.x)) << 32) | uint32_t(a.y);
      their_row = make_uint4(uint32_t(b.x), uint32_t(b.y), uint32_t(c.x),
                             uint32_t(c.y));
    }
    {
      const uint64_t top = warp_max_u64(theirs);
      if (theirs == top && top != 0) s_xrow[warp] = their_row;
      if (lane == 0) s_xkey[warp] = top;
    }
    __syncthreads();
    uint64_t key = 0;
    int at = 0;
    for (int w = 0; w * 32 < blocks; ++w) {
      const uint64_t x = s_xkey[w];
      if (x > key) {
        key = x;
        at = w;
      }
    }
    if ((key >> 32) == 0) break;                // no node left
    const uint32_t u = 0xFFFFFFFFu - uint32_t(key);
    const uint32_t gain = uint32_t(key >> 32) - 1;
    if (gtid == 0) {
      out[s] = int32_t(u);
      out[k + s] = int32_t(gain);
    }
    const int64_t ju = int64_t(u) - lo;
    if (ju >= 0 && ju < held && ju % kThreads == tid)
      mine_picked |= 1u << (ju / kThreads);
    base += gain;
    c4 = or4(c4, s_xrow[at]);
  }
  if (gtid == 0) out[2 * k] = s;
  for (int64_t j = s + gtid; j < k; j += gsize) {
    out[j] = n;
    out[k + j] = 0;
  }
}

}  // namespace

// words: (R, cols) uint32 rows, rows v < n read; cols <= 4; vector: cols
// == 4 and 16-byte aligned; rows: 1, 2, 4 or 8, at least the rows of a
// block's slice over kThreads.  scratch: 64 x k x blocks bytes; out: 2k +
// 1 int32 as greedy_sketch's.  greedy_sketch's grid.
extern "C" int sketch_poll(const void* words, int32_t n, int32_t cols,
                           int vector, int32_t k, int rows, void* scratch,
                           void* out, int device, void* stream) {
  if (n < 1 || cols < 1 || cols > 4 || k < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_words = 0;
  cudaError_t err = sketch_grid_for(device, &blocks, &shared_words);
  if (err != cudaSuccess) return int(err);
  int32_t slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  if (int64_t(rows) * kThreads < slots) return int(cudaErrorInvalidValue);
  const void* kernel =
      rows == 1 ? reinterpret_cast<const void*>(sketch_poll_kernel<1>)
      : rows == 2 ? reinterpret_cast<const void*>(sketch_poll_kernel<2>)
      : rows == 4 ? reinterpret_cast<const void*>(sketch_poll_kernel<4>)
                  : reinterpret_cast<const void*>(sketch_poll_kernel<8>);
  const uint32_t* p_words = static_cast<const uint32_t*>(words);
  PollRecord* records = static_cast<PollRecord*>(scratch);
  int32_t* p_out = static_cast<int32_t*>(out);
  bool vec = vector != 0;
  void* args[] = {&p_words, &n, &cols, &vec, &k, &slots, &records, &p_out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

namespace {

constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;

struct alignas(16) ClusterRecord {
  uint4 row;
  unsigned long long key;
  unsigned long long pad;
};

__global__ void __launch_bounds__(kClusterThreads, 1)
sketch_cluster_kernel(const uint32_t* __restrict__ sk, int32_t n,
                      int32_t cols, bool vector, int32_t k, int32_t slots,
                      uint8_t* picked, int32_t* out) {
  extern __shared__ uint4 s_rows[];
  __shared__ ClusterRecord s_rec[2];
  __shared__ uint64_t s_wkey[kClusterWarps];
  __shared__ uint4 s_wrow[kClusterWarps];
  __shared__ uint64_t s_key;
  __shared__ uint4 s_row;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = int(cluster.num_blocks());
  const int me = int(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  for (int64_t j = tid; j < held; j += kClusterThreads) {
    s_rows[j] = load_row4(sk + (lo + j) * cols, cols, vector);
    picked[lo + j] = 0;
  }
  __syncthreads();
  uint4 c4 = make_uint4(0u, 0u, 0u, 0u);
  uint32_t base = 0;
  int32_t s = 0;
  for (; s < k; ++s) {
    uint32_t best = 0, low = 0;
    int64_t at = 0;
    for (int64_t j = tid; j < held; j += kClusterThreads) {
      const uint32_t d = popc_or4(s_rows[j], c4) - base;
      if ((d != 0 || !picked[lo + j]) && (low == 0 || d + 1 > best)) {
        best = d + 1;
        low = 0xFFFFFFFFu - uint32_t(lo + j);
        at = j;
      }
    }
    const uint64_t key = (uint64_t(best) << 32) | low;
    const uint64_t top = warp_max_u64(key);
    if (key == top && top != 0) s_wrow[warp] = s_rows[at];
    if (lane == 0) s_wkey[warp] = top;
    __syncthreads();
    if (warp == 0) {
      const uint64_t mine = s_wkey[lane];
      const uint64_t block_top = warp_max_u64(mine);
      if (block_top != 0 ? mine == block_top : lane == 0) {
        s_rec[s & 1].row =
            block_top != 0 ? s_wrow[lane] : make_uint4(0u, 0u, 0u, 0u);
        s_rec[s & 1].key = block_top;
      }
    }
    cluster.sync();                  // every block's record of step s
    if (warp == 0) {
      uint64_t theirs = 0;
      uint4 their_row = make_uint4(0u, 0u, 0u, 0u);
      if (lane < blocks) {
        const ClusterRecord* rec = cluster.map_shared_rank(&s_rec[s & 1],
                                                           lane);
        theirs = rec->key;
        their_row = rec->row;
      }
      const uint64_t best_key = warp_max_u64(theirs);
      if (lane == 0) s_key = best_key;
      if (theirs == best_key && best_key != 0) s_row = their_row;
    }
    __syncthreads();
    const uint64_t step_key = s_key;
    if ((step_key >> 32) == 0) break;  // no node left
    const uint32_t u = 0xFFFFFFFFu - uint32_t(step_key);
    const uint32_t gain = uint32_t(step_key >> 32) - 1;
    if (me == 0 && tid == 0) {
      out[s] = int32_t(u);
      out[k + s] = int32_t(gain);
    }
    const int64_t ju = int64_t(u) - lo;
    if (ju >= 0 && ju < held && ju % kClusterThreads == tid) picked[u] = 1;
    base += gain;
    c4 = or4(c4, s_row);
  }
  if (me == 0 && tid == 0) out[2 * k] = s;
  for (int64_t j = s + int64_t(me) * kClusterThreads + tid; j < k;
       j += int64_t(blocks) * kClusterThreads) {
    out[j] = n;
    out[k + j] = 0;
  }
  cluster.sync();          // no block leaves while another reads its records
}

}  // namespace

// words: (R, cols) uint32 rows, rows v < n read; cols <= 4; vector: cols
// == 4 and 16-byte aligned.  scratch: n picked bytes; out: 2k + 1 int32
// as greedy_sketch's.  One cluster of cluster_blocks (8 or 16) blocks.
extern "C" int sketch_cluster(const void* words, int32_t n, int32_t cols,
                              int vector, int32_t k, int cluster_blocks,
                              void* scratch, void* out, int device,
                              void* stream) {
  if (n < 1 || cols < 1 || cols > 4 || k < 1 ||
      (cluster_blocks != 8 && cluster_blocks != 16))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int32_t slots = int32_t((int64_t(n) + cluster_blocks - 1) / cluster_blocks);
  const size_t dynamic = size_t(slots) * 16;
  const void* kernel = reinterpret_cast<const void*>(sketch_cluster_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dynamic));
  if (err != cudaSuccess) return int(err);
  if (cluster_blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_blocks);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = dynamic;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, sketch_cluster_kernel,
                                       &config);
  if (err != cudaSuccess) return int(err);
  if (clusters < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  const uint32_t* p_words = static_cast<const uint32_t*>(words);
  uint8_t* picked = static_cast<uint8_t*>(scratch);
  int32_t* p_out = static_cast<int32_t*>(out);
  bool vec = vector != 0;
  err = cudaLaunchKernelEx(&config, sketch_cluster_kernel, p_words, n, cols,
                           vec, k, slots, picked, p_out);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
