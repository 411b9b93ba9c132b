// The CELF lazy greedy for Hopper (sm_90a): celf_select runs a whole
// selection, all k seeds, in one cooperative launch (further down);
// celf_eval scores a batch of candidates against the Covered bitset and
// celf_apply commits a seed into it, one launch each.
//
// Replaces no Pallas kernel.  The JAX reference runs CELF as a host loop
// (src/repro/core/coverage.py:2093, select_seeds_celf) whose exact
// evaluations and commits are XLA (:1451-1497, eval_batch and apply_seed
// over _newly_rows, :1329): the paper's Alg. 7 membership pass in its lazy
// form.  The plain versions are kernels/ref.py::celf_select_ref,
// celf_eval_ref and celf_apply_ref.  celf_eval and celf_apply are no
// longer on the selection's path: celf_select holds both in its launch.
//
// Inputs: the pool's live extent as the store holds it, flat (node ids),
// ids (row ids) and valid (a byte an element); cov, the Covered bitset of
// cov_words uint32 words (bit r & 31 of word r >> 5 is row r; bit 31 is a
// row like any other).  An element counts when it is valid and its row lies
// in [0, 32 * cov_words).
//
// Count rows, not elements.  The reference counts a row once even where the
// row repeats a node (segment_max), so neither kernel counts elements: a
// row counts when an atomicOr flips its bit from 0, in Covered for
// celf_apply and in a scratch bitmap of the candidate's for celf_eval.  So
// no row-unique contract is needed.
//
// celf_eval: out[i] = number of rows not in Covered that hold cands[i]
//   (c <= kMaxCands; a candidate that is no node, the reference's -1
//   padding, matches nothing).  buf holds out (c int32) and then the c
//   candidates' scratch bitmaps (c x cov_words); the entry point zeroes
//   buf (one memset) and launches the kernel.
//   Design.  One thread an element, grid-stride.  Each block first builds
//   a hash table of the candidates in shared memory (open addressing, at
//   least twice as many entries as candidates, keyed by node, a duplicate
//   candidate in an entry of its own), so an element costs one probe of
//   shared memory, and most elements match no candidate.  A matching
//   element whose row is not covered sets the row's bit in its candidate's
//   bitmap; where that flips the bit, the block's shared count of the
//   candidate rises, and each block adds its nonzero counts to out once.
//   What bounds it: bytes, the node ids of the pool read once (4 bytes an
//   element), and only for the elements that hold a candidate their valid
//   byte, row id and Covered word; one probe an element.  At the stand-in's
//   pool (35,538 elements) that is about 0.15 MB, so a call costs its
//   launch.  The memset writes 4 * c * (1 + cov_words) bytes besides: it
//   grows with c and the row capacity, not with the pool (65 KB at c = 32
//   and 16,384 rows; 2 GB at c = 2,048 and 2^23 rows).
//
// celf_apply: the rows that hold u are ORed into cov in place; *gain =
//   the number of them whose bit was 0 before.  The entry point zeroes
//   gain (one memset) and launches the kernel.
//   Design.  One thread an element, grid-stride, the loop's trip count the
//   same for every lane of a warp: a lane whose atomicOr flipped a bit
//   votes, the warp adds its votes to the block's shared count, and each
//   block adds its count to *gain once.  Bound: bytes, the node ids of the
//   pool read once, and the valid byte, row id and Covered word (read and
//   written) of the elements that hold u.
//
// Weighted forms (roww non-null: the row-weighted store's (32 *
// cov_words) float32 row weights).  Replace no Pallas kernel either: the
// reference's eval_batch_w and apply_seed_w (src/repro/core/coverage.py:
// 1783-1821) are XLA over _newly_rows.  Where a row's bit flips, they add
// the row's weight instead of one: celf_eval into its candidate's float
// count in shared memory and then out (float32), celf_apply into the
// warp's shuffle sum, the block's shared sum and *gain (float32).  With
// roww null the kernels count as before, bit for bit.  The plain versions
// are celf_eval_ref and celf_apply_ref with roww.  Bound: the same bytes,
// and the weight (4 bytes) of each newly covered row.  Float order: the
// atomics add in no fixed order, so the sums are those of the plain
// version bit for bit where every partial sum is exact in float32
// (integer or dyadic weights whose sums stay below 2^24 units of the
// finest step); otherwise they may differ in the last bits (a relative
// 2^-24 an add, for positive weights).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop_grid.cuh"
#include "device_guard.cuh"

// SM clocks of celf_select_kernel's phases, summed over a selection:
// examples/celf_stamps.cu defines these (examples/phase_clock.cuh) before
// it includes this file; here they are empty.
#ifndef PHASE_CLOCK_START
#define PHASE_CLOCK_START(phases)
#define PHASE_CLOCK(p)
#define PHASE_CLOCK_END()
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCands = 2048;   // candidates a launch (celf.py MAX_CANDS)
constexpr int kMaxTable = 2 * kMaxCands;   // hash entries, a power of two
constexpr int kMinTable = 64;
constexpr int64_t kMaxBlocks = 132 * 4;
constexpr int32_t kEmpty = -1;

__device__ __forceinline__ int table_slot(int32_t v, int shift) {
  return int((uint32_t(v) * 2654435761u) >> shift);
}

__device__ __forceinline__ bool row_in(const uint8_t* valid,
                                       const int32_t* ids, int64_t e,
                                       int64_t rows, int32_t* row) {
  if (!valid[e]) return false;
  const int32_t r = ids[e];
  *row = r;
  return r >= 0 && r < rows;
}

__global__ void __launch_bounds__(kThreads)
celf_eval_kernel(const int32_t* __restrict__ flat,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ valid, int64_t t,
                 const uint32_t* __restrict__ cov, int64_t cov_words,
                 const int32_t* __restrict__ cands, int c, int table_bits,
                 const float* __restrict__ roww, int32_t* __restrict__ out,
                 uint32_t* __restrict__ scratch) {
  __shared__ int32_t s_key[kMaxTable];
  __shared__ int32_t s_cand[kMaxTable];
  __shared__ int32_t s_cnt[kMaxCands];
  const int table = 1 << table_bits;
  const int shift = 32 - table_bits;
  for (int i = threadIdx.x; i < table; i += blockDim.x) s_key[i] = kEmpty;
  for (int i = threadIdx.x; i < c; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int32_t v = cands[i];
    if (v < 0) continue;                   // matches no element
    int h = table_slot(v, shift);
    // a duplicate candidate probes on to an entry of its own
    while (atomicCAS(&s_key[h], kEmpty, v) != kEmpty) h = (h + 1) & (table - 1);
    s_cand[h] = i;
  }
  __syncthreads();
  const int64_t rows = cov_words * 32;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < t;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int32_t v = flat[e];
    if (v < 0) continue;
    int h = table_slot(v, shift);
    int32_t key = s_key[h];
    if (key == kEmpty) continue;           // the common case: no candidate
    int32_t r;
    if (!row_in(valid, ids, e, rows, &r)) continue;
    const uint32_t bit = 1u << (r & 31);
    if (__ldg(cov + (r >> 5)) & bit) continue;
    for (; key != kEmpty; h = (h + 1) & (table - 1), key = s_key[h]) {
      if (key != v) continue;
      const int i = s_cand[h];
      const uint32_t old = atomicOr(scratch + int64_t(i) * cov_words + (r >> 5),
                                    bit);
      if (old & bit) continue;
      if (roww)          // the weighted form: a float count (its bits)
        atomicAdd(reinterpret_cast<float*>(s_cnt) + i, __ldg(roww + r));
      else
        atomicAdd(&s_cnt[i], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    if (!s_cnt[i]) continue;
    if (roww)
      atomicAdd(reinterpret_cast<float*>(out) + i, __int_as_float(s_cnt[i]));
    else
      atomicAdd(out + i, s_cnt[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
celf_apply_kernel(const int32_t* __restrict__ flat,
                  const int32_t* __restrict__ ids,
                  const uint8_t* __restrict__ valid, int64_t t,
                  uint32_t* __restrict__ cov, int64_t cov_words, int32_t u,
                  const float* __restrict__ roww,
                  int32_t* __restrict__ gain) {
  __shared__ int32_t s_gain;
  __shared__ float s_wgain;            // the weighted form's sum
  if (threadIdx.x == 0) {
    s_gain = 0;
    s_wgain = 0.f;
  }
  __syncthreads();
  const int64_t rows = cov_words * 32;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  // every lane of a warp runs the same trips, so the ballot sees them all
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < t;
       base += stride) {
    const int64_t e = base + threadIdx.x;
    bool flipped = false;
    int32_t r;
    if (e < t && flat[e] == u && row_in(valid, ids, e, rows, &r)) {
      const uint32_t bit = 1u << (r & 31);
      flipped = !(atomicOr(cov + (r >> 5), bit) & bit);
    }
    const unsigned votes = __ballot_sync(0xffffffffu, flipped);
    if (roww && votes) {
      float w = flipped ? __ldg(roww + r) : 0.f;
      for (int off = 16; off > 0; off >>= 1)
        w += __shfl_xor_sync(0xffffffffu, w, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(&s_wgain, w);
    } else if ((threadIdx.x & 31) == 0 && votes) {
      atomicAdd(&s_gain, __popc(votes));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && roww && s_wgain != 0.f)
    atomicAdd(reinterpret_cast<float*>(gain), s_wgain);
  else if (threadIdx.x == 0 && s_gain)
    atomicAdd(gain, s_gain);
}

unsigned grid_of(int64_t t) {
  int64_t blocks = (t + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return unsigned(blocks < 1 ? 1 : blocks);
}

// celf_select: one selection of the CELF lazy greedy, all k seeds in one
// cooperative launch.
//
// What it computes, seed for seed, gain for gain and count for count as
// kernels/ref.py::celf_select_ref (the reference's select_seeds_celf).
// ub[v] starts as the number of valid elements of node v < n (a row that
// repeats v counts each time).  Seed s: every node turns stale; with the
// sketch, D(v) = popcount(sk[v] | cov_sk) - popcount(cov_sk) for every node
// and the c nodes of largest key D*(n+1) - v are evaluated (one eval call).
// Then u = the first maximum of ub (the lowest id on ties); a fresh u is
// seed s, else the cc = min(c, stale nodes) stale nodes of largest key
// ub*(n+1) - v are evaluated (one eval call) and u is taken again.  An
// evaluation sets ub[v] to the rows that hold v and are not in Covered
// (a row counts when its bit flips, as in celf_eval) and makes v fresh.
// The commit ORs u's rows into Covered (gains[s] = the bits it flips), sets
// ub[u] = 0 and ORs sk[u] into cov_sk.  The keys are unique, so a batch is
// a set: the order of its candidates changes nothing.  stats: the
// candidates evaluated, the eval calls and the grid barriers run.
//
// Design.  One block of kSelThreads on each SM, cooperative (cg grid sync),
// as greedy.cu's kernels.  Block b owns the nodes [b*slots, (b+1)*slots),
// thread j of it the nodes j, j + kSelThreads, ... of that slice, and only
// the owner reads or writes a node's ub, its fresh stamp (fresh at step
// s + 1 <=> stamp == s + 1, so no clearing) and its selection value sel.
// A sweep sets each node's sel (D + 1 in the sketch's sweep, where a lane
// group takes a row and issues a column's loads of kSweepRows rows
// together; in the lazy loop's, ub + 1 for a stale node and 0 for a fresh
// one) and folds the slice's argmax key (ub << 32 | ~v) with its node's
// fresh flag and the slice's largest sel into the block's record; a
// barrier; every block then reads all the records: u, its fresh flag and
// M, the largest sel.  A batch is the cc nodes of largest key (sel << 32)
// | ~v among sel > 0, picked one of two ways.
// - The top lists (c <= kList = 32), two grid barriers an eval call.
//   Each sweep ends with the block's own kList largest keys, sorted, in
//   its list of the sweep's parity: every warp sorts 32 keys of the slice
//   at a time (a bitonic network in shuffles, a key a lane) and merges
//   them into its running list (the top half of max(a[i], b[N-1-i]) is bitonic
//   and a half-cleaner sorts it), and the 16 warps' lists merge pairwise
//   in shared memory.  After the sweep's barrier every block merges all
//   the blocks' lists: it loads them all into shared memory, keeps the
//   lists whose head is among the cc largest heads (no other list can hold
//   a key of the batch), merges those pairwise in rounds into the same
//   batch, the first cc keys of the last list, and builds a hash of it in
//   shared memory;
//   each block then evaluates its own contiguous share of the pool,
//   whose (node, row) pairs it copied on chip in the prologue (into
//   shared memory when they fit, else to the scratch): an element costs a
//   probe of the hash, and only a candidate's reads Covered.  Its counts
//   go to cnt[slot]; a barrier; the next sweep's owners of the batch's
//   nodes take them as their ub.  The bitmap words a call set first are
//   listed in the list of its parity and zeroed by the next sweep.
// - The radix pick (c > kList), four or five barriers an eval call.
//   The sweep also counts the slice's sel in two shared histograms, bits
//   [10:0] of sel < 2^11 and bits [21:11] of sel < 2^22, each then added
//   to its global copy (a ring of three pairs: a phase fills one and
//   zeroes the next).  The batch is a radix threshold select on sel: the
//   cc-th largest sel T comes from the histogram of the digit that holds
//   M's top bit (the sweep's own when M < 2^22) and of each lower digit (a
//   pass and a barrier each), by a block scan of 2,048 bins from the top.
//   The batch is every node of sel > T and the `need` lowest ids of sel ==
//   T: all of them when need is the count at T, else each block publishes
//   its count at T and, after a barrier, takes its own in id order from
//   the rank the blocks below leave.  A taken node gets (call, slot) in
//   cand[v]; its slot comes from a warp-aggregated atomic counter.  A
//   barrier.  The evaluation: each element whose node holds the call's
//   stamp in cand (an 8-byte read from L2) and whose valid row is not in
//   Covered sets the row's bit in its slot's scratch bitmap; kMaxCands
//   slots have a bitmap at a time: a larger batch runs in chunks, with a
//   barrier after each chunk and after its clearing.  A barrier.
// In both, a flipped bitmap bit counts in the block's shared count of the
// slot, added to cnt[slot] once a block, and the bitmaps are zeroed once:
// an element whose atomicOr finds its word at 0 lists the word, so a call
// writes only the words it touched.  The commit runs in the phase after
// the pick, beside the next seed's first sweep (it changes nothing that
// sweep reads): a thread an element (the block's pairs on the list path),
// warp votes of flipped Covered bits, each block's count added to gains[s]
// once; u's owner sets ub[u] = 0; each block ORs sk[u] into its own copy
// of cov_sk (shared memory when its W words fit, else its slice of the
// scratch) and counts it.  Every value that steers the control flow (u,
// its flag, M, T, need, the batch) is computed by every block from the
// same records, lists and histograms, so all blocks take the same branches
// and barriers.
//
// What bounds it.  Bytes: each eval call reads the pool's node ids (4 an
// element) and, for the elements of the candidates, their valid byte, row
// id and Covered word; each seed's sketch sweep reads the n sketch rows
// (9.7 MB at 1,024 buckets, L2-resident; 155 MB at 16,384).  Its time is
// the chain of grid barriers (two an eval call and one a seed on the list
// path, about 1.2 us each on the H100) and each phase's latency: the
// sorting networks and the merge rounds' block barriers, a few
// microseconds an eval call; greedy.cu's greedy_grid_barriers runs the
// same grid (a block of 512 on each SM) with the barriers alone.

// celf_select_kernel's phases in its clock stamps: the prologue; the
// sketch's and the lazy loop's sweeps; a block's top list (its warps'
// chunks, then their merge); reading the records; the lists' load, the
// choice of the lists to merge, and their merge into a batch; the radix
// digit passes, the tie pass and the stamping of a batch; the
// evaluation; the commit; and the grid barriers (the wait in each).
enum SelectPhase { kClProlog, kClDeltaSweep, kClLazySweep, kClTopChunks,
                   kClTopC, kClRecords, kClListLoad, kClListKeep, kClMerge,
                   kClDigits, kClTies, kClPick, kClEval, kClCommit,
                   kClBarrier, kClPhases };

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDigit = 11;               // bits a histogram bin takes
constexpr int kBins = 1 << kDigit;       // 4 bins a thread in find_digit
constexpr int kSweepRows = 4;            // rows a lane group loads at once
static_assert(kBins == 4 * kSelThreads, "find_digit takes 4 bins a thread");
constexpr int kList = 32;                // a top list's keys (c <= 32)
constexpr int kListHashBits = 7;
constexpr int kListHash = 1 << kListHashBits;   // the batch's hash entries
static_assert(kListHash >= 2 * kList, "the hash is at most half full");

struct SelectArgs {
  const int32_t* flat;
  const int32_t* ids;
  const uint8_t* valid;
  int64_t t;
  int32_t n, k, c, slots;
  int64_t cov_words;             // Covered words (num_rows / 32)
  const uint32_t* sk;            // the sketch (rows v < n), or null
  int32_t cols, lanes;           // its words a row; lanes a row (a power of 2)
  bool vector;                   // 16-byte loads of its rows
  int64_t cov_stride;            // words of a block's cov_sk in the scratch
  unsigned long long* records;   // 2 x blocks x 2
  int32_t* hist;                 // 3 pairs x 2 x kBins
  int2* cand;                    // n: (call, slot)
  int64_t* touched;              // 2 x t: bitmap words a call set first
  int32_t* touched_n;            // 2: their counts (a list a call's parity)
  int32_t* ub;                   // n
  int32_t* stamp;                // n
  uint32_t* sel;                 // n
  int32_t* cnt;                  // c
  int32_t* ties;                 // blocks
  int32_t* slot_next;            // 1
  uint32_t* cov;                 // cov_words
  uint32_t* bitmaps;             // min(c, kMaxCands) x cov_words
  uint32_t* cov_copies;          // blocks x cov_stride, or unused
  int32_t* seeds;                // k
  int32_t* gains;                // k
  long long* stats;              // 3
  // the top-list path (kLists)
  unsigned long long* lists;     // 2 x blocks x kList: each block's top list
  int2* pairs;                   // t (node, row or -1), when not on chip
  int64_t epb;                   // pool elements a block
  int64_t merge_off, pool_off;   // dynamic shared memory offsets (bytes);
  int64_t sel_off;               // < 0: the pairs, sel stay in memory
  int64_t rows_off;              // < 0: the sketch's slice stays in memory
};

__device__ __forceinline__ uint64_t warp_max64(uint64_t x) {
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFull, x, off);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ uint64_t warp_sum64(uint64_t x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// One compare-exchange step (distance j, blocks of k) of a bitonic network
// over the warp's 32 keys, key i in lane i: keys i and i ^ j swap unless
// the lower lane holds the larger where (i & k) == 0 and the smaller
// elsewhere.
__device__ __forceinline__ uint64_t bitonic_step(uint64_t x, int k, int j) {
  const int lane = threadIdx.x & 31;
  const uint64_t y = __shfl_xor_sync(kFull, x, j);
  const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
  return keep_max ? kmax(x, y) : kmin(x, y);
}

// The warp's 32 keys sorted in descending order.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) x = bitonic_step(x, k, j);
  return x;
}

// The 32 largest keys of a and b (each sorted in descending order), in
// descending order: max(a[i], b[31 - i]) is bitonic, and the half-cleaner
// steps sort it.
__device__ __forceinline__ uint64_t warp_merge(uint64_t a, uint64_t b) {
  a = kmax(a, __shfl_sync(kFull, b, 31 - (threadIdx.x & 31)));
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) a = bitonic_step(a, 32, j);
  return a;
}

// The block's largest x, in every thread; `red` is free again on return.
__device__ __forceinline__ uint64_t block_max64(uint64_t x, uint64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max64(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = warp_max64(lane < kSelWarps ? red[lane] : 0);
  __syncthreads();
  return x;
}

// The block's sum of x, in every thread; `red` is free again on return.
__device__ __forceinline__ uint64_t block_sum64(uint64_t x, uint64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum64(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = warp_sum64(lane < kSelWarps ? red[lane] : 0);
  __syncthreads();
  return x;
}

// The warp's inclusive sum of x.
__device__ __forceinline__ int32_t warp_scan(int32_t x) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// The block's exclusive sum of x in thread order (.x) and its total (.y),
// in every thread; `part` is free again on return.
__device__ __forceinline__ int2 block_scan(int32_t x, int32_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t incl = warp_scan(x);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_scan(lane < kSelWarps ? part[lane] : 0);
    if (lane < kSelWarps) part[lane] = w;
  }
  __syncthreads();
  const int2 out = make_int2((warp ? part[warp - 1] : 0) + incl - x,
                             part[kSelWarps - 1]);
  __syncthreads();
  return out;
}

// One bin add for each lane with `on`, a shared atomic for each distinct
// bin of the warp; every lane of the warp calls it.
__device__ __forceinline__ void warp_bin_add(int32_t* hist, bool on,
                                             uint32_t bin) {
  const unsigned voters = __ballot_sync(kFull, on);
  if (on) {
    const unsigned peers = __match_any_sync(voters, bin);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(hist + bin, int32_t(__popc(peers)));
  }
}

// A slot for each lane with `take` from the shared counter: the warp's
// lanes in lane order at one atomicAdd; every lane of the warp calls it.
__device__ __forceinline__ int32_t warp_slot(bool take, int32_t* next) {
  const unsigned m = __ballot_sync(kFull, take);
  if (!m) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int32_t first = 0;
  if (lane == leader) first = atomicAdd(next, __popc(m));
  first = __shfl_sync(kFull, first, leader);
  return take ? first + __popc(m & ((1u << lane) - 1)) : -1;
}

template <bool kSharedCov, bool kLists>
__global__ void __launch_bounds__(kSelThreads, 1)
celf_select_kernel(SelectArgs a) {
  extern __shared__ uint4 s_cov4[];
  __shared__ int32_t s_cnt[kMaxCands];
  __shared__ int32_t s_cand[kList];
  __shared__ int32_t s_hkey[kListHash], s_hslot[kListHash];
  __shared__ int32_t s_keep[kSelThreads], s_nkeep;
  __shared__ __align__(16) uint64_t s_heads[kSelThreads + 2];
  __shared__ int32_t s_hist[2 * kBins];
  __shared__ uint64_t red[kSelWarps];
  __shared__ int32_t part[kSelWarps];
  __shared__ int32_t s_pick[3];
  __shared__ int32_t s_flag, s_gain;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int32_t blocks = gridDim.x, me = blockIdx.x;
  const int64_t gtid = int64_t(me) * kSelThreads + tid;
  const int64_t gsize = int64_t(blocks) * kSelThreads;
  const int32_t n = a.n;
  const int64_t lo = min(int64_t(me) * a.slots, int64_t(n));
  const int64_t held = min(lo + a.slots, int64_t(n)) - lo;
  const int64_t rows = a.cov_words * 32;
  uint32_t* cov_sk = kSharedCov ? reinterpret_cast<uint32_t*>(s_cov4)
                                : a.cov_copies + int64_t(me) * a.cov_stride;
  long long barriers = 0;
  PHASE_CLOCK_START(kClPhases);
  auto sync = [&]() {
    grid.sync();
    ++barriers;
    PHASE_CLOCK(kClBarrier);
  };

  // prologue: the state zeroed, then ub = Occur
  for (int64_t v = gtid; v < n; v += gsize) {
    a.ub[v] = 0;
    a.stamp[v] = 0;
    a.cand[v] = make_int2(-1, 0);
  }
  for (int64_t i = gtid; i < a.c; i += gsize) a.cnt[i] = 0;
  const int64_t bitmap_words = int64_t(min(a.c, kMaxCands)) * a.cov_words;
  for (int64_t i = gtid; i < bitmap_words; i += gsize) a.bitmaps[i] = 0;
  for (int64_t w = gtid; w < a.cov_words; w += gsize) a.cov[w] = 0;
  for (int64_t i = gtid; i < 6 * kBins; i += gsize) a.hist[i] = 0;
  for (int64_t s = gtid; s < a.k; s += gsize) a.gains[s] = 0;
  if (gtid == 0) {
    *a.slot_next = 0;
    a.touched_n[0] = a.touched_n[1] = 0;
  }
  if (a.sk)
    for (int w = tid; w < a.cols; w += kSelThreads) cov_sk[w] = 0;
  // the list path: the block's elements [e0, e0 + e_count) as (node, row)
  // pairs, the row -1 where the element is invalid or its row outside
  // Covered, in shared memory when they fit
  unsigned char* s_dyn = reinterpret_cast<unsigned char*>(s_cov4);
  const int64_t e0 = kLists ? min(int64_t(me) * a.epb, a.t) : 0;
  const int64_t e_count = kLists ? min(e0 + a.epb, a.t) - e0 : 0;
  int2* pool = a.pool_off >= 0 ? reinterpret_cast<int2*>(s_dyn + a.pool_off)
                               : a.pairs + e0;
  // the slice's sel: in shared memory on the list path where it fits
  uint32_t* selbuf = kLists && a.sel_off >= 0
                         ? reinterpret_cast<uint32_t*>(s_dyn + a.sel_off)
                         : a.sel + lo;
  for (int64_t i = tid; i < e_count; i += kSelThreads) {
    int32_t r;
    const bool in = row_in(a.valid, a.ids, e0 + i, rows, &r);
    pool[i] = make_int2(__ldg(a.flat + e0 + i), in ? r : -1);
  }
  // the sketch's rows of the slice, read once, where they fit on chip
  const bool rows_on_chip = kLists && a.sk && a.rows_off >= 0;
  const uint32_t* sk_slice =
      rows_on_chip ? reinterpret_cast<const uint32_t*>(s_dyn + a.rows_off)
                   : a.sk + lo * a.cols;
  if (rows_on_chip) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_dyn + a.rows_off);
    for (int64_t i = tid; i < held * a.cols; i += kSelThreads)
      dst[i] = __ldg(a.sk + lo * a.cols + i);
  }
  sync();
  for (int64_t e = gtid; e < a.t; e += gsize) {
    const uint32_t v = uint32_t(__ldg(a.flat + e));
    if (__ldg(a.valid + e) && v < uint32_t(n)) {
      const unsigned peers = __match_any_sync(__activemask(), v);
      if ((tid & 31) == __ffs(peers) - 1)
        atomicAdd(a.ub + v, int32_t(__popc(peers)));
    }
  }
  PHASE_CLOCK(kClProlog);
  sync();

  int32_t call = 0;           // the next eval call (its stamp in cand)
  int32_t pending = -1;       // the call whose counts (and bitmap words) the
                              // next sweep applies (and clears)
  int32_t hp = 0;             // histogram phases so far (the ring's position)
  int32_t sweeps = 0;         // sweeps so far (the records' parity)
  uint32_t base = 0;          // popcount(cov_sk)
  long long n_evals = 0, n_calls = 0;

  auto zero_hist = [&]() {
    for (int i = tid; i < 2 * kBins; i += kSelThreads) s_hist[i] = 0;
    __syncthreads();
  };
  // add the shared histograms to the ring's pair of this phase and zero the
  // next pair (its last readers passed a barrier since)
  auto flush_hist = [&](int used) {
    __syncthreads();
    int32_t* pair = a.hist + (hp % 3) * 2 * kBins;
    for (int i = tid; i < used * kBins; i += kSelThreads)
      if (s_hist[i]) atomicAdd(pair + i, s_hist[i]);
    int32_t* next = a.hist + ((hp + 1) % 3) * 2 * kBins;
    for (int64_t i = gtid; i < 2 * kBins; i += gsize) next[i] = 0;
    ++hp;
  };
  auto last_hist = [&]() -> const int32_t* {
    return a.hist + ((hp + 2) % 3) * 2 * kBins;
  };
  // the block's record: its slice's largest key (0 for none) with that
  // node's fresh flag, and its largest sel
  auto put_record = [&](uint64_t best, bool best_fresh, uint32_t maxsel) {
    const uint64_t top = block_max64(best, red);
    if (top != 0 && best == top) s_flag = best_fresh;
    if (top == 0 && tid == 0) s_flag = 0;
    const uint64_t msel = block_max64(maxsel, red);
    if (tid == 0) {
      unsigned long long* rec =
          a.records + 2 * (int64_t(sweeps % 2) * blocks + me);
      rec[0] = top;
      rec[1] = (uint64_t(s_flag) << 32) | msel;
    }
    ++sweeps;
  };
  // every block, after the sweep's barrier: the grid's largest key, its
  // node's fresh flag, and the largest sel
  auto get_records = [&](uint64_t* key, bool* fresh, uint32_t* msel) {
    uint64_t mine = 0, aux = 0;
    if (tid < blocks) {
      const unsigned long long* rec =
          a.records + 2 * (int64_t((sweeps + 1) % 2) * blocks + tid);
      mine = __ldcg(rec);
      aux = __ldcg(rec + 1);
    }
    const uint64_t top = block_max64(mine, red);
    if (tid < blocks && mine == top && top != 0) s_flag = int32_t(aux >> 32);
    if (top == 0 && tid == 0) s_flag = 0;
    *msel = uint32_t(block_max64(aux & 0xFFFFFFFFull, red));
    *key = top;
    *fresh = s_flag != 0;
    __syncthreads();
  };
  // the digit of the rem-th largest value of a global histogram (1 <= rem
  // <= its total): the bin d, the count above it and the count at it
  auto find_digit = [&](const int32_t* hist, int64_t rem, uint32_t* d,
                        int64_t* above, int64_t* at) {
    const int top = kBins - 1 - 4 * tid;
    int32_t c4[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c4[q] = __ldcg(hist + top - q);
      sum += c4[q];
    }
    const int2 scan = block_scan(sum, part);
    if (tid == 0) s_pick[0] = -1;
    __syncthreads();
    int64_t run = scan.x;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (run < rem && run + c4[q] >= rem) {
        s_pick[0] = top - q;
        s_pick[1] = int32_t(run);
        s_pick[2] = c4[q];
      }
      run += c4[q];
    }
    __syncthreads();
    *d = uint32_t(s_pick[0]);
    *above = s_pick[1];
    *at = s_pick[2];
    __syncthreads();
  };
  // a histogram pass over the slice's sel: bits [shift + 10 : shift] of
  // every sel >= 1 whose bits above them equal `prefix`; then the barrier
  auto pass = [&](int shift, uint64_t prefix) {
    zero_hist();
    for (int64_t i0 = 0; i0 < held; i0 += kSelThreads) {
      const int64_t j = i0 + tid;
      const uint32_t x = j < held ? a.sel[lo + j] : 0u;
      const bool on = x != 0 && (uint64_t(x) >> (shift + kDigit)) == prefix;
      warp_bin_add(s_hist, on, (x >> shift) & (kBins - 1));
    }
    flush_hist(1);
    PHASE_CLOCK(kClDigits);
    sync();
  };
  // zero the bitmap words that the current call's chunks have set
  auto clear = [&]() {
    const int32_t m = __ldcg(a.touched_n);
    for (int64_t i = gtid; i < m; i += gsize)
      a.bitmaps[__ldcg(a.touched + i)] = 0;
  };
  // stamp the cc nodes of largest (sel, -v) with the next call; the last
  // sweep's histograms are the ring's last pair
  auto select = [&](int64_t cc, uint32_t m) {
    int64_t rem = cc, above = 0, at = 0;
    uint32_t d = 0;
    uint64_t prefix = 0;
    int shift = 3 * kDigit;            // no digit read yet
    if (m < (1u << kDigit)) {
      find_digit(last_hist(), rem, &d, &above, &at);
      shift = 0;
    } else if (m < (1u << (2 * kDigit))) {
      find_digit(last_hist() + kBins, rem, &d, &above, &at);
      shift = kDigit;
    }
    if (shift < 3 * kDigit) {
      prefix = d;
      rem -= above;
    }
    while (shift > 0) {
      shift = shift == 3 * kDigit ? 2 * kDigit : shift - kDigit;
      pass(shift, prefix);
      find_digit(last_hist(), rem, &d, &above, &at);
      prefix = (prefix << kDigit) | d;
      rem -= above;
    }
    PHASE_CLOCK(kClDigits);
    const uint64_t thr = prefix;
    const bool all = rem == at;        // every node of sel == T is taken
    if (gtid == 0) *a.touched_n = 0;   // the last call's list is cleared
    int32_t my_ties = 0;
    for (int64_t i0 = 0; i0 < held; i0 += kSelThreads) {
      const int64_t j = i0 + tid;
      const uint32_t x = j < held ? a.sel[lo + j] : 0u;
      const bool take = x > thr || (all && x == thr);
      my_ties += !all && x == thr;
      const int32_t slot = warp_slot(take, a.slot_next);
      if (take) a.cand[lo + j] = make_int2(call, slot);
    }
    PHASE_CLOCK(kClPick);
    if (!all) {
      const int64_t mine = int64_t(block_sum64(uint64_t(my_ties), red));
      if (tid == 0) a.ties[me] = int32_t(mine);
      PHASE_CLOCK(kClTies);
      sync();
      const int64_t below = int64_t(block_sum64(
          tid < me ? uint64_t(__ldcg(a.ties + tid)) : 0, red));
      const int64_t quota = rem - below;   // ties this block takes, in order
      if (quota > 0) {
        int64_t run = 0;
        for (int64_t i0 = 0; i0 < held; i0 += kSelThreads) {
          const int64_t j = i0 + tid;
          const bool tie = j < held && a.sel[lo + j] == thr;
          bool take = tie;
          if (quota < mine) {
            const int2 scan = block_scan(tie, part);
            take = tie && run + scan.x < quota;
            run += scan.y;
          }
          const int32_t slot = warp_slot(take, a.slot_next);
          if (take) a.cand[lo + j] = make_int2(call, slot);
        }
      }
      PHASE_CLOCK(kClTies);
    }
    sync();
  };
  // the exact evaluation of the call's cc candidates, in chunks of kMaxCands
  auto evaluate = [&](int64_t cc) {
    const int32_t chunks = int32_t((cc + kMaxCands - 1) / kMaxCands);
    for (int32_t j = 0; j < chunks; ++j) {
      const int32_t first = j * kMaxCands;
      const int32_t width = int32_t(min(int64_t(kMaxCands), cc - first));
      for (int i = tid; i < width; i += kSelThreads) s_cnt[i] = 0;
      __syncthreads();
      for (int64_t e = gtid; e < a.t; e += gsize) {
        const uint32_t v = uint32_t(__ldg(a.flat + e));
        if (v >= uint32_t(n)) continue;
        const int2 cv = __ldcg(a.cand + v);
        const uint32_t i = uint32_t(cv.y - first);
        int32_t r;
        if (cv.x != call || i >= uint32_t(width) ||
            !row_in(a.valid, a.ids, e, rows, &r))
          continue;
        const uint32_t bit = 1u << (r & 31);
        if (__ldcg(a.cov + (r >> 5)) & bit) continue;
        const int64_t word = int64_t(i) * a.cov_words + (r >> 5);
        const uint32_t old = atomicOr(a.bitmaps + word, bit);
        if (!(old & bit)) atomicAdd(&s_cnt[i], 1);
        if (!old) a.touched[atomicAdd(a.touched_n, 1)] = word;
      }
      __syncthreads();
      for (int i = tid; i < width; i += kSelThreads)
        if (s_cnt[i]) atomicAdd(a.cnt + first + i, s_cnt[i]);
      if (j == 0 && gtid == 0) *a.slot_next = 0;   // the call's slots are out
      PHASE_CLOCK(kClEval);
      sync();
      if (j + 1 < chunks) {
        clear();
        PHASE_CLOCK(kClEval);
        sync();
      }
    }
    pending = call;
    ++call;
    n_evals += cc;
    ++n_calls;
  };
  // The top-list path (kLists: c <= kList).  A sweep leaves in the
  // block's list of its parity the block's kList largest keys (sel << 32) |
  // ~v of sel > 0 (0 pads); after the sweep's barrier every block merges
  // all the lists into the same batch (s_cand, in descending key order,
  // slot = place) and its hash, and evaluates its own elements against it.
  int32_t last_cc = 0;        // the batch size of the last eval call
  // zero the bitmap words that call q set first (its parity's list)
  auto clear_list = [&](int32_t q) {
    const int32_t m = __ldcg(a.touched_n + (q & 1));
    const int64_t* list = a.touched + int64_t(q & 1) * a.t;
    for (int64_t i = gtid; i < m; i += gsize)
      a.bitmaps[__ldcg(list + i)] = 0;
  };
  // the block's top list of the slice's sel into the lists of this
  // sweep's parity: each warp sorts 32 keys at a time and merges them into
  // its running list; then the warps' lists merge pairwise in the dynamic
  // shared memory (16 -> 8 -> 4 -> 2 -> 1)
  auto block_list = [&]() {
    __syncthreads();                        // the sweep's sel is written
    const int lane = tid & 31, warp = tid >> 5;
    uint64_t run = 0;
    const int64_t chunks = (held + 31) / 32;
    for (int64_t q = warp; q < chunks; q += kSelWarps) {
      const int64_t j = q * 32 + lane;
      const uint32_t x_sel = j < held ? selbuf[j] : 0u;
      uint64_t x = x_sel ? (uint64_t(x_sel) << 32) |
                               (0xFFFFFFFFu - uint32_t(lo + j))
                         : 0;
      // a key above the running list's least, or it changes nothing
      if (!__any_sync(kFull, x > __shfl_sync(kFull, run, 31))) continue;
      x = warp_sort(x);
      run = q == warp ? x : warp_merge(run, x);   // the warp's first or not
    }
    PHASE_CLOCK(kClTopChunks);
    uint64_t* src = reinterpret_cast<uint64_t*>(s_dyn + a.merge_off);
    uint64_t* dst = src + kSelWarps * kList;
    src[warp * kList + lane] = run;
    unsigned long long* mine =
        a.lists + (int64_t(sweeps % 2) * blocks + me) * kList;
    for (int count = kSelWarps; count > 1; count >>= 1) {
      __syncthreads();
      if (warp < count / 2) {
        const uint64_t x = warp_merge(src[(2 * warp) * kList + lane],
                                      src[(2 * warp + 1) * kList + lane]);
        if (count == 2) __stcg(mine + lane, (unsigned long long)x);
        else dst[warp * kList + lane] = x;
      }
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
  };
  // every block, after a sweep's barrier: the cc largest keys of all the
  // blocks' lists -> the batch s_cand[0, cc) and its hash, s_cnt zeroed.
  // The lists are loaded into shared memory; pairs of the kept ones merge
  // in rounds between two parts of the dynamic shared memory.
  auto merge_lists = [&](int64_t cc) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < kListHash; i += kSelThreads) s_hkey[i] = kEmpty;
    for (int i = tid; i < cc; i += kSelThreads) s_cnt[i] = 0;
    const unsigned long long* lists =
        a.lists + int64_t((sweeps + 1) % 2) * blocks * kList;
    uint64_t* src = reinterpret_cast<uint64_t*>(s_dyn + a.merge_off);
    uint64_t* dst = src + int64_t(blocks) * kList;
    // every list into shared memory, all loads in flight together, and the
    // heads side by side (a 0 past an odd count)
    for (int64_t i = tid; i < int64_t(blocks) * kList; i += kSelThreads)
      src[i] = __ldcg(lists + i);
    if (tid <= blocks) s_heads[tid] = tid < blocks ? __ldcg(lists + int64_t(
                                                         tid) * kList)
                                                   : 0;
    if (tid == 0) s_nkeep = 0;
    __syncthreads();
    PHASE_CLOCK(kClListLoad);
    // only the lists whose head is among the cc largest heads can hold a
    // key of the batch (a key of another list is below its head, below
    // cc heads; heads are unique keys or 0): the merge takes those alone
    if (tid < blocks) {
      const uint64_t head = s_heads[tid];
      const ulonglong2* pairs2 = reinterpret_cast<const ulonglong2*>(s_heads);
      int above = 0;
#pragma unroll 8
      for (int b = 0; b < (blocks + 1) / 2; ++b) {
        const ulonglong2 h = pairs2[b];
        above += (h.x > head) + (h.y > head);
      }
      if (head != 0 && above < cc) s_keep[atomicAdd(&s_nkeep, 1)] = tid;
    }
    __syncthreads();
    PHASE_CLOCK(kClListKeep);
    const int kept = s_nkeep;      // 0 only when every list is empty
    // rounds of pairwise merges, src -> dst, an odd last list with zeros;
    // the first round's lists are the kept ones (list 0 when none is)
    for (int count = kept > 0 ? kept : 1, first = 1, half; count > 1 || first;
         count = half, first = 0) {
      if (!first) __syncthreads();
      half = (count + 1) / 2;
      for (int m = warp; m < half; m += kSelWarps) {
        const int64_t xa = first ? (kept > 0 ? s_keep[2 * m] : 0) : 2 * m;
        const int64_t ya = 2 * m + 1 >= count ? -1
                           : first            ? s_keep[2 * m + 1]
                                              : 2 * m + 1;
        dst[m * kList + lane] = warp_merge(
            src[xa * kList + lane], ya >= 0 ? src[ya * kList + lane] : 0);
      }
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
    __syncthreads();
    if (tid < cc) {
      const int32_t v = int32_t(0xFFFFFFFFu - uint32_t(src[tid]));
      s_cand[tid] = v;
      int h = table_slot(v, 32 - kListHashBits);
      while (atomicCAS(&s_hkey[h], kEmpty, v) != kEmpty)
        h = (h + 1) & (kListHash - 1);
      s_hslot[h] = tid;
    }
    __syncthreads();
  };
  // the exact evaluation of the batch: the block's elements probe its
  // hash in shared memory
  auto evaluate_list = [&](int64_t cc) {
    const int q = call & 1;
    int64_t* list = a.touched + int64_t(q) * a.t;
    int32_t* list_n = a.touched_n + q;
    if (gtid == 0) a.touched_n[q ^ 1] = 0;   // the last call's, cleared
    for (int64_t i = tid; i < e_count; i += kSelThreads) {
      const int2 pr = pool[i];
      if (pr.y < 0 || uint32_t(pr.x) >= uint32_t(n)) continue;
      int h = table_slot(pr.x, 32 - kListHashBits);
      int32_t key = s_hkey[h];
      while (key != kEmpty && key != pr.x) {
        h = (h + 1) & (kListHash - 1);
        key = s_hkey[h];
      }
      if (key == kEmpty) continue;           // the common case
      const int slot = s_hslot[h];
      const uint32_t bit = 1u << (pr.y & 31);
      if (__ldcg(a.cov + (pr.y >> 5)) & bit) continue;
      const int64_t word = int64_t(slot) * a.cov_words + (pr.y >> 5);
      const uint32_t old = atomicOr(a.bitmaps + word, bit);
      if (!(old & bit)) atomicAdd(&s_cnt[slot], 1);
      if (!old) list[atomicAdd(list_n, 1)] = word;
    }
    __syncthreads();
    for (int i = tid; i < cc; i += kSelThreads)
      if (s_cnt[i]) atomicAdd(a.cnt + i, s_cnt[i]);
    last_cc = int32_t(cc);
    PHASE_CLOCK(kClEval);
    sync();
    pending = call;
    ++call;
    n_evals += cc;
    ++n_calls;
  };
  // the lazy loop's sweep at step `step`
  auto lazy_sweep = [&](int32_t step) {
    if (kLists) {
      // the last call's counts to its candidates in this slice
      if (pending >= 0) {
        for (int i = tid; i < last_cc; i += kSelThreads) {
          const int32_t v = s_cand[i];
          if (v >= lo && v < lo + held) {
            a.ub[v] = __ldcg(a.cnt + i);
            a.stamp[v] = step;
            a.cnt[i] = 0;
          }
        }
        __syncthreads();
      }
    } else {
      zero_hist();
    }
    uint64_t best = 0;
    bool best_fresh = false;
    uint32_t maxsel = 0;
    for (int64_t i0 = 0; i0 < held; i0 += kSelThreads) {
      const int64_t j = i0 + tid;
      uint32_t x = 0;
      if (j < held) {
        const int64_t v = lo + j;
        int32_t o = __ldcg(a.ub + v);
        bool fresh = __ldcg(a.stamp + v) == step;
        if (!kLists && pending >= 0) {
          const int2 cv = __ldcg(a.cand + v);
          if (cv.x == pending) {
            o = __ldcg(a.cnt + cv.y);
            a.cnt[cv.y] = 0;
            a.ub[v] = o;
            a.stamp[v] = step;
            fresh = true;
          }
        }
        const uint64_t key = (uint64_t(uint32_t(o)) << 32) |
                             (0xFFFFFFFFu - uint32_t(v));
        if (key > best) {
          best = key;
          best_fresh = fresh;
        }
        x = fresh ? 0u : uint32_t(o) + 1u;
        selbuf[j] = x;
        maxsel = max(maxsel, x);
      }
      if (!kLists) {
        warp_bin_add(s_hist, x != 0 && x < (1u << kDigit), x & (kBins - 1));
        warp_bin_add(s_hist + kBins, x != 0 && x < (1u << (2 * kDigit)),
                     (x >> kDigit) & (kBins - 1));
      }
    }
    if (pending >= 0) {
      if (kLists) clear_list(pending);
      else clear();
    }
    pending = -1;
    if (kLists) {
      PHASE_CLOCK(kClLazySweep);
      block_list();
      put_record(best, best_fresh, maxsel);
      PHASE_CLOCK(kClTopC);
    } else {
      flush_hist(2);
      put_record(best, best_fresh, maxsel);
      PHASE_CLOCK(kClLazySweep);
    }
    sync();
  };
  // the sketch's sweep: sel = D + 1 for every node of the slice
  auto delta_sweep = [&]() {
    if (!kLists) zero_hist();
    uint32_t maxsel = 0;
    const int lanes = a.lanes, sub = tid & (lanes - 1);
    const int64_t groups = kSelThreads / lanes, g = tid / lanes;
    const uint4* cov4 = reinterpret_cast<const uint4*>(cov_sk);
    for (int64_t r0 = 0; r0 < held; r0 += groups * kSweepRows) {
      // the group's rows r0 + g + i * groups: a column's loads of all of
      // them go out together (a row past the slice reads its last row)
      const uint32_t* row[kSweepRows];
      uint32_t cnt[kSweepRows];
#pragma unroll
      for (int i = 0; i < kSweepRows; ++i) {
        row[i] = sk_slice + min(r0 + g + i * groups, held - 1) * a.cols;
        cnt[i] = 0;
      }
      if (a.vector) {
        for (int q = sub; q < a.cols / 4; q += lanes) {
          const uint4 y = cov4[q];
          uint4 x[kSweepRows];
#pragma unroll
          for (int i = 0; i < kSweepRows; ++i) {
            const uint4* row4 = reinterpret_cast<const uint4*>(row[i]);
            x[i] = rows_on_chip ? row4[q] : __ldg(row4 + q);
          }
#pragma unroll
          for (int i = 0; i < kSweepRows; ++i)
            cnt[i] += __popc(x[i].x | y.x) + __popc(x[i].y | y.y) +
                      __popc(x[i].z | y.z) + __popc(x[i].w | y.w);
        }
      } else {
        for (int w = sub; w < a.cols; w += lanes) {
          const uint32_t y = cov_sk[w];
          uint32_t x[kSweepRows];
#pragma unroll
          for (int i = 0; i < kSweepRows; ++i)
            x[i] = rows_on_chip ? row[i][w] : __ldg(row[i] + w);
#pragma unroll
          for (int i = 0; i < kSweepRows; ++i) cnt[i] += __popc(x[i] | y);
        }
      }
#pragma unroll
      for (int i = 0; i < kSweepRows; ++i) {
        const int64_t j = r0 + g + i * groups;
        uint32_t c = cnt[i];
        for (int off = lanes >> 1; off > 0; off >>= 1)
          c += __shfl_down_sync(kFull, c, off, lanes);
        const bool on = sub == 0 && j < held;
        const uint32_t x = c - base + 1u;
        if (on) {
          selbuf[j] = x;
          maxsel = max(maxsel, x);
        }
        if (!kLists) {
          warp_bin_add(s_hist, on && x < (1u << kDigit), x & (kBins - 1));
          warp_bin_add(s_hist + kBins, on && x < (1u << (2 * kDigit)),
                       (x >> kDigit) & (kBins - 1));
        }
      }
    }
    if (kLists) {
      PHASE_CLOCK(kClDeltaSweep);
      block_list();
      put_record(0, false, maxsel);
      PHASE_CLOCK(kClTopC);
    } else {
      flush_hist(2);
      put_record(0, false, maxsel);
      PHASE_CLOCK(kClDeltaSweep);
    }
    sync();
  };
  // seed s = u: its rows into Covered, ub[u] = 0, sk[u] into cov_sk
  auto commit = [&](int32_t u, int32_t s) {
    if (u >= lo && u < lo + held && (u - lo) % kSelThreads == tid)
      a.ub[u] = 0;
    if (tid == 0) s_gain = 0;
    __syncthreads();
    if (kLists) {
      // the block's own elements, on chip
      for (int64_t b0 = 0; b0 < e_count; b0 += kSelThreads) {
        const int64_t i = b0 + tid;
        bool flipped = false;
        if (i < e_count) {
          const int2 pr = pool[i];
          if (pr.x == u && pr.y >= 0) {
            const uint32_t bit = 1u << (pr.y & 31);
            flipped = !(atomicOr(a.cov + (pr.y >> 5), bit) & bit);
          }
        }
        const unsigned votes = __ballot_sync(kFull, flipped);
        if ((tid & 31) == 0 && votes)
          atomicAdd(&s_gain, int32_t(__popc(votes)));
      }
    } else {
      for (int64_t b0 = int64_t(me) * kSelThreads; b0 < a.t; b0 += gsize) {
        const int64_t e = b0 + tid;
        bool flipped = false;
        int32_t r;
        if (e < a.t && __ldg(a.flat + e) == u &&
            row_in(a.valid, a.ids, e, rows, &r)) {
          const uint32_t bit = 1u << (r & 31);
          flipped = !(atomicOr(a.cov + (r >> 5), bit) & bit);
        }
        const unsigned votes = __ballot_sync(kFull, flipped);
        if ((tid & 31) == 0 && votes)
          atomicAdd(&s_gain, int32_t(__popc(votes)));
      }
    }
    if (a.sk) {
      const uint32_t* row = a.sk + int64_t(u) * a.cols;
      uint64_t pop = 0;
      for (int w = tid; w < a.cols; w += kSelThreads) {
        const uint32_t x = cov_sk[w] | __ldg(row + w);
        cov_sk[w] = x;
        pop += __popc(x);
      }
      base = uint32_t(block_sum64(pop, red));
    }
    __syncthreads();
    if (tid == 0 && s_gain) atomicAdd(a.gains + s, s_gain);
    PHASE_CLOCK(kClCommit);
  };

  int32_t u = 0;
  for (int32_t s = 0; s < a.k; ++s) {
    const int32_t step = s + 1;
    int64_t fresh_n = 0;
    if (s > 0) commit(u, s - 1);
    uint64_t key;
    bool fresh;
    uint32_t m;
    if (a.sk) {
      delta_sweep();
      get_records(&key, &fresh, &m);
      PHASE_CLOCK(kClRecords);
      if (kLists) {
        merge_lists(a.c);
        PHASE_CLOCK(kClMerge);
        evaluate_list(a.c);
      } else {
        select(a.c, m);
        evaluate(a.c);
      }
      fresh_n += a.c;
    }
    while (true) {
      lazy_sweep(step);
      get_records(&key, &fresh, &m);
      PHASE_CLOCK(kClRecords);
      u = int32_t(0xFFFFFFFFu - uint32_t(key));
      if (fresh) break;
      const int64_t cc = min(int64_t(a.c), int64_t(n) - fresh_n);
      if (kLists) {
        merge_lists(cc);
        PHASE_CLOCK(kClMerge);
        evaluate_list(cc);
      } else {
        select(cc, m);
        evaluate(cc);
      }
      fresh_n += cc;
    }
    if (gtid == 0) a.seeds[s] = u;
  }
  commit(u, a.k - 1);
  PHASE_CLOCK_END();
  if (gtid == 0) {
    a.stats[0] = n_evals;
    a.stats[1] = n_calls;
    a.stats[2] = barriers;
  }
}

// celf_select_kernel in the form that a launch takes: cov_sk in shared
// memory or not, and the top lists or the radix pick.
const void* select_kernel(bool shared, bool lists) {
  if (lists)
    return shared ? reinterpret_cast<const void*>(
                        celf_select_kernel<true, true>)
                  : reinterpret_cast<const void*>(
                        celf_select_kernel<false, true>);
  return shared ? reinterpret_cast<const void*>(
                      celf_select_kernel<true, false>)
                : reinterpret_cast<const void*>(
                      celf_select_kernel<false, false>);
}

// celf_select_kernel's grid on card `device`, read once a card: one block
// on each SM, and the dynamic shared memory (in words) that a block may
// take beside the static, the limit raised for every form.
cudaError_t select_grid_for(int device, int* blocks, int64_t* shared_words) {
  static int sms[kMaxDevices];
  static int64_t bytes[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    cudaError_t err = one_block_an_sm(select_kernel(true, false),
                                      select_kernel(false, false), kSelThreads,
                                      0, device, &sms[device],
                                      &bytes[device]);
    // the list forms have the same static shared memory
    for (int shared = 0; shared < 2 && err == cudaSuccess; ++shared) {
      const void* kernel = select_kernel(shared != 0, true);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(bytes[device]));
      int resident = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, kernel, kSelThreads, size_t(bytes[device]));
      if (err == cudaSuccess && resident < 1)
        err = cudaErrorCooperativeLaunchTooLarge;
    }
    // a thread reads each block's record and tie count
    if (err == cudaSuccess && sms[device] > kSelThreads)
      err = cudaErrorNotSupported;
    if (err != cudaSuccess) {
      sms[device] = 0;
      return err;
    }
  }
  *blocks = sms[device];
  *shared_words = bytes[device] / 4;
  return cudaSuccess;
}

// celf_select's form and the byte offsets of its scratch and dynamic
// shared memory (kernels/celf.py::select_layout says the same).
// The form: the top-list path with lists of kList keys at c <= kList
// while its merge buffers fit the shared memory
// (else the radix pick, list 0); cov_sk in shared memory (`shared`) while
// it fits beside them; the pool's (node, row) pairs on chip while they fit
// after both (pool_off >= 0), the slice's sel before them (sel_off >= 0)
// and the slice's sketch rows after them (rows_off >= 0).  The dynamic
// shared memory: cov_sk (stride words, when shared and there is a
// sketch), the merge buffers (the blocks' lists and half as many, at least
// 24 lists), the slice's sel (slots uint32, to 16 bytes), the block's
// pairs (epb int2, to 16 bytes), the slice's rows (slots x cols
// uint32).  The scratch: the records (2 x blocks x 16), the lists (2 x
// blocks x list uint64), the pairs (t int2, when not on chip), the
// histogram ring (6 x kBins int32), cand (n int2), the touched words (2 x
// t int64), ub, stamp and sel (n each), cnt (c), ties (blocks), the slot
// and touched counters (4 int32), Covered (cov_words) and the bitmaps
// (min(c, kMaxCands) x cov_words), then, when cov_sk is not in shared
// memory, each block's cov_sk from the next 16-byte boundary (round_up(
// cols, 4) words each).
struct SelectLayout {
  int list;
  bool shared;
  int64_t epb, merge_off, sel_off, pool_off, rows_off, dynamic;
  int64_t lists, pairs, hist, cand, touched, ub, stamp, sel, cnt, ties, next,
      cov, bitmaps, copies;
  int64_t stride, total;
};

SelectLayout select_layout(int32_t n, int64_t cov_words, int32_t c,
                           int32_t cols, int blocks, int64_t shared_words,
                           int64_t t) {
  SelectLayout l;
  const int64_t limit = 4 * shared_words;
  l.stride = (int64_t(cols) + 3) & ~int64_t(3);
  l.list = c <= kList ? kList : 0;
  int64_t merge_lists = int64_t(blocks) + (int64_t(blocks) + 1) / 2;
  if (merge_lists < kSelWarps + kSelWarps / 2)
    merge_lists = kSelWarps + kSelWarps / 2;
  int64_t merge = l.list ? 8 * int64_t(l.list) * merge_lists : 0;
  if (merge > limit) {
    l.list = 0;
    merge = 0;
  }
  const int64_t cov_bytes = cols ? 4 * l.stride : 0;
  l.shared = cov_bytes + merge <= limit;
  l.merge_off = l.shared ? cov_bytes : 0;
  l.epb = (t + blocks - 1) / blocks;
  const int64_t slots = (int64_t(n) + blocks - 1) / blocks;
  const int64_t sel_bytes = (4 * slots + 15) & ~int64_t(15);
  int64_t end = l.merge_off + merge;
  l.sel_off = l.list && end + sel_bytes <= limit ? end : -1;
  if (l.sel_off >= 0) end += sel_bytes;
  l.pool_off = l.list && end + 8 * l.epb <= limit ? end : -1;
  if (l.pool_off >= 0) end = (end + 8 * l.epb + 15) & ~int64_t(15);
  const int64_t rows_bytes = 4 * slots * int64_t(cols);
  l.rows_off = l.list && cols && end + rows_bytes <= limit ? end : -1;
  l.dynamic = l.rows_off >= 0 ? end + rows_bytes : end;
  l.lists = 32 * int64_t(blocks);
  l.pairs = l.lists + 16 * int64_t(blocks) * l.list;
  l.hist = l.pairs + (l.list && l.pool_off < 0 ? 8 * t : 0);
  l.cand = l.hist + 4 * 6 * int64_t(kBins);
  l.touched = l.cand + 8 * int64_t(n);
  l.ub = l.touched + 16 * t;
  l.stamp = l.ub + 4 * int64_t(n);
  l.sel = l.stamp + 4 * int64_t(n);
  l.cnt = l.sel + 4 * int64_t(n);
  l.ties = l.cnt + 4 * int64_t(c);
  l.next = l.ties + 4 * int64_t(blocks);
  l.cov = l.next + 16;
  l.bitmaps = l.cov + 4 * cov_words;
  end = l.bitmaps + 4 * int64_t(c < kMaxCands ? c : kMaxCands) * cov_words;
  l.copies = (end + 15) & ~int64_t(15);
  l.total = l.shared ? end : l.copies + 4 * int64_t(blocks) * l.stride;
  return l;
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream` of card
// `device` and returns the cudaError_t of its memset or its launch.

// buf: c + c * cov_words int32, zeroed here; out = buf[0:c].  1 <= c <=
// kMaxCands (kernels/celf.py::MAX_CANDS).  roww: null, or 32 * cov_words
// float32 row weights (the weighted form: out holds float32 sums).
extern "C" int celf_eval(const void* flat, const void* ids, const void* valid,
                         int64_t t, const void* cov, int64_t cov_words,
                         const void* cands, int c, const void* roww,
                         void* buf, int device, void* stream) {
  if (c < 1 || c > kMaxCands || cov_words < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(buf);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * size_t(c) * size_t(1 + cov_words), s);
  if (err != cudaSuccess) return int(err);
  if (t <= 0) return int(cudaGetLastError());
  int bits = 0;
  while ((1 << bits) < 2 * c || (1 << bits) < kMinTable) ++bits;
  celf_eval_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), t,
      static_cast<const uint32_t*>(cov), cov_words,
      static_cast<const int32_t*>(cands), c, bits,
      static_cast<const float*>(roww), out,
      reinterpret_cast<uint32_t*>(out + c));
  return int(cudaGetLastError());
}

// gain: one int32 (float32 in the weighted form, roww non-null: 32 *
// cov_words float32 row weights), zeroed here; cov: cov_words uint32,
// updated in place.
extern "C" int celf_apply(const void* flat, const void* ids, const void* valid,
                          int64_t t, void* cov, int64_t cov_words, int32_t u,
                          const void* roww, void* gain, int device,
                          void* stream) {
  if (cov_words < 1) return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(gain, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return int(err);
  if (t <= 0) return int(cudaGetLastError());
  celf_apply_kernel<<<grid_of(t), kThreads, 0, s>>>(
      static_cast<const int32_t*>(flat), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), t, static_cast<uint32_t*>(cov),
      cov_words, u, static_cast<const float*>(roww),
      static_cast<int32_t*>(gain));
  return int(cudaGetLastError());
}

// celf_select's grid on card `device`: its blocks (one on each SM) and the
// widest cov_sk in words that stays in shared memory (a wider one takes
// the scratch copies).
extern "C" int celf_select_grid(int device, int* blocks,
                                int64_t* shared_words) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(select_grid_for(device, blocks, shared_words));
}

// flat, ids: t int32; valid: t bytes (0 or 1); 0 <= t < 2^31, 1 <= n <
// 2^31 - 1, num_rows a positive multiple of 32 below 2^31, k >= 1, 1 <= c
// <= n.  sketch: null (cols 0) or rows of `cols` uint32 words, rows v < n
// read (1 <= cols < 2^26; lanes a power of two in [1, 32]; vector: cols %
// 4 == 0 and the words 16-byte aligned).  scratch: at least the layout's
// bytes (kernels/celf.py::select_scratch_bytes; the kernel initialises what
// it reads); out: 2k int32 (seeds, gains) then 3 int64 (the candidates
// evaluated, the eval calls, the grid barriers), 8-byte aligned.  Launches
// on `stream` of card `device`; returns the cudaError_t of the launch.
extern "C" int celf_select(const void* flat, const void* ids,
                           const void* valid, int64_t t, int32_t n,
                           int64_t num_rows, int32_t k, int32_t c,
                           const void* sketch, int32_t cols, int lanes,
                           int vector, void* scratch, int64_t scratch_bytes,
                           void* out, int device, void* stream) {
  if (t < 0 || t > 0x7FFFFFFF || n < 1 || n == 0x7FFFFFFF || num_rows < 32 ||
      num_rows % 32 != 0 || num_rows > 0x7FFFFFFF || k < 1 || c < 1 ||
      c > n)
    return int(cudaErrorInvalidValue);
  if (sketch ? (cols < 1 || cols >= (1 << 26) || lanes < 1 || lanes > 32 ||
                (lanes & (lanes - 1)) != 0 ||
                (vector && (cols % 4 != 0 ||
                            (reinterpret_cast<uintptr_t>(sketch) & 15u))))
             : cols != 0)
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_words = 0;
  cudaError_t err = select_grid_for(device, &blocks, &shared_words);
  if (err != cudaSuccess) return int(err);
  const SelectLayout l =
      select_layout(n, num_rows / 32, c, cols, blocks, shared_words, t);
  if (scratch_bytes < l.total) return int(cudaErrorInvalidValue);
  uint8_t* at = static_cast<uint8_t*>(scratch);
  SelectArgs a;
  a.flat = static_cast<const int32_t*>(flat);
  a.ids = static_cast<const int32_t*>(ids);
  a.valid = static_cast<const uint8_t*>(valid);
  a.t = t;
  a.n = n;
  a.k = k;
  a.c = c;
  a.slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  a.cov_words = num_rows / 32;
  a.sk = static_cast<const uint32_t*>(sketch);
  a.cols = cols;
  a.lanes = sketch ? lanes : 1;
  a.vector = sketch && vector;
  a.cov_stride = l.stride;
  a.records = reinterpret_cast<unsigned long long*>(at);
  a.lists = reinterpret_cast<unsigned long long*>(at + l.lists);
  a.pairs = reinterpret_cast<int2*>(at + l.pairs);
  a.epb = l.epb;
  a.merge_off = l.merge_off;
  a.sel_off = l.sel_off;
  a.pool_off = l.pool_off;
  a.rows_off = l.rows_off;
  a.hist = reinterpret_cast<int32_t*>(at + l.hist);
  a.cand = reinterpret_cast<int2*>(at + l.cand);
  a.touched = reinterpret_cast<int64_t*>(at + l.touched);
  a.ub = reinterpret_cast<int32_t*>(at + l.ub);
  a.stamp = reinterpret_cast<int32_t*>(at + l.stamp);
  a.sel = reinterpret_cast<uint32_t*>(at + l.sel);
  a.cnt = reinterpret_cast<int32_t*>(at + l.cnt);
  a.ties = reinterpret_cast<int32_t*>(at + l.ties);
  a.slot_next = reinterpret_cast<int32_t*>(at + l.next);
  a.touched_n = a.slot_next + 1;
  a.cov = reinterpret_cast<uint32_t*>(at + l.cov);
  a.bitmaps = reinterpret_cast<uint32_t*>(at + l.bitmaps);
  a.cov_copies = reinterpret_cast<uint32_t*>(at + l.copies);
  a.seeds = static_cast<int32_t*>(out);
  a.gains = a.seeds + k;
  a.stats = reinterpret_cast<long long*>(a.seeds + 2 * int64_t(k));
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(select_kernel(l.shared, l.list),
                                    dim3(blocks), dim3(kSelThreads), args,
                                    size_t(l.dynamic),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
