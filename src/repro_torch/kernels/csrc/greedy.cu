// Greedy max-coverage in one cooperative launch each, for Hopper (sm_90a):
// greedy_flat on the flat RR pool (paper Alg. 7, the reference's fused
// scan), greedy_flat_variant (the same kernel with the problem variants'
// feasibility and score), greedy_stacked (R of those selections on one
// pool) and, further down, greedy_sketch on the approximate mode's
// coverage sketch.  All run all k seed steps inside the launch.
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
// Inputs: the pool as the store holds it, flat (node ids), ids (row ids,
// non-decreasing: rows are contiguous and in row order) and valid (a byte
// an element).  An element counts for its node when it is valid and its
// node lies below n.  The launch builds the pool's two indices itself
// (kernels/ref.py::flat_index states them): row r's elements are
// [row_start[r], row_start[r + 1]), and the rows that hold node v are
// count[v] entries of inv_rows, in no set order (no result depends on it).
//
// Design.  One cooperative launch (cudaLaunchCooperativeKernel), one block
// of kThreads on each SM, k + 3 grid barriers (cooperative_groups' grid
// sync: a release add and acquire polls on one counter in a workspace that
// the cooperative launch provides, so no -rdc is needed).  Block b owns
// the nodes [b * slots, (b + 1) * slots), slots = ceil(n / blocks) (a
// block past n owns none), and keeps their list starts, their Occur and
// its own copy of Covered (a bit a row) in dynamic shared memory when they
// fit (the limit raised once a card), else in its own part of the
// scratch, read with __ldcg.
// - Prologue, no sort.  (A) count zeroed; row_start[r] the lower bound of
//   r in ids, by a binary search.  Barrier.  (B) each element's node, or
//   -1 when it does not count, into nodes[e], and count[v] += 1 for each
//   counted one (a warp's lanes on one node add together: a hub's word
//   would take an atomic an element).  Barrier.  (C) each block copies its
//   slice's counts into its Occur and their exclusive scan into its list
//   starts and cursor, writes the slice's total to block_sum[b] and zeroes
//   its Covered.  Barrier.  (D) each block sums block_sum into every
//   block's base (in its shared memory), and each counted element's list
//   entry lands at its block's base + atomicAdd(cursor[v], 1) (a warp's
//   lanes on one node together, each at its rank): its row r in inv_rows
//   and the row's span of elements, row_start[r] and row_start[r + 1], in
//   inv_span.  Node v's entries are then [base + start, base + next
//   start) of its block.
// - Step s, the exchange: each block takes the argmax of its slice (a
//   thread folds its strided share into one (occur, ~v) pair; a warp
//   reduces with two redux.sync, the largest occur and then the largest
//   ~v among the lanes that hold it; the block likewise over its warps)
//   and writes its record: the 64-bit key (occur << 32) | (0xFFFFFFFF -
//   v) and its node's span of entries, from its list starts.  Barrier.
//   Every block reads all the records, a thread each, and reduces the keys
//   the same way: u_s, its gain (the key's occur) and its entries, with no
//   read that depends on u_s.  The records of a step are its own, so none
//   is reset, and they are the only thing written between two barriers
//   that another block reads.
// - Step s, the cover (but at the last step): every block walks ALL of
//   u_s's entries, 32 a warp, read through L1 (the lists do not change
//   after the prologue).  A lane an entry tests and sets the row's bit in
//   the block's own Covered (atomicOr, whose old word says whether the row
//   is new); a warp scan of the new rows' lengths lays their elements end
//   to end, the warp walks them kWalk x 32 at a time (a lane finds each
//   position's row by a binary search over the scan, in shuffles, and
//   loads the kWalk nodes together), and each element in the block's
//   slice but u_s takes one off its Occur (a shared-memory atomicSub);
//   u_s's own count is set to 0, since all its rows are now covered.
//   Every block replays the same rows, so the copies of Covered stay
//   equal; a row appears once in u_s's list, so its bit has one writer in
//   a block.
//
// greedy_flat_variant (kVariant).  The reference's fused_variant scan
// (src/repro/core/coverage.py:1552, unweighted; the plain version is
// kernels/ref.py::greedy_flat_variant_ref): the same launch, prologue and
// steps, with these changes.
// - Feasibility: a node is a candidate, not picked yet, and its group (of
//   n_group ids) has quota left; with costs also cost <= budget - spent
//   (__fsub_rn, XLA's float32 subtraction) and Occur > 0.  A block keeps a
//   "blocked" bit a slice node and the quotas of the groups its slice
//   meets, beside its Occur.  The bits are set from ~cand in (C) (all of
//   them when the quota is 0), at the node's pick, and over the group's
//   part of the slice when a pick spends the group's quota, so the scan
//   tests one bit a node and never the quotas.  Every block sees every
//   pick, so each keeps its own copies and no block reads another's.
// - Keys: (occur + 1) << 32 | (0xFFFFFFFF - v) without costs, so a
//   feasible node with Occur 0 still beats "none"; with costs
//   bits(__fdiv_rn(float(occur), cost)) << 32 | (0xFFFFFFFF - v): the bits
//   of a positive float32 order as the float, so the first maximum is the
//   reference's argmax.  Key 0: no feasible node.
// - The record carries the node's Occur too (the key no longer does with
//   costs), and the step's gain is read from the winner's record.
// - A step with no feasible node changes nothing, so the launch stops
//   there and fills the steps left with the sentinel n and gain 0.
//   spent, kept by every thread, takes each pick's cost in step order
//   (__fadd_rn), and is written out at the end.
//
// greedy_flat_variant, weighted form (kWeighted, given ew: each element's
// float32 row weight, the row-weighted store's).  Replaces no Pallas
// kernel: the reference runs its fused_variant_w scan as plain XLA
// (src/repro/core/coverage.py:1500-1632, _variant_locals(weighted=True));
// the plain version is greedy_flat_variant_ref with ew.  Changes to the
// variant:
// - Occur is float32, kept as its bits in the same words: (A) zeroes a
//   float wocc a node, (B) adds each counted element's weight to its
//   node's (atomicAdd) and sets each row's weight, the largest valid
//   element weight of its span, floored at 0 (a thread a row), and (C)
//   copies the slice's wocc into Occur; the list starts still come from
//   the element counts.
// - Keys: an Occur x is first made canonical (x > 0 ? x : +0.0): -0.0,
//   which fmaxf and a decrement to zero can leave, has its sign bit set
//   and would order above every positive float.  Then (bits(x) + 1) << 32
//   | (0xFFFFFFFF - v) without costs, bits(__fdiv_rn(x, cost)) with costs
//   (over x > 0): non-negative floats order as their bits, so ties still
//   go to the lowest id.
// - The cover walk runs at the last step too: block 0 sums the weights of
//   the rows whose bit it flips (a warp's shuffle sum, then a shared
//   atomicAdd) into the step's gain, written as float32 bits.  Each
//   element in the slice takes its own weight off its node's Occur (a
//   shared or L2 float atomicAdd), and after the walk every slice Occur is
//   clamped at 0 (canonical), the reference's max(occur - dec, 0).
// - Float order.  The atomics add in no fixed order, and the decrements
//   go one element at a time where the reference subtracts a step's sum.
//   Where every partial sum is a float32 exactly (integer weights, or
//   multiples of 2^-j, whose sums stay below 2^24 units of the finest
//   step) the order changes nothing and every byte equals the plain
//   version's; otherwise Occur, the gains and frac may differ in their
//   last bits (relative 2^-24 a sum of positive terms per add), and so a
//   near tie may pick another seed.
//
// greedy_stacked.  Replaces no Pallas kernel: the reference's stacked scan
// (src/repro/core/coverage.py:1643, serving's batched selection, a jitted
// lax.scan whose vmapped body picks and covers for R requests a step); the
// plain version is kernels/ref.py::greedy_stacked_ref.  R selections on one
// pool in one cooperative launch, row r byte for byte the solo scan of
// request r: greedy_flat's (a plain row) or greedy_flat_variant's without
// weights (a variant row: its candidates, costs and budget, and group
// quotas).  Row r runs ks[r] steps; past them, and from a variant row's
// first step with no feasible node, it emits the sentinel n and gain 0
// and changes nothing.
// - The prologue is greedy_flat's index build, three grid barriers, with
//   a node's list start inside its block kept in global memory (lstart),
//   so any block finds any node's entries: base[block] + lstart[v], count
//   [v] of them.
// - The rows' state lives in global memory: Occur R x n int32 and Covered
//   R x ceil(num_rows / 32) words, shared by the blocks; each block keeps a
//   row's blocked bits (~cand, the picks, the spent groups) and group
//   quotas for its slice of nodes, as greedy_flat_variant does.
// - Step s: each block folds its slice of each live row's Occur into that
//   row's key (greedy_flat's (occur << 32) | ~v, or the variant's (occur +
//   1) << 32 | ~v and bits(__fdiv_rn(occur, cost)) << 32 | ~v over room =
//   __fsub_rn(budget, spent)) and writes a record a row: the key and its
//   node's Occur.  Barrier.  Every block reduces every live row's records
//   (a warp a row): u_r and its gain, the winner's Occur (the elements of
//   a row are unique, so Occur[u] counts u's uncovered rows).  Each block
//   updates its copies (spent by __fadd_rn, its blocked bits and quotas);
//   then the grid's warps share the covers of all rows' picks, 32 list
//   entries a warp: a new row's bit is set by atomicOr in row r's Covered
//   and every counted element of it takes one off row r's Occur (a global
//   atomicSub; u_r's own count reaches 0).  A row's last step walks no
//   entry.  Barrier, before the next step's keys read Occur.  Two grid
//   barriers a step whatever R is, as the reference's collectives a step
//   do not grow with R.
//
// What bounds it.  Not bytes: the pool read twice and the indices written
// once are about 1 MB at the default solve's pool, and each block reading
// every seed row's entry and its elements (from L2) adds about 0.2 MB a
// block.  The k + 3 grid barriers and each step's chain (the argmax, the
// record, the barrier, the records, the entries, the elements) set its
// time, and, at a hub's step, each block's walk of all the hub's rows;
// greedy_grid_barriers runs the same grid with the barriers alone, the
// floor.

#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop_grid.cuh"
#include "device_guard.cuh"

// Clock stamps of greedy_flat_kernel's phases: examples/greedy_variants.cu
// defines GREEDY_STAMP before it includes this file; here they are empty.
#ifndef GREEDY_STAMP
#define GREEDY_STAMP(i)
#endif
// SM clocks of greedy_sketch_kernel's phases, summed over its steps:
// examples/sketch_stamps.cu defines these (examples/phase_clock.cuh)
// before it includes this file; here they are empty.
#ifndef PHASE_CLOCK_START
#define PHASE_CLOCK_START(phases)
#define PHASE_CLOCK(p)
#define PHASE_CLOCK_END()
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kWalk = 4;        // positions a lane takes a pass of the walk

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

// The warp's inclusive sum of x.
__device__ __forceinline__ int32_t warp_inclusive_sum(int32_t x) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// The block's exclusive sum of its threads' x (.x) and the block's total
// (.y), in every thread.  `part` is reused after a barrier.
__device__ __forceinline__ int2 block_exclusive_sum(int32_t x,
                                                    int32_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t incl = warp_inclusive_sum(x);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_inclusive_sum(lane < kWarps ? part[lane] : 0);
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  return make_int2((warp ? part[warp - 1] : 0) + incl - x,
                   part[kWarps - 1]);
}

// The first index of ids[0, t) (non-decreasing) whose value is >= r.
__device__ __forceinline__ int32_t first_row_at(const int32_t* ids,
                                                int64_t t, int64_t r) {
  int64_t lo = 0, hi = t;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < r) lo = mid + 1;
    else hi = mid;
  }
  return int32_t(lo);
}

// Element e's node when it counts (valid and below n), else -1.
__device__ __forceinline__ int32_t counted_node(const int32_t* flat,
                                                const uint8_t* valid,
                                                int64_t e, int32_t n) {
  const uint32_t v = uint32_t(__ldg(flat + e));
  return __ldg(valid + e) && v < uint32_t(n) ? int32_t(v) : -1;
}

// A block's Occur and Covered: shared memory, or its part of the scratch,
// which atomics change in L2 and so is read with __ldcg.
template <bool kShared>
__device__ __forceinline__ int32_t load_state(const int32_t* p) {
  return kShared ? *p : __ldcg(p);
}

// The block's first maximum of its slice [lo, lo + held) of Occur, in
// thread 0 (the key; 0 for no node): v ascends in a thread's share, so a
// later v wins only when its count is larger; low == 0 marks a thread
// with no node (v < 2^31 - 1).
template <bool kShared>
__device__ __forceinline__ void fold_slice(const int32_t* occ, int64_t lo,
                                           int64_t held, uint32_t& best,
                                           uint32_t& low) {
  best = 0;
  low = 0;
  for (int64_t j = threadIdx.x; j < held; j += kThreads) {
    const uint32_t o = uint32_t(load_state<kShared>(occ + j));
    if (low == 0 || o > best) {
      best = o;
      low = 0xFFFFFFFFu - uint32_t(lo + j);
    }
  }
}

template <bool kShared>
__device__ __forceinline__ uint64_t slice_argmax(const int32_t* occ,
                                                 int64_t lo, int64_t held,
                                                 uint64_t* red) {
  uint32_t best, low;
  fold_slice<kShared>(occ, lo, held, best, low);
  return block_max_key(best, low, red);
}

// greedy_flat_variant's operands (a zeroed struct for greedy_flat): the
// candidate byte and float32 cost a node (costs null: no budget), the
// budget, the groups' width and quota, the words of a block's blocked bits
// and group quotas, and where spent goes.
struct VariantArgs {
  const uint8_t* cand;
  const float* costs;
  float budget;
  int32_t n_group, group_quota, blocked_words, group_words;
  float* spent;
  // the weighted form: the elements' weights, and the scratch of the
  // nodes' float Occur and the rows' weights
  const float* ew;
  float* wocc;
  float* roww;
};

// A weighted Occur's canonical value: x > 0 stays, anything else (+0.0,
// -0.0, and a negative that a decrement left) is +0.0, whose bits are 0.
__device__ __forceinline__ float canonical_occur(float x) {
  return x > 0.f ? x : 0.f;
}

// The variant's first maximum of the block's slice, in thread 0 (the key;
// 0 for no feasible node): as slice_argmax, over the feasible nodes and
// their variant scores (`room` = budget - spent).  fold_slice_variant is
// a thread's share of it.
template <bool kShared, bool kWeighted>
__device__ __forceinline__ void fold_slice_variant(
    const int32_t* occ, const int32_t* blocked, int64_t lo, int64_t held,
    const float* costs, float room, uint32_t& best, uint32_t& low) {
  best = 0;
  low = 0;
  for (int64_t j = threadIdx.x; j < held; j += kThreads) {
    if ((load_state<kShared>(blocked + (j >> 5)) >> (j & 31)) & 1) continue;
    const uint32_t v = uint32_t(lo + j);
    const int32_t o = load_state<kShared>(occ + j);
    // the weighted Occur as a canonical float (its bits order as it does)
    const float of = kWeighted ? canonical_occur(__int_as_float(o))
                               : __int2float_rn(o);
    uint32_t hi = (kWeighted ? __float_as_uint(of) : uint32_t(o)) + 1u;
    if (costs != nullptr) {
      const float c = __ldg(costs + v);
      if (!(c <= room) || !(of > 0.f)) continue;
      hi = __float_as_uint(kWeighted ? __fdiv_rn(of, c)
                                     : __fdiv_rn(__int2float_rn(o), c));
    }
    if (hi > best) {
      best = hi;
      low = 0xFFFFFFFFu - v;
    }
  }
}

template <bool kShared, bool kWeighted>
__device__ __forceinline__ uint64_t slice_argmax_variant(
    const int32_t* occ, const int32_t* blocked, int64_t lo, int64_t held,
    const VariantArgs& va, float room, uint64_t* red) {
  uint32_t best, low;
  fold_slice_variant<kShared, kWeighted>(occ, blocked, lo, held, va.costs,
                                         room, best, low);
  return block_max_key(best, low, red);
}

// Scratch (global memory): the step records (k x blocks x kRec uint64),
// inv_span t int2, count n, cursor n, row_start num_rows + 1, nodes t,
// inv_rows t and block_sum `blocks` int32, then, when the blocks' state is
// not in shared memory, each block's list starts (slots + 1), Occur
// (slots) and Covered words (and, kVariant, its blocked bits and group
// quotas).  Dynamic shared memory: each block's base (`blocks` int32),
// then, in the shared form, the block's list starts, Occur and Covered
// (and the variant's words).  A record is kRec words: the key, the span
// and (kVariant) the node's Occur; with kWeighted, the scratch also holds
// the nodes' float Occur (n) and the rows' weights (num_rows) after
// block_sum.
// The launch's body, in the kernels below: greedy_flat_kernel<kShared,
// kVariant> (greedy_flat and greedy_flat_variant) and
// greedy_flat_weighted_kernel<kShared> (the weighted form, a name of its
// own in a profile).
template <bool kShared, bool kVariant, bool kWeighted>
__device__ __forceinline__ void greedy_flat_body(
    const int32_t* __restrict__ flat, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, int64_t t, int32_t n,
    int64_t num_rows, int32_t k, int32_t slots, int32_t cov_words,
    unsigned long long* records, int2* inv_span, int32_t* count,
    int32_t* cursor, int32_t* row_start, int32_t* nodes, int32_t* inv_rows,
    int32_t* block_sum, int32_t* copies, int32_t* seeds, int32_t* gains,
    const VariantArgs& va) {
  constexpr int kRec = kVariant ? 3 : 2;
  extern __shared__ int32_t smem[];
  __shared__ uint64_t red[kWarps];
  __shared__ int32_t part[kWarps];
  __shared__ int32_t step_u, step_begin, step_end, step_gain;
  __shared__ int32_t full_lo, full_hi;   // kVariant: a spent group's part
  __shared__ float step_wgain;           // kWeighted: block 0's step gain
  static_assert(kVariant || !kWeighted, "the weighted form is a variant");
  cg::grid_group grid = cg::this_grid();
  const int32_t blocks = gridDim.x, me = blockIdx.x;
  const int64_t state_words =
      2 * int64_t(slots) + 1 + cov_words +
      (kVariant ? int64_t(va.blocked_words) + va.group_words : 0);
  int32_t* base = smem;
  int32_t* starts = kShared ? smem + blocks : copies + int64_t(me) * state_words;
  int32_t* occ = starts + slots + 1;
  uint32_t* cov = reinterpret_cast<uint32_t*>(occ + slots);
  int32_t* blocked = occ + slots + cov_words;       // kVariant
  int32_t* gbud = blocked + va.blocked_words;       // kVariant
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gtid = int64_t(me) * kThreads + threadIdx.x;
  const int64_t gsize = int64_t(blocks) * kThreads;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  GREEDY_STAMP(0);

  // (A)
  for (int64_t v = gtid; v < n; v += gsize) {
    count[v] = 0;
    if (kWeighted) va.wocc[v] = 0.f;
  }
  for (int64_t r = gtid; r <= num_rows; r += gsize)
    row_start[r] = first_row_at(ids, t, r);
  grid.sync();
  GREEDY_STAMP(1);

  // (B): the lanes of a warp that hold the same node add once; the
  // weighted form adds each element's weight to its node's float Occur
  // and sets each row's weight from its span
  for (int64_t e = gtid; e < t; e += gsize) {
    const int32_t v = counted_node(flat, valid, e, n);
    nodes[e] = v;
    if (v >= 0) {
      if (kWeighted) atomicAdd(va.wocc + v, __ldg(va.ew + e));
      const unsigned peers = __match_any_sync(__activemask(), v);
      if (lane == __ffs(peers) - 1) atomicAdd(count + v, __popc(peers));
    }
  }
  if (kWeighted) {
    for (int64_t r = gtid; r < num_rows; r += gsize) {
      float w = 0.f;
      for (int32_t e = __ldcg(row_start + r); e < __ldcg(row_start + r + 1);
           ++e)
        if (__ldg(valid + e)) w = fmaxf(w, __ldg(va.ew + e));
      va.roww[r] = canonical_occur(w);
    }
  }
  grid.sync();
  GREEDY_STAMP(2);

  // (C): thread i takes `per` consecutive nodes of the slice; the block's
  // list starts are the exclusive scan of their counts
  {
    const int64_t per = (held + kThreads - 1) / kThreads;
    const int64_t ja = min(threadIdx.x * per, held);
    const int64_t jb = min(ja + per, held);
    int32_t sum = 0;
    for (int64_t j = ja; j < jb; ++j) {
      const int32_t c = __ldcg(count + lo + j);
      occ[j] = kWeighted ? __float_as_int(__ldcg(va.wocc + lo + j)) : c;
      sum += c;
    }
    const int2 scan = block_exclusive_sum(sum, part);
    int32_t run = scan.x;
    for (int64_t j = ja; j < jb; ++j) {
      cursor[lo + j] = run;
      starts[j] = run;
      run += __ldcg(count + lo + j);
    }
    if (threadIdx.x == 0) {
      block_sum[me] = scan.y;
      starts[held] = scan.y;
    }
    for (int32_t w = threadIdx.x; w < cov_words; w += kThreads) cov[w] = 0;
    if (kVariant) {
      // a slice node outside the candidates (every node, at quota 0), and
      // each bit past the slice, is blocked from the start
      for (int32_t w = threadIdx.x; w < va.blocked_words; w += kThreads) {
        uint32_t bits = 0;
        for (int b = 0; b < 32; ++b) {
          const int64_t j = 32 * int64_t(w) + b;
          if (j >= held || va.group_quota <= 0 || !__ldg(va.cand + lo + j))
            bits |= 1u << b;
        }
        blocked[w] = int32_t(bits);
      }
      for (int32_t g = threadIdx.x; g < va.group_words; g += kThreads)
        gbud[g] = va.group_quota;
    }
  }
  grid.sync();
  GREEDY_STAMP(3);

  // (D): the blocks' bases, then each counted element's list entry (its
  // row and the row's span of elements) at its node's cursor
  if (warp == 0) {
    int32_t carry = 0;
    for (int32_t j0 = 0; j0 < blocks; j0 += 32) {
      const int32_t j = j0 + lane;
      const int32_t x = j < blocks ? __ldcg(block_sum + j) : 0;
      const int32_t incl = warp_inclusive_sum(x);
      if (j < blocks) base[j] = carry + incl - x;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
  }
  __syncthreads();
  for (int64_t e = gtid; e < t; e += gsize) {
    const int32_t v = __ldcg(nodes + e);
    if (v >= 0) {
      const unsigned peers = __match_any_sync(__activemask(), v);
      const int leader = __ffs(peers) - 1;
      int32_t first = 0;
      if (lane == leader) first = atomicAdd(cursor + v, __popc(peers));
      const int32_t pos = base[v / slots] +
                          __shfl_sync(peers, first, leader) +
                          __popc(peers & ((1u << lane) - 1));
      const int32_t r = __ldg(ids + e);
      inv_rows[pos] = r;
      inv_span[pos] = make_int2(__ldcg(row_start + r),
                                __ldcg(row_start + r + 1));
    }
  }

  float spent = 0.0f;                          // kVariant, every thread
  for (int32_t s = 0;; ++s) {
    // this block's record for step s: its key, the span [begin, end) of
    // its node's list entries (end << 32 | begin) and (kVariant) its
    // Occur, then the step's barrier, then every block reads all the
    // records
    const uint64_t mine =
        kVariant ? slice_argmax_variant<kShared, kWeighted>(
                       occ, blocked, lo, held, va,
                       __fsub_rn(va.budget, spent), red)
                 : slice_argmax<kShared>(occ, lo, held, red);
    if (threadIdx.x == 0) {
      const int64_t j = mine ? int64_t(0xFFFFFFFFu - uint32_t(mine)) - lo : 0;
      unsigned long long* rec = records + kRec * (int64_t(s) * blocks + me);
      rec[0] = mine;
      rec[1] = (uint64_t(uint32_t(base[me] +
                                  load_state<kShared>(starts + j + 1)))
                << 32) |
               uint32_t(base[me] + load_state<kShared>(starts + j));
      if (kVariant) rec[2] = uint32_t(load_state<kShared>(occ + j));
    }
    GREEDY_STAMP(4 + 3 * s);
    grid.sync();
    uint64_t theirs = 0, span = 0, their_occ = 0;
    if (threadIdx.x < blocks) {
      const unsigned long long* rec =
          records + kRec * (int64_t(s) * blocks + threadIdx.x);
      theirs = __ldcg(rec);
      span = __ldcg(rec + 1);
      if (kVariant) their_occ = __ldcg(rec + 2);
    }
    const uint64_t best = block_max_key(uint32_t(theirs >> 32),
                                        uint32_t(theirs), red);
    if (threadIdx.x == 0) red[0] = best;
    __syncthreads();
    if (threadIdx.x < blocks && theirs == red[0] && (!kVariant || theirs)) {
      step_u = int32_t(0xFFFFFFFFu - uint32_t(theirs));
      step_begin = int32_t(uint32_t(span));
      step_end = int32_t(span >> 32);
      if (kVariant) step_gain = int32_t(their_occ);
    }
    __syncthreads();
    GREEDY_STAMP(5 + 3 * s);
    if (kVariant && red[0] == 0) {
      // no feasible node: nothing changes from here on
      for (int64_t j = s + gtid; j < k; j += gsize) {
        seeds[j] = n;
        gains[j] = 0;
      }
      break;
    }
    const int32_t u = step_u;
    const int64_t begin = step_begin, end = step_end;
    if (gtid == 0) {
      seeds[s] = u;
      if (!kWeighted) gains[s] = kVariant ? step_gain : int32_t(red[0] >> 32);
    }
    if (kVariant && va.costs != nullptr)
      spent = __fadd_rn(spent, __ldg(va.costs + u));
    // the weighted gain is the walk's sum, so its walk runs at the last
    // step too
    if (s + 1 == k && !kWeighted) break;
    if (kWeighted && threadIdx.x == 0) step_wgain = 0.f;
    if (kWeighted) __syncthreads();
    for (int64_t i0 = begin + 32 * warp; i0 < end; i0 += 32 * kWarps) {
      const int64_t i = i0 + lane;
      int32_t e0 = 0, len = 0;
      float row_w = 0.f;
      if (i < end) {
        const int32_t r = __ldca(inv_rows + i);
        const int2 rs = __ldca(inv_span + i);
        const uint32_t bit = 1u << (r & 31);
        if (!(atomicOr(cov + (r >> 5), bit) & bit)) {
          e0 = rs.x;
          len = rs.y - rs.x;
          if (kWeighted && me == 0) row_w = __ldcg(va.roww + r);
        }
      }
      if (kWeighted && me == 0) {
        for (int off = 16; off > 0; off >>= 1)
          row_w += __shfl_xor_sync(kFullMask, row_w, off);
        if (lane == 0 && row_w != 0.f) atomicAdd(&step_wgain, row_w);
      }
      const int32_t incl = warp_inclusive_sum(len);
      const int32_t total = __shfl_sync(kFullMask, incl, 31);
      // lane j's elements are positions [incl - len, incl) of the warp's
      // run; the element at position p of lane j's part is from_j + p.
      // A lane takes kWalk positions a pass, so their loads go together.
      const int32_t from = e0 - (incl - len);
      for (int32_t p0 = 0; p0 < total; p0 += 32 * kWalk) {
        int32_t v[kWalk];
        float wq[kWalk];                     // kWeighted: the weights
#pragma unroll
        for (int q = 0; q < kWalk; ++q) {
          const int32_t p = p0 + 32 * q + lane;
          int j = 0;                         // lanes whose incl <= p
          for (int half = 16; half > 0; half >>= 1)
            if (__shfl_sync(kFullMask, incl, j + half - 1) <= p) j += half;
          const int32_t e = __shfl_sync(kFullMask, from, j) + p;
          v[q] = p < total ? __ldca(nodes + e) : -1;
          wq[q] = kWeighted && p < total ? __ldg(va.ew + e) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kWalk; ++q) {    // u's own count is set below
          if (v[q] >= lo && v[q] < lo + held && v[q] != u) {
            if (kWeighted)
              atomicAdd(reinterpret_cast<float*>(occ) + (v[q] - lo), -wq[q]);
            else
              atomicSub(occ + (v[q] - lo), 1);
          }
        }
      }
    }
    // every row that holds u is covered now; the variant blocks u, and
    // u's group's part of the slice once the pick spends its quota
    if (threadIdx.x == 0 && u >= lo && u < lo + held) {
      occ[u - lo] = 0;
      if (kVariant) blocked[(u - lo) >> 5] |= int32_t(1u << ((u - lo) & 31));
    }
    if (kVariant && threadIdx.x == 0) {
      const int64_t gu = uint32_t(u) / uint32_t(va.n_group);
      const int64_t g = gu - uint32_t(lo) / uint32_t(va.n_group);
      full_lo = full_hi = 0;
      if (g >= 0 && g < va.group_words && --gbud[g] == 0) {
        full_lo = int32_t(max(gu * va.n_group, lo) - lo);
        full_hi = int32_t(min((gu + 1) * va.n_group, lo + held) - lo);
      }
    }
    __syncthreads();
    if (kVariant && full_hi > full_lo) {
      // one thread a word of [full_lo, full_hi)
      const int32_t a = full_lo, b = full_hi;
      for (int32_t w = (a >> 5) + threadIdx.x; w <= (b - 1) >> 5;
           w += kThreads) {
        const int32_t from = max(a - 32 * w, 0), to = min(b - 32 * w, 32);
        const uint32_t bits = (to == 32 ? 0xFFFFFFFFu : (1u << to) - 1u) &
                              ~((1u << from) - 1u);
        blocked[w] = load_state<kShared>(blocked + w) | int32_t(bits);
      }
      __syncthreads();
    }
    if (kWeighted) {
      // the reference's max(occur - dec, 0), canonical; block 0's sum of
      // the new rows' weights is the step's gain
      for (int64_t j = threadIdx.x; j < held; j += kThreads)
        occ[j] = __float_as_int(
            canonical_occur(__int_as_float(load_state<kShared>(occ + j))));
      if (gtid == 0) gains[s] = __float_as_int(step_wgain);
      __syncthreads();
      if (s + 1 == k) break;
    }
    GREEDY_STAMP(6 + 3 * s);
  }
  if (kVariant && gtid == 0) *va.spent = spent;
}

#define GREEDY_FLAT_PARAMS                                                  \
  const int32_t *__restrict__ flat, const int32_t *__restrict__ ids,        \
      const uint8_t *__restrict__ valid, int64_t t, int32_t n,              \
      int64_t num_rows, int32_t k, int32_t slots, int32_t cov_words,        \
      unsigned long long *records, int2 *inv_span, int32_t *count,          \
      int32_t *cursor, int32_t *row_start, int32_t *nodes,                  \
      int32_t *inv_rows, int32_t *block_sum, int32_t *copies,               \
      int32_t *seeds, int32_t *gains, VariantArgs va
#define GREEDY_FLAT_ARGS                                                    \
  flat, ids, valid, t, n, num_rows, k, slots, cov_words, records, inv_span, \
      count, cursor, row_start, nodes, inv_rows, block_sum, copies, seeds,  \
      gains, va

// One block an SM: the bound lets ptxas use the registers that frees
// (without it the scratch form spills).
template <bool kShared, bool kVariant>
__global__ void __launch_bounds__(kThreads, 1)
greedy_flat_kernel(GREEDY_FLAT_PARAMS) {
  greedy_flat_body<kShared, kVariant, false>(GREEDY_FLAT_ARGS);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
greedy_flat_weighted_kernel(GREEDY_FLAT_PARAMS) {
  greedy_flat_body<kShared, true, true>(GREEDY_FLAT_ARGS);
}

#undef GREEDY_FLAT_PARAMS
#undef GREEDY_FLAT_ARGS

// The same grid with its barriers alone: the floor of greedy_flat_kernel.
__global__ void __launch_bounds__(kThreads) grid_barriers_kernel(int32_t count) {
  cg::grid_group grid = cg::this_grid();
  for (int32_t i = 0; i < count; ++i) grid.sync();
}

// greedy_flat_kernel's grid on card `device`, read once a card: one block
// on each SM, and the dynamic shared memory a block may take.
cudaError_t flat_grid_for(int device, int* blocks, int64_t* shared_bytes) {
  static int sms[kMaxDevices];
  static int64_t bytes[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    // the scratch form at 4 bytes a block of the grid: greedy_flat's base
    // table, more than greedy_sketch's global form takes
    cudaError_t err = one_block_an_sm(
        reinterpret_cast<const void*>(greedy_flat_kernel<true, false>),
        reinterpret_cast<const void*>(greedy_flat_kernel<false, false>),
        kThreads, 4, device, &sms[device], &bytes[device]);
    if (err == cudaSuccess) {
      // the variant's forms: the same limit, and one block an SM
      int variant_sms = 0;
      int64_t variant_bytes = 0;
      err = one_block_an_sm(
          reinterpret_cast<const void*>(greedy_flat_kernel<true, true>),
          reinterpret_cast<const void*>(greedy_flat_kernel<false, true>),
          kThreads, 4, device, &variant_sms, &variant_bytes);
      if (err == cudaSuccess && variant_bytes < bytes[device])
        bytes[device] = variant_bytes;
      if (err == cudaSuccess)
        err = one_block_an_sm(
            reinterpret_cast<const void*>(
                greedy_flat_weighted_kernel<true>),
            reinterpret_cast<const void*>(
                greedy_flat_weighted_kernel<false>),
            kThreads, 4, device, &variant_sms, &variant_bytes);
      if (err == cudaSuccess && variant_bytes < bytes[device])
        bytes[device] = variant_bytes;
    }
    if (err == cudaSuccess && sms[device] > kThreads)
      err = cudaErrorNotSupported;     // a thread polls each block's record
    if (err != cudaSuccess) {
      sms[device] = 0;
      return err;
    }
  }
  *blocks = sms[device];
  *shared_bytes = bytes[device];
  return cudaSuccess;
}

// Where greedy_flat's state lives on a grid of `blocks` whose dynamic
// shared memory holds `shared_bytes`, and the scratch it takes
// (kernels/greedy.py::flat_layout and flat_scratch_bytes say the same).
// n_group 0: greedy_flat; else greedy_flat_variant with its groups, whose
// blocks also keep their blocked bits (a word for 32 slice nodes) and the
// quotas of the groups their slice meets, and whose records are 24 bytes;
// weighted, its float Occur a node and weight a row too.
struct FlatLayout {
  int32_t slots, cov_words, blocked_words, group_words;
  bool shared;
  int64_t dynamic_bytes, scratch_bytes;
};

FlatLayout flat_layout(int32_t n, int64_t num_rows, int64_t t, int32_t k,
                       int blocks, int64_t shared_bytes, int32_t n_group = 0,
                       int32_t n_groups = 0, bool weighted = false) {
  FlatLayout lay;
  lay.slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  lay.cov_words = int32_t((num_rows + 31) / 32);
  lay.blocked_words = n_group ? (lay.slots + 31) / 32 : 0;
  lay.group_words =
      n_group ? int32_t(std::min<int64_t>(n_groups,
                                          (lay.slots - 1) / n_group + 2))
              : 0;
  const int64_t state = 4 * (2 * int64_t(lay.slots) + 1 + lay.cov_words +
                             lay.blocked_words + lay.group_words);
  lay.shared = 4 * int64_t(blocks) + state <= shared_bytes;
  lay.dynamic_bytes = 4 * int64_t(blocks) + (lay.shared ? state : 0);
  lay.scratch_bytes = 8 * (n_group ? 3 : 2) * int64_t(k) * blocks + 8 * t +
                      4 * (2 * int64_t(n) + num_rows + 1 + 2 * t + blocks) +
                      (weighted ? 4 * (int64_t(n) + num_rows) : 0) +
                      (lay.shared ? 0 : int64_t(blocks) * state);
  return lay;
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
// Given a candidate byte a node (cand), the picked set starts at the nodes
// outside the candidates, so the argmax stays inside them
// (core/coverage.py::select_seeds_sketch's cand).
//
// Design.  One block of kThreads on each SM, cooperative, as greedy_flat;
// block b owns the rows [b * slots, (b + 1) * slots) below n; k + 1 grid
// barriers at most, one after the prologue and one a step run.
// - popcount(cov) is the sum of the gains taken so far (cov starts at 0 and
//   each gain is the bits it adds), so each thread keeps it as a running
//   sum `base` and no step counts cov.
// - The rows stay on chip where they fit, read from memory once, in the
//   prologue (kernels/greedy.py::sketch_layout chooses the form).
//   kSketchRegisters (W <= 4): thread j holds the rows j, j + kThreads, ...
//   of its block's slice (at most kMaxRegRows: n up to 2 x 512 x the SMs,
//   the approximate cell's 575 rows a block; a larger slice takes the
//   shared form) and cov in registers, a uint4 each (words past W are 0).
//   One kernel for both counts (a kMaxRegRows = 8 kernel ran 13% slower
//   at the approximate cell, PERF.md §6).  kSketchShared: the slice is
//   copied into dynamic shared memory after cov.  kSketchGlobal: the slice is
//   read from global memory every step (__ldg; from L2 where the sketch
//   fits it), cov in shared memory or, when W words do not fit, in the
//   block's slice of the scratch.  In these two a group of `lanes` lanes
//   takes a row (16-byte loads when `vector`) and sums with shuffles.
// - The exchange, greedy_flat's: each block writes its record of step s
//   (its key, (delta + 1) << 32 | (0xFFFFFFFF - v), or 0 with no
//   candidate, and in the register form the winner's row) into the slot
//   of the step's parity; a grid barrier; every block reads all the
//   records, a thread each, and reduces the keys to u_s and its gain (ties
//   to the lowest id, across blocks as within); the register form takes
//   u_s's row from the same record, the others read sk[u_s] after the
//   reduce.  So a step is the sweep, one barrier and one round of
//   independent record reads, where the parent's was the sweep, an
//   atomicMax, the barrier, the key's read and the dependent read of
//   sk[u_s].  Every block reduces the same records, so all take the same
//   u_s and leave at the same step (a key whose high word is 0: no node
//   left).  A slot is written again two steps later, after a barrier that
//   every reader of it passed after its reads.  (Records as the barrier,
//   tagged words polled with relaxed loads and no grid barrier, measured
//   slower on the H100: PERF.md.)
// - A picked node's delta is 0 (its row is in cov), so without candidates
//   a row's picked bit is read only when the row would win at a delta of
//   0, before its thread holds a candidate; with them (a node outside the
//   candidates may have any delta) it is read for every row that would
//   win.  The bits: in registers in the register form (a bit a row of the
//   thread), else a bit a slice row in shared memory (in the block's part
//   of the scratch where it does not fit), set from cand in the prologue
//   and by the block after each step's reduce.
//
// What bounds it.  Each step reads the n sketch rows (1.21 MB at the
// approximate cell, 75,880 x 4 words), from registers or shared memory
// where they stay, and does an OR, a popcount and an add a word: a few
// microseconds of the whole card.  A step's chain sets its time: the
// sweep, the block's reduce, the grid barrier and the records' read; past
// the shared memory (W >= 128 at the stand-in) the sweep's pass over L2 or
// memory.  greedy_grid_barriers runs the same grid with the barriers
// alone, the floor.

enum SketchForm { kSketchRegisters = 0, kSketchShared = 1, kSketchGlobal = 2 };
// greedy_sketch_kernel's phases in its clock stamps: the prologue; a
// step's sweep of the rows, the block's argmax and its record, the grid
// barrier, the records' read and reduce to the step's key, and the seed's
// row ORed into cov.
enum SketchPhase { kSkProlog, kSkSweep, kSkArgmax, kSkBarrier, kSkKey,
                   kSkSeedRow, kSkPhases };
constexpr int kMaxRegRows = 2;              // rows a thread holds in registers
constexpr int kSketchRows = 4;              // rows a lane group loads at once

// One block's record of one step: the winner's row (register form), then
// its key.
struct alignas(32) SketchRecord {
  uint4 row;
  unsigned long long key;
  unsigned long long pad;
};

__device__ __forceinline__ uint32_t popc_or4(uint4 x, uint4 c) {
  return __popc(x.x | c.x) + __popc(x.y | c.y) + __popc(x.z | c.z) +
         __popc(x.w | c.w);
}

__device__ __forceinline__ uint4 or4(uint4 x, uint4 c) {
  return make_uint4(x.x | c.x, x.y | c.y, x.z | c.z, x.w | c.w);
}

// A row of cols <= 4 words as a uint4, the words past cols 0.
__device__ __forceinline__ uint4 load_row4(const uint32_t* row, int cols,
                                           bool vector) {
  if (vector) return __ldg(reinterpret_cast<const uint4*>(row));
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  x.x = __ldg(row);
  if (cols > 1) x.y = __ldg(row + 1);
  if (cols > 2) x.z = __ldg(row + 2);
  if (cols > 3) x.w = __ldg(row + 3);
  return x;
}

// The warp's largest 64-bit key (keys are unique or 0).
__device__ __forceinline__ uint64_t warp_max_u64(uint64_t key) {
  return warp_max_key(uint32_t(key >> 32), uint32_t(key));
}

// The words of a block's picked bits (a bit a slice row) and of its
// dynamic shared memory in a lane-group form: cov (stride words when in
// shared memory), the slice's rows (kSketchShared), then the picked bits
// when they fit (else they are the block's part of the scratch).
__host__ __device__ __forceinline__ int64_t picked_words(int64_t slots) {
  return (slots + 31) / 32;
}

template <int kForm, bool kSharedCov>
__global__ void __launch_bounds__(kThreads, 1)
greedy_sketch_kernel(const uint32_t* __restrict__ sk, int32_t n, int32_t cols,
                     int32_t lanes, bool vector, int32_t k, int32_t slots,
                     bool picked_shared, const uint8_t* __restrict__ cand,
                     SketchRecord* records, uint32_t* picked_copies,
                     uint32_t* cov_copies, int32_t* out) {
  extern __shared__ uint4 s_dyn4[];
  __shared__ uint64_t s_wkey[kWarps], s_xkey[kWarps];
  __shared__ uint4 s_wrow[kWarps], s_xrow[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int32_t blocks = gridDim.x, me = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t gtid = int64_t(me) * kThreads + tid;
  const int64_t gsize = int64_t(blocks) * kThreads;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  const int64_t stride = (int64_t(cols) + 3) & ~int64_t(3);
  constexpr bool kRegs = kForm == kSketchRegisters;
  // the lane-group forms: cov, then (kSketchShared) the slice's rows, then
  // the picked bits
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_dyn4);
  uint32_t* cov = kSharedCov ? s_words : cov_copies + int64_t(me) * stride;
  const uint4* cov4 = reinterpret_cast<const uint4*>(cov);
  const int64_t rows_at = kSharedCov ? stride : 0;
  const uint32_t* slice =
      kForm == kSketchShared ? s_words + rows_at : sk + lo * cols;
  uint32_t* picked =
      picked_shared
          ? s_words + rows_at + (kForm == kSketchShared ? slots * cols : 0)
          : picked_copies + int64_t(me) * picked_words(slots);
  const int sub = lane & (lanes - 1);           // lane within the row group
  const int rows_per_warp = 32 / lanes;
  // the lane-group forms: warp w's passes start at the slice rows (w + m *
  // kWarps) * span, and the group of lane l takes the rows l / lanes + i *
  // rows_per_warp past that, i < kSketchRows
  const int64_t span = int64_t(rows_per_warp) * kSketchRows;
  // a row's picked bit is read at a delta of 0 only, unless candidates
  // block rows of any delta
  const bool masked = cand != nullptr;
  PHASE_CLOCK_START(kSkPhases);

  // prologue: the rows on chip, cov and the picked bits; a grid barrier
  uint4 rows[kRegs ? kMaxRegRows : 1];
  uint4 c4 = make_uint4(0u, 0u, 0u, 0u);        // kSketchRegisters: cov
  uint32_t mine_picked = 0;                     // kSketchRegisters: bit i
  if (kRegs) {
#pragma unroll
    for (int i = 0; i < kMaxRegRows; ++i) {
      const int64_t j = tid + int64_t(i) * kThreads;
      rows[i] = j < held ? load_row4(sk + (lo + j) * cols, cols, vector)
                         : make_uint4(0u, 0u, 0u, 0u);
      if (masked && j < held && !__ldg(cand + lo + j))
        mine_picked |= 1u << i;
    }
  } else {
    for (int w = tid; w < cols; w += kThreads) cov[w] = 0;
    if (kForm == kSketchShared) {
      uint32_t* s_rows = s_words + rows_at;
      const uint32_t* src = sk + lo * cols;
      for (int64_t i = tid; i < held * cols; i += kThreads)
        s_rows[i] = __ldg(src + i);
    }
    for (int64_t i = tid; i < picked_words(slots); i += kThreads) {
      uint32_t bits = 0;
      if (masked)
        for (int b = 0; b < 32; ++b) {
          const int64_t j = 32 * i + b;
          if (j < held && !__ldg(cand + lo + j)) bits |= 1u << b;
        }
      picked[i] = bits;
    }
  }
  grid.sync();
  PHASE_CLOCK(kSkProlog);

  uint32_t base = 0;                           // popcount(cov)
  int32_t s = 0;
  for (; s < k; ++s) {
    // the sweep: each thread's first maximum of its rows' (delta + 1, ~v)
    // (its rows ascend, so a later row wins only with a larger score;
    // low == 0 marks no candidate) and, in the register form, its row.  A
    // picked row's delta is 0, so a row's picked bit is read only when it
    // would win at a delta of 0: before the thread has a candidate.
    uint32_t best = 0, low = 0;
    uint4 best_row = make_uint4(0u, 0u, 0u, 0u);
    if (kRegs) {
#pragma unroll
      for (int i = 0; i < kMaxRegRows; ++i) {
        const int64_t j = tid + int64_t(i) * kThreads;
        if (j < held) {
          const uint32_t d = popc_or4(rows[i], c4) - base;
          if ((low == 0 || d + 1 > best) &&
              ((d != 0 && !masked) || !((mine_picked >> i) & 1u))) {
            best = d + 1;
            low = 0xFFFFFFFFu - uint32_t(lo + j);
            best_row = rows[i];
          }
        }
      }
    } else {
      // every lane of a warp runs the same iterations, so the full-mask
      // shuffles see the whole warp; a column's loads of the group's
      // kSketchRows rows go out together (a row past the slice reads the
      // slice's last row)
      for (int64_t r0 = warp * span; r0 < held; r0 += kWarps * span) {
        const uint32_t* row[kSketchRows];
        uint32_t cnt[kSketchRows];
#pragma unroll
        for (int i = 0; i < kSketchRows; ++i) {
          const int64_t j = r0 + lane / lanes + i * rows_per_warp;
          row[i] = slice + min(j, held - 1) * cols;
          cnt[i] = 0;
        }
        if (vector) {
          for (int q = sub; q < cols / 4; q += lanes) {
            const uint4 y = cov4[q];
            uint4 x[kSketchRows];
#pragma unroll
            for (int i = 0; i < kSketchRows; ++i) {
              const uint4* row4 = reinterpret_cast<const uint4*>(row[i]);
              x[i] = kForm == kSketchShared ? row4[q] : __ldg(row4 + q);
            }
#pragma unroll
            for (int i = 0; i < kSketchRows; ++i) cnt[i] += popc_or4(x[i], y);
          }
        } else {
          for (int w = sub; w < cols; w += lanes) {
            const uint32_t y = cov[w];
            uint32_t x[kSketchRows];
#pragma unroll
            for (int i = 0; i < kSketchRows; ++i)
              x[i] = kForm == kSketchShared ? row[i][w] : __ldg(row[i] + w);
#pragma unroll
            for (int i = 0; i < kSketchRows; ++i) cnt[i] += __popc(x[i] | y);
          }
        }
#pragma unroll
        for (int i = 0; i < kSketchRows; ++i) {
          const int64_t j = r0 + lane / lanes + i * rows_per_warp;
          uint32_t c = cnt[i];
          for (int off = lanes >> 1; off > 0; off >>= 1)
            c += __shfl_down_sync(kFullMask, c, off, lanes);
          if (sub == 0 && j < held) {
            const uint32_t d = c - base;
            if ((low == 0 || d + 1 > best) &&
                ((d != 0 && !masked) ||
                 !((picked[j >> 5] >> (j & 31)) & 1u))) {
              best = d + 1;
              low = 0xFFFFFFFFu - uint32_t(lo + j);
            }
          }
        }
      }
    }
    PHASE_CLOCK(kSkSweep);

    // the block's first maximum, its record of step s, the barrier
    SketchRecord* rec = records + int64_t(s & 1) * blocks;
    {
      const uint64_t key = (uint64_t(best) << 32) | low;
      const uint64_t top = warp_max_u64(key);
      if (kRegs && key == top && top != 0) s_wrow[warp] = best_row;
      if (lane == 0) s_wkey[warp] = top;
      __syncthreads();
      if (warp == 0) {
        const uint64_t mine = lane < kWarps ? s_wkey[lane] : 0;
        const uint64_t block_top = warp_max_u64(mine);
        if (block_top != 0 ? mine == block_top : lane == 0) {
          if (kRegs) rec[me].row = s_wrow[lane];
          rec[me].key = block_top;
        }
      }
    }
    PHASE_CLOCK(kSkArgmax);
    grid.sync();
    PHASE_CLOCK(kSkBarrier);

    // every block's record of step s, a thread each
    uint64_t theirs = 0;
    uint4 their_row = make_uint4(0u, 0u, 0u, 0u);
    if (tid < blocks) {
      theirs = __ldcg(&rec[tid].key);
      if (kRegs) their_row = __ldcg(&rec[tid].row);
    }
    {
      const uint64_t top = warp_max_u64(theirs);
      if (kRegs && theirs == top && top != 0) s_xrow[warp] = their_row;
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
    PHASE_CLOCK(kSkKey);
    if ((key >> 32) == 0) break;               // no node left
    const uint32_t u = 0xFFFFFFFFu - uint32_t(key);
    const uint32_t gain = uint32_t(key >> 32) - 1;
    if (gtid == 0) {
      out[s] = int32_t(u);
      out[k + s] = int32_t(gain);
    }
    const int64_t ju = int64_t(u) - lo;
    base += gain;
    if (kRegs) {
      if (ju >= 0 && ju < held && ju % kThreads == tid)
        mine_picked |= 1u << (ju / kThreads);
      c4 = or4(c4, s_xrow[at]);
    } else {
      if (tid == 0 && ju >= 0 && ju < held)
        atomicOr(picked + (ju >> 5), 1u << (ju & 31));
      const uint32_t* row = sk + int64_t(u) * cols;
      for (int w = tid; w < cols; w += kThreads) cov[w] |= __ldg(row + w);
      __syncthreads();
    }
    PHASE_CLOCK(kSkSeedRow);
  }
  PHASE_CLOCK_END();
  if (gtid == 0) out[2 * k] = s;
  for (int64_t j = s + gtid; j < k; j += gsize) {
    out[j] = n;
    out[k + j] = 0;
  }
}

// The kernel of a form, with cov in shared memory or not.
template <int kForm, bool kSharedCov>
const void* sketch_kernel_at() {
  return reinterpret_cast<const void*>(
      greedy_sketch_kernel<kForm, kSharedCov>);
}

// greedy_sketch's grid on card `device`, read once a card: one block on
// each SM of every form, and the dynamic shared memory (in words) that a
// block may take, the limit raised for the forms that take it.
cudaError_t sketch_grid_for(int device, int* blocks, int64_t* shared_words) {
  static int sms[kMaxDevices];
  static int64_t bytes[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    cudaError_t err = one_block_an_sm(
        sketch_kernel_at<kSketchShared, true>(),
        sketch_kernel_at<kSketchGlobal, false>(), kThreads, 4, device,
        &sms[device], &bytes[device]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sketch_kernel_at<kSketchGlobal, true>(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(bytes[device]));
    if (err == cudaSuccess) {
      int resident = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, sketch_kernel_at<kSketchRegisters, false>(), kThreads,
          0);
      if (err == cudaSuccess && resident < 1)
        err = cudaErrorCooperativeLaunchTooLarge;
    }
    if (err == cudaSuccess && sms[device] > kThreads)
      err = cudaErrorNotSupported;     // a thread polls each block's record
    if (err != cudaSuccess) {
      sms[device] = 0;
      return err;
    }
  }
  *blocks = sms[device];
  *shared_words = bytes[device] / 4;
  return cudaSuccess;
}

// One launch of greedy_flat_kernel, plain (va zeroed) or the variant.
template <bool kVariant>
int launch_flat(const void* flat, const void* ids, const void* valid,
                int64_t t, int32_t n, int64_t num_rows, int32_t k,
                int32_t n_groups, VariantArgs va, void* scratch,
                int64_t scratch_bytes, void* out, int device, void* stream) {
  if (t < 0 || t > 0x7FFFFFFF || n < 1 || n == 0x7FFFFFFF || num_rows < 1 ||
      num_rows > 0x7FFFFFFF || k < 1)
    return int(cudaErrorInvalidValue);
  if (kVariant && (va.cand == nullptr || va.spent == nullptr ||
                   va.n_group < 1 || n_groups < 1 || va.group_quota < 0 ||
                   int64_t(va.n_group) * n_groups < n))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_bytes = 0;
  cudaError_t err = flat_grid_for(device, &blocks, &shared_bytes);
  if (err != cudaSuccess) return int(err);
  const bool weighted = kVariant && va.ew != nullptr;
  const FlatLayout lay =
      flat_layout(n, num_rows, t, k, blocks, shared_bytes,
                  kVariant ? va.n_group : 0, kVariant ? n_groups : 0,
                  weighted);
  if (scratch_bytes < lay.scratch_bytes) return int(cudaErrorInvalidValue);
  va.blocked_words = lay.blocked_words;
  va.group_words = lay.group_words;
  const int32_t* p_flat = static_cast<const int32_t*>(flat);
  const int32_t* p_ids = static_cast<const int32_t*>(ids);
  const uint8_t* p_valid = static_cast<const uint8_t*>(valid);
  uint8_t* at = static_cast<uint8_t*>(scratch);
  unsigned long long* records = reinterpret_cast<unsigned long long*>(at);
  int2* inv_span = reinterpret_cast<int2*>(
      records + (kVariant ? 3 : 2) * int64_t(k) * blocks);
  int32_t* count = reinterpret_cast<int32_t*>(inv_span + t);
  int32_t* cursor = count + n;
  int32_t* row_start = cursor + n;
  int32_t* nodes = row_start + num_rows + 1;
  int32_t* inv_rows = nodes + t;
  int32_t* block_sum = inv_rows + t;
  int32_t* copies = block_sum + blocks;
  if (weighted) {
    va.wocc = reinterpret_cast<float*>(copies);
    va.roww = va.wocc + n;
    copies = reinterpret_cast<int32_t*>(va.roww + num_rows);
  }
  int32_t* seeds = static_cast<int32_t*>(out);
  int32_t* gains = seeds + k;
  int32_t slots = lay.slots, cov_words = lay.cov_words;
  void* args[] = {&p_flat, &p_ids, &p_valid, &t, &n, &num_rows, &k,
                  &slots, &cov_words, &records, &inv_span, &count, &cursor,
                  &row_start, &nodes, &inv_rows, &block_sum, &copies, &seeds,
                  &gains, &va};
  const void* kernel =
      weighted
          ? (lay.shared ? reinterpret_cast<const void*>(
                              greedy_flat_weighted_kernel<true>)
                        : reinterpret_cast<const void*>(
                              greedy_flat_weighted_kernel<false>))
      : lay.shared
          ? reinterpret_cast<const void*>(greedy_flat_kernel<true, kVariant>)
          : reinterpret_cast<const void*>(greedy_flat_kernel<false, kVariant>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                    size_t(lay.dynamic_bytes),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}


// greedy_stacked: R selections on one pool in one cooperative launch (the
// header's note says what it computes and how).  Its rows' operands: R x n
// candidate bytes and costs, and R budgets, step counts, group quotas,
// plain flags and budget flags; the batch's group geometry; a block's
// blocked words and group quotas for each row.
struct StackedArgs {
  const uint8_t* cand;
  const float* costs;
  const float* budget;
  const int32_t* ks;
  const int32_t* quota;
  const uint8_t* plain;
  const uint8_t* use_costs;
  int32_t rows, k_max, n_group, blocked_words, group_words;
};

constexpr int kStackChunk = 32;   // rows a pass of a block's argmaxes

// The rows of u_r's list entries [i0, i0 + 32) (below end) that row r's
// Covered does not hold yet: set each one's bit, and take one off row r's
// Occur at every counted element of it (u_r's own count reaches 0).  A
// warp's lanes take an entry each, then walk the new rows' elements as
// greedy_flat's cover does, kWalk x 32 at a time.
__device__ __forceinline__ void cover_chunk(
    int64_t i0, int64_t end, const int32_t* inv_rows, const int2* inv_span,
    const int32_t* nodes, uint32_t* cov_r, int32_t* occ_r) {
  const int lane = threadIdx.x & 31;
  const int64_t i = i0 + lane;
  int32_t e0 = 0, len = 0;
  if (i < end) {
    const int32_t r = __ldca(inv_rows + i);
    const int2 rs = __ldca(inv_span + i);
    const uint32_t bit = 1u << (r & 31);
    if (!(atomicOr(cov_r + (r >> 5), bit) & bit)) {
      e0 = rs.x;
      len = rs.y - rs.x;
    }
  }
  const int32_t incl = warp_inclusive_sum(len);
  const int32_t total = __shfl_sync(kFullMask, incl, 31);
  const int32_t from = e0 - (incl - len);
  for (int32_t p0 = 0; p0 < total; p0 += 32 * kWalk) {
    int32_t v[kWalk];
#pragma unroll
    for (int q = 0; q < kWalk; ++q) {
      const int32_t p = p0 + 32 * q + lane;
      int j = 0;                           // lanes whose incl <= p
      for (int half = 16; half > 0; half >>= 1)
        if (__shfl_sync(kFullMask, incl, j + half - 1) <= p) j += half;
      const int32_t e = __shfl_sync(kFullMask, from, j) + p;
      v[q] = p < total ? __ldca(nodes + e) : -1;
    }
#pragma unroll
    for (int q = 0; q < kWalk; ++q)
      if (v[q] >= 0) atomicSub(occ_r + v[q], 1);
  }
}

// Scratch (global memory): the step records (R x blocks x 2 uint64: a
// block's key of row r and its node's Occur), inv_span t int2, count n,
// cursor n, lstart n (a node's list start inside its block), row_start
// num_rows + 1, nodes t, inv_rows t and block_sum `blocks` int32, then
// the rows' state: Occur R x n int32, Covered R x cov_words uint32, and
// each (row, block)'s blocked words and group quotas.  Dynamic shared
// memory: the blocks' bases, then a row's step node, gain, list span,
// first walk chunk (R + 1), spent and done flag.
__global__ void __launch_bounds__(kThreads, 1) greedy_stacked_kernel(
    const int32_t* __restrict__ flat, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ valid, int64_t t, int32_t n,
    int64_t num_rows, int32_t slots, int32_t cov_words, StackedArgs sa,
    unsigned long long* records, int2* inv_span, int32_t* count,
    int32_t* cursor, int32_t* lstart, int32_t* row_start, int32_t* nodes,
    int32_t* inv_rows, int32_t* block_sum, int32_t* occur,
    uint32_t* covered, int32_t* blocked_all,
    int32_t* seeds, int32_t* gains, float* spent_out) {
  extern __shared__ int32_t smem[];
  __shared__ uint64_t red[kStackChunk][kWarps];
  __shared__ int32_t part[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int32_t blocks = gridDim.x, me = blockIdx.x, R = sa.rows;
  const int64_t k_max = sa.k_max;
  int32_t* base = smem;
  int32_t* s_u = base + blocks;
  int32_t* s_gain = s_u + R;
  int32_t* s_begin = s_gain + R;
  int32_t* s_end = s_begin + R;
  int32_t* s_first = s_end + R;
  float* s_spent = reinterpret_cast<float*>(s_first + R + 1);
  int32_t* s_done = reinterpret_cast<int32_t*>(s_spent + R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gtid = int64_t(me) * kThreads + threadIdx.x;
  const int64_t gsize = int64_t(blocks) * kThreads;
  const int64_t lo = min(int64_t(me) * slots, int64_t(n));
  const int64_t held = min(lo + slots, int64_t(n)) - lo;
  const int64_t state_words = int64_t(sa.blocked_words) + sa.group_words;
  // row r takes step s while s < ks[r] and, a variant row, no step before
  // found no feasible node (the same in every block)
  auto live = [&](int32_t r, int32_t s) {
    return s < __ldg(sa.ks + r) && !s_done[r];
  };
  auto blocked_of = [&](int32_t r) {
    return blocked_all + (int64_t(r) * blocks + me) * state_words;
  };

  // (A): as greedy_flat's, and the outputs' sentinels, the rows' Covered
  for (int64_t v = gtid; v < n; v += gsize) count[v] = 0;
  for (int64_t r = gtid; r <= num_rows; r += gsize)
    row_start[r] = first_row_at(ids, t, r);
  for (int64_t i = gtid; i < int64_t(R) * k_max; i += gsize) {
    seeds[i] = n;
    gains[i] = 0;
  }
  for (int64_t w = gtid; w < int64_t(R) * cov_words; w += gsize)
    covered[w] = 0;
  for (int32_t r = threadIdx.x; r < R; r += kThreads) {
    s_spent[r] = 0.f;
    s_done[r] = 0;
  }
  grid.sync();

  // (B)
  for (int64_t e = gtid; e < t; e += gsize) {
    const int32_t v = counted_node(flat, valid, e, n);
    nodes[e] = v;
    if (v >= 0) {
      const unsigned peers = __match_any_sync(__activemask(), v);
      if (lane == __ffs(peers) - 1) atomicAdd(count + v, __popc(peers));
    }
  }
  grid.sync();

  // (C): the slice's list starts, as greedy_flat's, and each row's Occur,
  // blocked bits (~cand, all at quota 0) and group quotas of the slice
  {
    const int64_t per = (held + kThreads - 1) / kThreads;
    const int64_t ja = min(threadIdx.x * per, held);
    const int64_t jb = min(ja + per, held);
    int32_t sum = 0;
    for (int64_t j = ja; j < jb; ++j) sum += __ldcg(count + lo + j);
    const int2 scan = block_exclusive_sum(sum, part);
    int32_t run = scan.x;
    for (int64_t j = ja; j < jb; ++j) {
      cursor[lo + j] = run;
      lstart[lo + j] = run;
      run += __ldcg(count + lo + j);
    }
    if (threadIdx.x == 0) block_sum[me] = scan.y;
    for (int32_t r = 0; r < R; ++r) {
      int32_t* occ_r = occur + int64_t(r) * n + lo;
      for (int64_t j = threadIdx.x; j < held; j += kThreads)
        occ_r[j] = __ldcg(count + lo + j);
      if (__ldg(sa.plain + r)) continue;
      const uint8_t* cand_r = sa.cand + int64_t(r) * n + lo;
      const int32_t quota = __ldg(sa.quota + r);
      int32_t* blocked = blocked_of(r);
      for (int32_t w = threadIdx.x; w < sa.blocked_words; w += kThreads) {
        uint32_t bits = 0;
        for (int b = 0; b < 32; ++b) {
          const int64_t j = 32 * int64_t(w) + b;
          if (j >= held || quota <= 0 || !__ldg(cand_r + j)) bits |= 1u << b;
        }
        blocked[w] = int32_t(bits);
      }
      for (int32_t g = threadIdx.x; g < sa.group_words; g += kThreads)
        blocked[sa.blocked_words + g] = quota;
    }
  }
  grid.sync();

  // (D): as greedy_flat's
  if (warp == 0) {
    int32_t carry = 0;
    for (int32_t j0 = 0; j0 < blocks; j0 += 32) {
      const int32_t j = j0 + lane;
      const int32_t x = j < blocks ? __ldcg(block_sum + j) : 0;
      const int32_t incl = warp_inclusive_sum(x);
      if (j < blocks) base[j] = carry + incl - x;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
  }
  __syncthreads();
  for (int64_t e = gtid; e < t; e += gsize) {
    const int32_t v = __ldcg(nodes + e);
    if (v >= 0) {
      const unsigned peers = __match_any_sync(__activemask(), v);
      const int leader = __ffs(peers) - 1;
      int32_t first = 0;
      if (lane == leader) first = atomicAdd(cursor + v, __popc(peers));
      const int32_t pos = base[v / slots] +
                          __shfl_sync(peers, first, leader) +
                          __popc(peers & ((1u << lane) - 1));
      const int32_t r = __ldg(ids + e);
      inv_rows[pos] = r;
      inv_span[pos] = make_int2(__ldcg(row_start + r),
                                __ldcg(row_start + r + 1));
    }
  }

  for (int32_t s = 0;; ++s) {
    bool mine_live = false;
    for (int32_t r = threadIdx.x; r < R; r += kThreads)
      mine_live |= live(r, s);
    if (!__syncthreads_or(mine_live)) break;
    if (s > 0) grid.sync();                  // step s - 1's covers are done

    // each live row's key in this block's slice (greedy_flat's, or
    // greedy_flat_variant's without weights) and its node's Occur
    for (int32_t r0 = 0; r0 < R; r0 += kStackChunk) {
      const int32_t rn = min(kStackChunk, R - r0);
      for (int32_t i = 0; i < rn; ++i) {
        const int32_t r = r0 + i;
        if (!live(r, s)) continue;
        const int32_t* occ_r = occur + int64_t(r) * n + lo;
        uint32_t best, low;
        if (__ldg(sa.plain + r))
          fold_slice<false>(occ_r, lo, held, best, low);
        else
          fold_slice_variant<false, false>(
              occ_r, blocked_of(r), lo, held,
              __ldg(sa.use_costs + r) ? sa.costs + int64_t(r) * n : nullptr,
              __fsub_rn(__ldg(sa.budget + r), s_spent[r]), best, low);
        const uint64_t key = warp_max_key(best, low);
        if (lane == 0) red[i][warp] = key;
      }
      __syncthreads();
      for (int32_t i = warp; i < rn; i += kWarps) {
        const int32_t r = r0 + i;
        if (!live(r, s)) continue;
        const uint64_t w = lane < kWarps ? red[i][lane] : 0;
        const uint64_t key = warp_max_key(uint32_t(w >> 32), uint32_t(w));
        if (lane == 0) {
          uint32_t o = 0;
          if (key)
            o = uint32_t(__ldcg(occur + int64_t(r) * n +
                                (0xFFFFFFFFu - uint32_t(key))));
          unsigned long long* rec = records + 2 * (int64_t(r) * blocks + me);
          rec[0] = key;
          rec[1] = o;
        }
      }
      __syncthreads();
    }
    grid.sync();

    // every block reduces every live row's records: u_r and its gain
    for (int32_t r = warp; r < R; r += kWarps) {
      if (!live(r, s)) continue;
      uint64_t best = 0, occ_best = 0;
      for (int32_t b = lane; b < blocks; b += 32) {
        const unsigned long long* rec = records + 2 * (int64_t(r) * blocks + b);
        const uint64_t key = __ldcg(rec);
        if (key > best) {
          best = key;
          occ_best = __ldcg(rec + 1);
        }
      }
      const uint64_t key = warp_max_key(uint32_t(best >> 32), uint32_t(best));
      const unsigned who = __ballot_sync(kFullMask, key != 0 && best == key);
      const int32_t gain = int32_t(
          __shfl_sync(kFullMask, uint32_t(occ_best), who ? __ffs(who) - 1 : 0));
      if (lane == 0) {
        s_u[r] = key ? int32_t(0xFFFFFFFFu - uint32_t(key)) : n;
        s_gain[r] = key ? gain : 0;
      }
    }
    __syncthreads();

    // a thread a row: the outputs (block 0), the variant's spent, blocked
    // bits and group quotas (each block its slice's), and the span of
    // list entries the cover walks (none at the row's last step)
    for (int32_t r = threadIdx.x; r < R; r += kThreads) {
      int32_t chunks = 0;
      if (live(r, s)) {
        const int32_t u = s_u[r];
        if (u == n) {
          s_done[r] = 1;                     // a variant row with no node
        } else {
          if (me == 0) {
            seeds[r * k_max + s] = u;
            gains[r * k_max + s] = s_gain[r];
          }
          if (!__ldg(sa.plain + r)) {
            if (__ldg(sa.use_costs + r))
              s_spent[r] = __fadd_rn(s_spent[r],
                                     __ldg(sa.costs + int64_t(r) * n + u));
            int32_t* blocked = blocked_of(r);
            int32_t* gbud = blocked + sa.blocked_words;
            if (u >= lo && u < lo + held)
              blocked[(u - lo) >> 5] =
                  __ldcg(blocked + ((u - lo) >> 5)) |
                  int32_t(1u << ((u - lo) & 31));
            const int64_t gu = uint32_t(u) / uint32_t(sa.n_group);
            const int64_t g = gu - uint32_t(lo) / uint32_t(sa.n_group);
            if (g >= 0 && g < sa.group_words) {
              const int32_t left = __ldcg(gbud + g) - 1;
              gbud[g] = left;
              const int64_t a = max(gu * sa.n_group, lo) - lo;
              const int64_t b = min((gu + 1) * sa.n_group, lo + held) - lo;
              for (int64_t w = a >> 5; left == 0 && b > a && w <= (b - 1) >> 5;
                   ++w) {
                const int64_t from = max(a - 32 * w, int64_t(0));
                const int64_t to = min(b - 32 * w, int64_t(32));
                const uint32_t bits =
                    (to == 32 ? 0xFFFFFFFFu : (1u << to) - 1u) &
                    ~((1u << from) - 1u);
                blocked[w] = __ldcg(blocked + w) | int32_t(bits);
              }
            }
          }
          if (s + 1 < __ldg(sa.ks + r)) {
            s_begin[r] = base[u / slots] + __ldcg(lstart + u);
            s_end[r] = s_begin[r] + __ldcg(count + u);
            chunks = (s_end[r] - s_begin[r] + 31) / 32;
          }
        }
      }
      s_first[r] = chunks;
    }
    __syncthreads();
    {
      int32_t carry = 0;
      for (int32_t r0 = 0; r0 < R; r0 += kThreads) {
        const int32_t r = r0 + threadIdx.x;
        const int2 scan = block_exclusive_sum(r < R ? s_first[r] : 0, part);
        if (r < R) s_first[r] = carry + scan.x;
        carry += scan.y;
        __syncthreads();
      }
      if (threadIdx.x == 0) s_first[R] = carry;
      __syncthreads();
    }

    // the covers: 32 list entries a warp, over the grid's warps, each
    // chunk inside one row's span
    const int32_t total = s_first[R];
    for (int32_t c = me * kWarps + warp; c < total; c += blocks * kWarps) {
      int32_t a = 0, b = R;                  // the row whose chunks hold c
      while (b - a > 1) {
        const int32_t mid = (a + b) >> 1;
        if (s_first[mid] <= c) a = mid;
        else b = mid;
      }
      cover_chunk(s_begin[a] + int64_t(c - s_first[a]) * 32, s_end[a],
                  inv_rows, inv_span, nodes, covered + int64_t(a) * cov_words,
                  occur + int64_t(a) * n);
    }
  }
  if (me == 0)
    for (int32_t r = threadIdx.x; r < R; r += kThreads)
      spent_out[r] = s_spent[r];
}

// greedy_stacked_kernel's grid on card `device`, read once a card: one
// block on each SM, and the dynamic shared memory a block may take.
cudaError_t stacked_grid_for(int device, int* blocks, int64_t* shared_bytes) {
  static int sms[kMaxDevices];
  static int64_t bytes[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    const void* kernel = reinterpret_cast<const void*>(greedy_stacked_kernel);
    cudaError_t err = one_block_an_sm(kernel, kernel, kThreads, 4, device,
                                      &sms[device], &bytes[device]);
    if (err != cudaSuccess) {
      sms[device] = 0;
      return err;
    }
  }
  *blocks = sms[device];
  *shared_bytes = bytes[device];
  return cudaSuccess;
}

// greedy_stacked's layout on a grid of `blocks` (kernels/greedy.py::
// stacked_layout and stacked_scratch_bytes say the same).
struct StackedLayout {
  int32_t slots, cov_words, blocked_words, group_words;
  int64_t dynamic_bytes, scratch_bytes;
};

StackedLayout stacked_layout(int32_t n, int64_t num_rows, int64_t t,
                             int32_t rows, int blocks, int32_t n_group,
                             int32_t n_groups) {
  StackedLayout lay;
  lay.slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  lay.cov_words = int32_t((num_rows + 31) / 32);
  lay.blocked_words = (lay.slots + 31) / 32;
  lay.group_words = int32_t(
      std::min<int64_t>(n_groups, (lay.slots - 1) / n_group + 2));
  lay.dynamic_bytes = 4 * (int64_t(blocks) + 7 * int64_t(rows) + 1);
  lay.scratch_bytes =
      16 * int64_t(rows) * blocks + 8 * t +
      4 * (3 * int64_t(n) + num_rows + 1 + 2 * t + blocks) +
      4 * int64_t(rows) * (int64_t(n) + lay.cov_words) +
      4 * int64_t(rows) * blocks * (lay.blocked_words + lay.group_words);
  return lay;
}

// One launch of greedy_stacked_kernel (see the C entry point).
int launch_stacked(const void* flat, const void* ids, const void* valid,
                   int64_t t, int32_t n, int64_t num_rows, StackedArgs sa,
                   int32_t n_groups, void* scratch, int64_t scratch_bytes,
                   void* out, void* spent, int device, void* stream) {
  if (t < 0 || t > 0x7FFFFFFF || n < 1 || n == 0x7FFFFFFF || num_rows < 1 ||
      num_rows > 0x7FFFFFFF || sa.rows < 1 || sa.k_max < 1 ||
      sa.n_group < 1 || n_groups < 1 ||
      int64_t(sa.n_group) * n_groups < n || int64_t(sa.rows) * n >= (1LL << 40))
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_bytes = 0;
  cudaError_t err = stacked_grid_for(device, &blocks, &shared_bytes);
  if (err != cudaSuccess) return int(err);
  const StackedLayout lay = stacked_layout(n, num_rows, t, sa.rows, blocks,
                                           sa.n_group, n_groups);
  if (scratch_bytes < lay.scratch_bytes || lay.dynamic_bytes > shared_bytes)
    return int(cudaErrorInvalidValue);
  sa.blocked_words = lay.blocked_words;
  sa.group_words = lay.group_words;
  const int32_t* p_flat = static_cast<const int32_t*>(flat);
  const int32_t* p_ids = static_cast<const int32_t*>(ids);
  const uint8_t* p_valid = static_cast<const uint8_t*>(valid);
  unsigned long long* records = static_cast<unsigned long long*>(scratch);
  int2* inv_span =
      reinterpret_cast<int2*>(records + 2 * int64_t(sa.rows) * blocks);
  int32_t* count = reinterpret_cast<int32_t*>(inv_span + t);
  int32_t* cursor = count + n;
  int32_t* lstart = cursor + n;
  int32_t* row_start = lstart + n;
  int32_t* nodes = row_start + num_rows + 1;
  int32_t* inv_rows = nodes + t;
  int32_t* block_sum = inv_rows + t;
  int32_t* occur = block_sum + blocks;
  uint32_t* covered =
      reinterpret_cast<uint32_t*>(occur + int64_t(sa.rows) * n);
  int32_t* blocked_all = reinterpret_cast<int32_t*>(
      covered + int64_t(sa.rows) * lay.cov_words);
  int32_t* seeds = static_cast<int32_t*>(out);
  int32_t* gains = seeds + int64_t(sa.rows) * sa.k_max;
  float* spent_out = static_cast<float*>(spent);
  int32_t slots = lay.slots, cov_words = lay.cov_words;
  void* args[] = {&p_flat, &p_ids, &p_valid, &t, &n, &num_rows, &slots,
                  &cov_words, &sa, &records, &inv_span, &count, &cursor,
                  &lstart, &row_start, &nodes, &inv_rows, &block_sum, &occur,
                  &covered, &blocked_all, &seeds, &gains, &spent_out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(greedy_stacked_kernel), dim3(blocks),
      dim3(kThreads), args, size_t(lay.dynamic_bytes),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  flat, ids: t int32 (ids non-decreasing,
// below num_rows); valid: t bytes (0 or 1); 0 <= t < 2^31, 1 <= n < 2^31 -
// 1, 1 <= num_rows < 2^31, k >= 1.  scratch: scratch_bytes bytes, at least
// greedy_flat's layout takes (kernels/greedy.py::flat_scratch_bytes; the
// kernel initialises what it reads); out: 2 * k int32, seeds then gains.
// Launches on `stream` of card `device`; returns the cudaError_t of the
// launch.
extern "C" int greedy_flat(const void* flat, const void* ids,
                           const void* valid, int64_t t, int32_t n,
                           int64_t num_rows, int32_t k, void* scratch,
                           int64_t scratch_bytes, void* out, int device,
                           void* stream) {
  return launch_flat<false>(flat, ids, valid, t, n, num_rows, k, 0,
                            VariantArgs{}, scratch, scratch_bytes, out, device,
                            stream);
}

// greedy_flat_variant: greedy_flat's pool, k and out, and cand (n bytes, 0
// or 1), costs (n float32, positive; null: no budget), budget, the groups
// (n_group ids each, n_group * n_groups >= n, group_quota seeds each);
// ew: null, or the t elements' float32 weights (the weighted form, whose
// gains in out are float32); scratch: kernels/greedy.py::
// flat_scratch_bytes with the groups (and the weighted form's); spent: one
// float32.  The steps with no feasible node get seed n and gain 0.
extern "C" int greedy_flat_variant(const void* flat, const void* ids,
                                   const void* valid, int64_t t, int32_t n,
                                   int64_t num_rows, int32_t k,
                                   const void* cand, const void* costs,
                                   float budget, int32_t n_group,
                                   int32_t n_groups, int32_t group_quota,
                                   const void* ew, void* scratch,
                                   int64_t scratch_bytes, void* out,
                                   void* spent, int device, void* stream) {
  VariantArgs va{};
  va.cand = static_cast<const uint8_t*>(cand);
  va.costs = static_cast<const float*>(costs);
  va.ew = static_cast<const float*>(ew);
  va.budget = budget;
  va.n_group = n_group;
  va.group_quota = group_quota;
  va.spent = static_cast<float*>(spent);
  return launch_flat<true>(flat, ids, valid, t, n, num_rows, k, n_groups, va,
                           scratch, scratch_bytes, out, device, stream);
}

// greedy_flat's grid on card `device`: its blocks (one on each SM) and the
// dynamic shared memory a block may take, in bytes.
extern "C" int greedy_flat_grid(int device, int* blocks,
                                int64_t* shared_bytes) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(flat_grid_for(device, blocks, shared_bytes));
}

// greedy_flat's grid running `count` grid barriers and nothing else.
extern "C" int greedy_grid_barriers(int32_t count, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_bytes = 0;
  cudaError_t err = flat_grid_for(device, &blocks, &shared_bytes);
  if (err != cudaSuccess) return int(err);
  void* args[] = {&count};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_barriers_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// greedy_sketch's grid on card `device`: its blocks, and the dynamic shared
// memory in words that a block may take (kernels/greedy.py::sketch_layout
// chooses the form from them).
extern "C" int greedy_sketch_grid(int device, int* blocks,
                                  int64_t* shared_words) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(sketch_grid_for(device, blocks, shared_words));
}

// Plain C interface for ctypes.  words: the sketch, rows of `cols` uint32
// (rows v < n are read; 1 <= n < 2^31 - 1, 1 <= cols < 2^26); lanes: a
// power of two in [1, 32]; vector: 16-byte loads (cols % 4 == 0, words
// 16-byte aligned); k >= 1.  form and rows: kernels/greedy.py::
// sketch_layout's (form 0, registers: cols <= 4, lanes 1 and rows, a power
// of two, at least the slice's rows over kThreads and at most kMaxRegRows;
// form 1, shared: cov, the slice's rows and its picked bits fit the shared
// memory; form 2, global).  scratch: the step records (2 x blocks x 32
// bytes), each block's picked bits (blocks x ceil(slots / 32) uint32) and,
// in the global form when cov does not fit the shared memory, a copy of cov
// for each block (blocks x round_up(cols, 4) uint32 from the next 16-byte
// boundary); the kernel initialises what it reads.  cand: null, or n
// bytes (0 or 1), the candidates.  out: 2k + 1 int32, seeds, gains, then
// the steps taken.  Launches on `stream` of card `device`; returns the
// cudaError_t of the launch.
extern "C" int greedy_sketch(const void* words, int32_t n, int32_t cols,
                             int lanes, int vector, int form, int rows,
                             int32_t k, const void* cand, void* scratch,
                             void* out, int device, void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || cols < 1 || cols >= (1 << 26) || k < 1 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (vector && (cols % 4 != 0 ||
                  (reinterpret_cast<uintptr_t>(words) & 15u) != 0)) ||
      form < kSketchRegisters || form > kSketchGlobal)
    return int(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  int blocks = 0;
  int64_t shared_words = 0;
  cudaError_t err = sketch_grid_for(device, &blocks, &shared_words);
  if (err != cudaSuccess) return int(err);
  int32_t slots = int32_t((int64_t(n) + blocks - 1) / blocks);
  const int64_t stride = (int64_t(cols) + 3) & ~int64_t(3);
  const int64_t pwords = picked_words(slots);
  const bool shared_cov = stride <= shared_words;
  int64_t dynamic_words = 0;
  bool picked_shared = false;
  const void* kernel = nullptr;
  if (form == kSketchRegisters) {
    if (cols > 4 || lanes != 1 || rows < 1 || rows > kMaxRegRows ||
        (rows & (rows - 1)) != 0 || int64_t(rows) * kThreads < slots)
      return int(cudaErrorInvalidValue);
    kernel = sketch_kernel_at<kSketchRegisters, false>();
  } else if (form == kSketchShared) {
    dynamic_words = stride + int64_t(slots) * cols + pwords;
    if (dynamic_words > shared_words) return int(cudaErrorInvalidValue);
    picked_shared = true;
    kernel = sketch_kernel_at<kSketchShared, true>();
  } else {
    dynamic_words = shared_cov ? stride : 0;
    picked_shared = dynamic_words + pwords <= shared_words;
    if (picked_shared) dynamic_words += pwords;
    kernel = shared_cov ? sketch_kernel_at<kSketchGlobal, true>()
                        : sketch_kernel_at<kSketchGlobal, false>();
  }
  const uint32_t* p_words = static_cast<const uint32_t*>(words);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  SketchRecord* records = reinterpret_cast<SketchRecord*>(base);
  uint32_t* picked_copies =
      reinterpret_cast<uint32_t*>(base + 64 * int64_t(blocks));
  const int64_t copies_at =
      (64 * int64_t(blocks) + 4 * int64_t(blocks) * pwords + 15) &
      ~int64_t(15);
  uint32_t* cov_copies = reinterpret_cast<uint32_t*>(base + copies_at);
  int32_t* p_out = static_cast<int32_t*>(out);
  bool vec = vector != 0;
  const uint8_t* p_cand = static_cast<const uint8_t*>(cand);
  void* args[] = {&p_words, &n, &cols, &lanes, &vec, &k, &slots,
                  &picked_shared, &p_cand, &records, &picked_copies,
                  &cov_copies, &p_out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, size_t(dynamic_words) * 4,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// greedy_stacked: R = rows selections on greedy_flat's pool (its flat, ids,
// valid, t, n and num_rows) in one launch.  cand: rows x n bytes (0 or 1);
// costs: rows x n float32; budget: rows float32; ks: rows int32, each
// row's steps (0 <= ks <= k_max; a row past its steps emits the sentinel
// n, gain 0); quota: rows int32, a group's seeds; plain, use_costs: rows
// bytes (0 or 1).  A plain row is greedy_flat's scan, a variant row
// greedy_flat_variant's (the candidates, the costs and budget when
// use_costs, the groups of n_group ids, n_group * n_groups >= n, and the
// row's quota).  scratch: kernels/greedy.py::stacked_scratch_bytes (the
// kernel initialises what it reads); out: 2 x rows x k_max int32, seeds
// then gains, row-major; spent: rows float32.  Launches on `stream` of
// card `device`; returns the cudaError_t of the launch.
extern "C" int greedy_stacked(const void* flat, const void* ids,
                              const void* valid, int64_t t, int32_t n,
                              int64_t num_rows, int32_t rows, int32_t k_max,
                              const void* cand, const void* costs,
                              const void* budget, const void* ks,
                              const void* quota, const void* plain,
                              const void* use_costs, int32_t n_group,
                              int32_t n_groups, void* scratch,
                              int64_t scratch_bytes, void* out, void* spent,
                              int device, void* stream) {
  StackedArgs sa{};
  sa.cand = static_cast<const uint8_t*>(cand);
  sa.costs = static_cast<const float*>(costs);
  sa.budget = static_cast<const float*>(budget);
  sa.ks = static_cast<const int32_t*>(ks);
  sa.quota = static_cast<const int32_t*>(quota);
  sa.plain = static_cast<const uint8_t*>(plain);
  sa.use_costs = static_cast<const uint8_t*>(use_costs);
  sa.rows = rows;
  sa.k_max = k_max;
  sa.n_group = n_group;
  if (!sa.cand || !sa.costs || !sa.budget || !sa.ks || !sa.quota ||
      !sa.plain || !sa.use_costs || !spent)
    return int(cudaErrorInvalidValue);
  return launch_stacked(flat, ids, valid, t, n, num_rows, sa, n_groups,
                        scratch, scratch_bytes, out, spent, device, stream);
}

// greedy_stacked's grid on card `device`: its blocks (one on each SM) and
// the dynamic shared memory a block may take, in bytes.
extern "C" int greedy_stacked_grid(int device, int* blocks,
                                   int64_t* shared_bytes) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return int(guard.err);
  return int(stacked_grid_for(device, blocks, shared_bytes));
}
