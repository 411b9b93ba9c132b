// SM clock stamps of a cooperative kernel's phases, for the stamped copies
// of the port's selection kernels (examples/sketch_stamps.cu and
// examples/celf_stamps.cu define them before they include greedy.cu or
// celf.cu, whose own definitions are empty).
//
// PHASE_CLOCK_START(phases) starts a block's clock; PHASE_CLOCK(p) adds the
// clocks since the last stamp to phase p; PHASE_CLOCK_END() makes the first
// thread of each of the first kClockBlocks blocks write its sums and its
// total to phase_clocks[block].  Only thread 0's clock is kept: it takes
// part in every phase.  The sums use 64-bit registers beside the kernel's
// own, so the stamped copy runs somewhat slower than the port's.
#pragma once

#include <cuda_runtime.h>

constexpr int kClockSlots = 16;       // phases a kernel may stamp
constexpr int kClockBlocks = 256;     // blocks whose clocks are kept
__device__ long long phase_clocks[kClockBlocks][kClockSlots + 1];

#define PHASE_CLOCK_START(phases)                                      \
  static_assert((phases) <= kClockSlots, "too many phases");           \
  long long pc_acc_[kClockSlots] = {};                                 \
  long long pc_last_ = clock64();                                      \
  const long long pc_start_ = pc_last_
#define PHASE_CLOCK(p)                                                 \
  do {                                                                 \
    const long long pc_now_ = clock64();                               \
    pc_acc_[(p)] += pc_now_ - pc_last_;                                \
    pc_last_ = pc_now_;                                                \
  } while (0)
#define PHASE_CLOCK_END()                                              \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {               \
      for (int i_ = 0; i_ < kClockSlots; ++i_)                         \
        phase_clocks[blockIdx.x][i_] = pc_acc_[i_];                    \
      phase_clocks[blockIdx.x][kClockSlots] = pc_last_ - pc_start_;    \
    }                                                                  \
  } while (0)

// The clocks of the last stamped launch: kClockSlots + 1 values (the
// phases' sums, then the total) of each of the first `blocks` blocks into
// `out` (host memory).
extern "C" int phase_clocks_copy(long long* out, int blocks) {
  if (blocks < 0 || blocks > kClockBlocks) return int(cudaErrorInvalidValue);
  return int(cudaMemcpyFromSymbol(
      out, phase_clocks, sizeof(long long) * (kClockSlots + 1) * blocks));
}
