// The counter hash and the edge trial's integer threshold, shared by the
// kernels that draw edge trials (csrc/bernoulli.cu, csrc/queue.cu), so that
// a trial has one definition on the card.
//
// h(seed, e) = fmix32(fmix32(e * 0x9E3779B9 + seed) ^ 0x9E3779B9), all
// uint32: the murmur3 finalizer applied twice, the port's
// kernels/bernoulli.py::counter_uniform_u32 and the reference's
// repro.kernels.ref.counter_uniform_u32_ref.  Edge e of a row with seed s
// is live iff float32(h(s, e)) * 2^-32 < w[e], which trial_limit turns into
// one integer compare.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_uniform_u32(uint32_t seed,
                                                        uint32_t e) {
  return fmix32(fmix32(e * kGolden + seed) ^ kGolden);
}

// Edge e keeps trial h iff h <= *limit and the function returned true:
// *limit = t - 1 for the least t in [1, 2^32] with u(t) >= w, or the
// function returns false when t = 0 (w <= 0, -0.0, NaN).  w > 1 (and +inf)
// keeps every h.  w = 1.0 does not: float32(h) rounds to 2^32 from
// h = 2^32 - 128 on, so t = 2^32 - 128.  Below 2^24 every integer is a
// float32, so t = ceil(w * 2^32); above it t is the midpoint between
// W = w * 2^32 and the float32 below it, plus one when W's mantissa is odd
// (a tie rounds to the even one).  W is exact: w * 2^32 only moves the
// exponent, and a denormal w becomes normal.  The formula of
// kernels/ref.py::trial_threshold_ref, which returns t.
__device__ __forceinline__ bool trial_limit(float w, uint32_t* limit) {
  if (!(w > 0.f)) {
    *limit = 0;
    return false;
  }
  if (w > 1.f) {
    *limit = 0xFFFFFFFFu;
    return true;
  }
  const float big = w * 0x1p32f;
  if (big <= 0x1p24f) {
    *limit = uint32_t(ceilf(big)) - 1u;
    return true;
  }
  const uint32_t bits = __float_as_uint(big);
  const int exp = int(bits >> 23) - 127;        // 24 .. 32
  const uint32_t frac = bits & 0x7FFFFFu;
  const uint32_t half_gap = frac ? 1u << (exp - 24) : 1u << (exp - 25);
  // (mantissa << (exp - 23)) is W; at W = 2^32 it wraps to 0, and the
  // result, t - 1 < 2^32, is right mod 2^32
  const uint32_t whole = (frac | 0x800000u) << (exp - 23);
  *limit = whole - half_gap + (frac & 1u) - 1u;
  return true;
}

}  // namespace
