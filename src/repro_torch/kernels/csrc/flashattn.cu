// Blocked attention with an online softmax (flash attention), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX reference:
//   src/repro/kernels/flashattn.py: flash_attention (_flash_kernel)
//
// out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D))
//                   * v[b, j, h, :]
//   over j <= i when causal, for q, k, v and out of shape (B, S, H, D),
//   contiguous, in float32, bfloat16 or float16.  Every product, the
//   softmax and the sums run in float32; masked logits are -1e30, the
//   normaliser is floored at 1e-20, and the output is rounded to nearest
//   into q's type.  Head dims 8, 16, 64, 128 and 256 (the wrapper raises on
//   any other).
//   What bounds it: operations.  4*B*H*D*P flops and B*H*P exponentials,
//   P = S*S, or S*(S+1)/2 when causal, against 4*B*S*H*D*itemsize bytes.
//   Design.  The Pallas kernel walks a (B*H, S/bq, S/bk) grid in order,
//   carrying m, l and acc in VMEM scratch across the KV axis, after the
//   caller has transposed q, k, v to (B*H, S, D).  Here one thread block of
//   128 threads owns one (b*h, q tile) and loops over the KV tiles itself;
//   it reads (B, S, H, D) in place (row stride H*D), so no transpose is
//   made.  Q, K and V tiles are staged in shared memory as float32 (Q and
//   K transposed, each row padded by one word, so both the staging stores
//   and the reads of the products are free of bank conflicts).  The
//   threads form RG row groups x G column groups; a thread keeps TM query
//   rows, their m and l, TN logits of the current KV tile, and TM x D/G
//   output columns of acc, all in registers.  Row maxima and sums are
//   reduced over the G lanes of a row group with warp shuffles; the
//   probabilities go through shared memory to the P.V product.  QK^T and
//   P.V are plain float32 FMAs (no tensor cores, so no TF32 rounding).
//   Causal blocks stop at the last KV tile that meets the diagonal, and
//   the q tiles are launched last-first, so the longest rows start first.
//   The tile sizes are the kernel's own; the wrapper's bq/bk are the API's.
//   expf is the accurate one: the build does not use fast math.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;
constexpr size_t kStaticSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Query rows (BQ) and keys (BK) per tile, and column groups (G), by head
// dim: acc holds BQ*D/128 floats a thread (at most 64), and the shared
// tiles stay within 105 KB, so two blocks fit on an SM at D = 256.
template <int D> struct Tile;
template <> struct Tile<8> { static constexpr int BQ = 64, BK = 64, G = 8; };
template <> struct Tile<16> { static constexpr int BQ = 64, BK = 64, G = 16; };
template <> struct Tile<64> { static constexpr int BQ = 64, BK = 32, G = 16; };
template <> struct Tile<128> { static constexpr int BQ = 64, BK = 32, G = 16; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32, G = 16; };

template <int D>
constexpr size_t smem_bytes() {
  using C = Tile<D>;
  return sizeof(float) * (D * (C::BQ + 1) + D * (C::BK + 1) + C::BK * D +
                          C::BQ * (C::BK + 1));
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int64_t seq,
             int64_t heads, float scale, int64_t n_q_tiles) {
  using C = Tile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, G = C::G;
  constexpr int RG = kThreads / G;   // row groups
  constexpr int TM = BQ / RG;        // query rows a thread
  constexpr int TN = BK / G;         // logits of a KV tile a thread
  constexpr int TD = D / G;          // output columns a thread
  static_assert(kThreads % G == 0 && BQ % RG == 0 && BK % G == 0 &&
                D % G == 0 && G <= 32 && (G & (G - 1)) == 0,
                "tile shape");
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][BQ + 1], Q transposed
  float* kt = qt + D * (BQ + 1);     // [D][BK + 1], K transposed
  float* vs = kt + D * (BK + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK + 1], probabilities

  const int tid = threadIdx.x;
  const int tx = tid % G, ty = tid / G;
  const int64_t q0 = (n_q_tiles - 1 - int64_t(blockIdx.x)) * BQ;
  const int64_t bh = blockIdx.y;
  const int64_t stride = heads * D;                     // one position
  const int64_t base = ((bh / heads) * seq * heads + bh % heads) * D;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int64_t s = q0 + i;
    qt[d * (BQ + 1) + i] = s < seq ? to_f32(q[base + s * stride + d]) : 0.f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;
  }

  const int64_t k_end = kCausal ? (q0 + BQ < seq ? q0 + BQ : seq) : seq;
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // Q is staged; the last tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int64_t s = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < seq) {
        kv = to_f32(k[base + s * stride + d]);
        vv = to_f32(v[base + s * stride + d]);
      }
      kt[d * (BK + 1) + j] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    // logits of rows ty + r*RG against keys tx + c*G
    float sc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = qt[d * (BQ + 1) + ty + r * RG];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = kt[d * (BK + 1) + tx + c * G];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) sc[r][c] = fmaf(a[r], b[c], sc[r][c]);
    }

    // online softmax, row by row
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t qi = q0 + ty + r * RG;
      bool ok[TN];
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int64_t kj = k0 + tx + c * G;
        ok[c] = kj < seq && (!kCausal || qi >= kj);
        sc[r][c] = ok[c] ? sc[r][c] * scale : kMaskValue;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float p = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
        sum += p;
        ps[(ty + r * RG) * (BK + 1) + tx + c * G] = p;
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    // acc += P . V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[TM], w[TD];
#pragma unroll
      for (int r = 0; r < TM; ++r) p[r] = ps[(ty + r * RG) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) w[c] = vs[j * D + tx + c * G];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[r][c] = fmaf(p[r], w[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t qi = q0 + ty + r * RG;
    if (qi >= seq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < TD; ++c)
      out[base + qi * stride + tx + c * G] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int D, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int64_t seq, int64_t heads, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<T, D, kCausal>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t n_q = (seq + Tile<D>::BQ - 1) / Tile<D>::BQ;
  const dim3 grid(unsigned(n_q), unsigned(batch * heads));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, heads, scale, n_q);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_causal(const void* q, const void* k, const void* v,
                          void* out, int64_t batch, int64_t seq, int64_t heads,
                          int causal, float scale, cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, out, batch, seq, heads, scale,
                                     stream)
                : launch<T, D, false>(q, k, v, out, batch, seq, heads, scale,
                                      stream);
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       int64_t batch, int64_t seq, int64_t heads, int64_t dim,
                       int causal, float scale, cudaStream_t stream) {
  switch (dim) {
    case 8:
      return launch_causal<T, 8>(q, k, v, out, batch, seq, heads, causal,
                                 scale, stream);
    case 16:
      return launch_causal<T, 16>(q, k, v, out, batch, seq, heads, causal,
                                  scale, stream);
    case 64:
      return launch_causal<T, 64>(q, k, v, out, batch, seq, heads, causal,
                                  scale, stream);
    case 128:
      return launch_causal<T, 128>(q, k, v, out, batch, seq, heads, causal,
                                   scale, stream);
    case 256:
      return launch_causal<T, 256>(q, k, v, out, batch, seq, heads, causal,
                                   scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launch.
// dtype: 0 float32, 1 bfloat16, 2 float16.  batch * heads must fit the
// grid's y dimension (the wrapper checks it).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t batch, int64_t seq,
                               int64_t heads, int64_t dim, int dtype,
                               int causal, float scale, void* stream) {
  if (batch * seq * heads <= 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_dim<float>(q, k, v, out, batch, seq, heads, dim,
                                   causal, scale, s));
    case 1:
      return int(launch_dim<__nv_bfloat16>(q, k, v, out, batch, seq, heads,
                                           dim, causal, scale, s));
    case 2:
      return int(launch_dim<__half>(q, k, v, out, batch, seq, heads, dim,
                                    causal, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
