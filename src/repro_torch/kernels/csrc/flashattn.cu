// Blocked attention with an online softmax (flash attention), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX reference:
//   src/repro/kernels/flashattn.py: flash_attention (_flash_kernel)
//
// out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D))
//                   * v[b, j, h, :]
//   over j <= i when causal, for q, k, v and out of shape (B, S, H, D),
//   contiguous, in float32, bfloat16 or float16.  Products, the softmax
//   statistics and the sums are float32; masked logits are -1e30, the
//   normaliser is floored at 1e-20, and the output is rounded to nearest
//   into q's type.  Head dims 8, 16, 64, 128 and 256, and every multiple of
//   64 above 256 (the wrapper raises on any other).
//   What bounds it: operations.  4*B*H*D*P flops and B*H*P exponentials,
//   P = S*S, or S*(S+1)/2 when causal, against 4*B*S*H*D*itemsize bytes.
//   The Pallas kernel walks a (B*H, S/bq, S/bk) grid in order, carrying m,
//   l and acc in VMEM scratch across the KV axis, after the caller has
//   transposed q, k, v to (B*H, S, D).  Here one thread block owns one
//   (b*h, q tile), loops over the KV tiles itself and reads (B, S, H, D) in
//   place (grid.x the q tiles, grid.y the b*h index, launched in slices
//   of 65,535 b*h when B*H exceeds the grid's y limit).  Causal blocks stop
//   at the last KV tile that meets the diagonal, and the q tiles are
//   launched last-first, so the longest rows start first.  The route is a function of (dtype, D) alone, the same as
//   kernels/flashattn.py::design:
//
//   "wgmma": bfloat16 and float16 at D = 64, 128, 256, on the tensor cores.
//   256 threads: two warpgroups, each owning 64 of the block's 128 query
//   rows.  Thread 0 also loads: Q once, and a 2-stage K/V ring by TMA (4-D
//   tensor maps over {D, H, S, B}, boxes of 64 columns x rows with the
//   128-byte swizzle, rows past S zero-filled), with full/empty mbarriers;
//   it refills a stage once all eight warps have left it, so the load of
//   tile t + 2 overlaps the products of tile t + 1.  (A refill that never
//   blocks, with 3 stages, let the warpgroups drift apart and measured
//   slower.)  S = Q K^T is wgmma
//   m64nBKk16 with both operands in shared memory (K-major); the float32
//   accumulator is the softmax's own layout (a thread holds rows
//   16*warp + lane/4 and +8, columns 8i + 2*(lane%4) and +1), so row maxima
//   are two quad shuffles, and P, rounded pairwise to the input type, is
//   already the register A fragment of O += P V (V from shared memory,
//   MN-major, transposed by the instruction).  P never goes through shared
//   memory.  exp2 of logits pre-scaled by scale*log2(e) (error far below
//   the 16-bit rounding of P).  Only the tiles that meet the diagonal or S
//   apply the mask.  Registers decide the layout: at D = 256 a thread holds
//   128 floats of O and 32 of S.  ptxas gave a wgmma kernel of 288 or 384
//   threads 168 registers a thread, setmaxnreg or not, and it spilled; at
//   256 threads (one block an SM) the bound is 255.
//
//   "simt": float32 at every D (TF32 would miss the float32 tolerance),
//   and the 16-bit types at D = 8 and 16.  128 threads, on the FMA pipe:
//   Q and K are staged transposed and V as is, in float32, and a thread
//   owns TM x TN logits and TM x D/G outputs, with its rows and columns in
//   runs of 4, so each step of the QK^T and P.V loops is a few 128-bit
//   shared loads for TM*TN (or TM*D/G) FMAs.  The shared rows are not
//   padded (that breaks 16-byte alignment); runs of 4 are XOR-swizzled
//   by row instead, which keeps the transposing stores and the 128-bit
//   reads apart in the banks.  P goes through shared memory, transposed.
//   expf is the accurate one: the build does not use fast math.
//
//   "simt_split": D > 256, every dtype, in float32 on the FMA pipe.  The
//   simt kernel's registers hold a row's whole output, so past D = 256 the
//   output columns are split: grid.x also runs over slices of 256 output
//   columns, and each block recomputes its tile's logits over the whole D
//   in chunks of 64 columns staged through shared memory (the tiles of the
//   simt kernel at D = 256), then accumulates P.V over its own slice.  The
//   logits are computed ceil(D / 256) times; a correct, simple kernel.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr size_t kStaticSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// four consecutive elements (16-byte aligned for float, 8 for 16 bits)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&w);
  return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}

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

// ---------------------------------------------------------------- simt --

// one 128-bit shared load into four registers
__device__ __forceinline__ void unpack4(float* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

constexpr int kSimtThreads = 128;

// A thread owns TM query rows and TN keys of a tile (runs of 4), and D/G
// output columns; RG = 128/G row groups.  BQ = TM*RG, BK = TN*G.
template <int D> struct Simt;
template <> struct Simt<8> { static constexpr int G = 2, TM = 4, TN = 8; };
template <> struct Simt<16> { static constexpr int G = 4, TM = 4, TN = 8; };
template <> struct Simt<64> { static constexpr int G = 8, TM = 8, TN = 8; };
template <> struct Simt<128> { static constexpr int G = 8, TM = 4, TN = 8; };
template <> struct Simt<256> { static constexpr int G = 16, TM = 4, TN = 4; };

template <int D>
struct SimtShape {
  static constexpr int G = Simt<D>::G, TM = Simt<D>::TM, TN = Simt<D>::TN;
  static constexpr int RG = kSimtThreads / G, BQ = TM * RG, BK = TN * G;
  static constexpr int TD = D / G;
  static constexpr size_t smem =
      sizeof(float) * (size_t(D) * BQ + size_t(D) * BK + size_t(BK) * D +
                       size_t(BK) * BQ);
};

// Word of (row r, column i) in a shared [rows][W] float matrix whose runs of
// 4 columns are XOR-swizzled by r/4: a run stays whole (128-bit loads), and
// rows 4 apart land their runs on other banks.
template <int W>
__device__ __forceinline__ int swz(int r, int i) {
  constexpr int kMask = (W / 4 < 8 ? W / 4 : 8) - 1;
  return r * W + ((((i >> 2) ^ (r >> 2)) & kMask) | ((i >> 2) & ~kMask)) * 4 +
         (i & 3);
}

// The steps of a KV tile that the simt and simt_split kernels share.  C is
// the tile shape (SimtShape); a thread owns rows (r/4*RG + ty)*4 + r%4,
// keys (c/4*G + tx)*4 + c%4 and output columns (c/4*G + tx)*4 + c%4.

// sc += Q K^T over ROWS staged columns: qt [ROWS][BQ] and kt [ROWS][BK],
// transposed and swizzled.  Rows d .. d + 3 share their swizzle: one
// address computation per four steps.
template <typename C, int ROWS>
__device__ __forceinline__ void simt_qk(float (&sc)[C::TM][C::TN],
                                        const float* qt, const float* kt,
                                        int tx, int ty) {
  constexpr int G = C::G, TM = C::TM, TN = C::TN, RG = C::RG;
  constexpr int BQ = C::BQ, BK = C::BK;
#pragma unroll 1
  for (int d = 0; d < ROWS; d += 4) {
    int oa[TM / 4], ob[TN / 4];
#pragma unroll
    for (int r = 0; r < TM / 4; ++r) oa[r] = swz<BQ>(d, (r * RG + ty) * 4);
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) ob[c] = swz<BK>(d, (c * G + tx) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM / 4; ++r)
        unpack4(a + 4 * r, qt + oa[r] + e * BQ);
#pragma unroll
      for (int c = 0; c < TN / 4; ++c)
        unpack4(b + 4 * c, kt + ob[c] + e * BK);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) sc[r][c] = fmaf(a[r], b[c], sc[r][c]);
    }
  }
}

// The online softmax of one KV tile's logits, row by row: masks, scales,
// updates m and l, rescales acc, and stores p transposed to ps[key][row].
template <typename C, bool kCausal>
__device__ __forceinline__ void simt_softmax(
    float (&sc)[C::TM][C::TN], float (&m)[C::TM], float (&l)[C::TM],
    float (&acc)[C::TM][C::TD], int q0, int k0, int seq, float scale,
    int tx, int ty, float* ps) {
  constexpr int G = C::G, TM = C::TM, TN = C::TN, RG = C::RG;
  constexpr int BQ = C::BQ, TD = C::TD;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ((r / 4) * RG + ty) * 4 + r % 4;
    float mx = kMaskValue;
    unsigned ok = 0;   // bit c: key c is visible to this row
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int kj = k0 + ((c / 4) * G + tx) * 4 + c % 4;
      if (kj < seq && (!kCausal || qi >= kj)) ok |= 1u << c;
      sc[r][c] = (ok >> c) & 1u ? sc[r][c] * scale : kMaskValue;
      mx = fmaxf(mx, sc[r][c]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[r], mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const float p = (ok >> c) & 1u ? expf(sc[r][c] - m_new) : 0.f;
      sum += p;
      sc[r][c] = p;
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
#pragma unroll
  for (int r = 0; r < TM; r += 4)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = ((c / 4) * G + tx) * 4 + c % 4;
      *reinterpret_cast<float4*>(ps + swz<BQ>(j, ((r / 4) * RG + ty) * 4)) =
          make_float4(sc[r][c], sc[r + 1][c], sc[r + 2][c], sc[r + 3][c]);
    }
}

// acc += P . V over the tile's keys: ps [BK][BQ] (transposed, swizzled),
// vs [BK][W]; four keys per address computation.
template <typename C, int W>
__device__ __forceinline__ void simt_pv(float (&acc)[C::TM][C::TD],
                                        const float* ps, const float* vs,
                                        int tx, int ty) {
  constexpr int G = C::G, TM = C::TM, RG = C::RG;
  constexpr int BQ = C::BQ, BK = C::BK, TD = C::TD;
#pragma unroll 1
  for (int j = 0; j < BK; j += 4) {
    int op[TM / 4];
#pragma unroll
    for (int r = 0; r < TM / 4; ++r) op[r] = swz<BQ>(j, (r * RG + ty) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p[TM], w[TD];
#pragma unroll
      for (int r = 0; r < TM / 4; ++r)
        unpack4(p + 4 * r, ps + op[r] + e * BQ);
#pragma unroll
      for (int c = 0; c < TD / 4; ++c)
        unpack4(w + 4 * c, vs + (j + e) * W + (c * G + tx) * 4);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[r][c] = fmaf(p[r], w[c], acc[r][c]);
    }
  }
}

// (one block an SM is enough: without the bound's second argument ptxas
// spilled a word at D = 8 and 16 to stay at 96 registers)
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kSimtThreads, 1)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int seq,
                  int heads, float scale, int n_q_tiles, int64_t bh0) {
  using C = SimtShape<D>;
  constexpr int G = C::G, TM = C::TM, TN = C::TN, RG = C::RG;
  constexpr int BQ = C::BQ, BK = C::BK, TD = C::TD;
  constexpr int RUNS = D / 4;                  // runs of 4 in a row of D
  constexpr int STEP = kSimtThreads / RUNS;    // rows a staging pass
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TD % 4 == 0 && G <= 32 &&
                    (G & (G - 1)) == 0 && kSimtThreads % RUNS == 0,
                "tile shape");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;              // [D][BQ], Q transposed, swizzled
  float* kt = qt + D * BQ;       // [D][BK], K transposed, swizzled
  float* vs = kt + D * BK;       // [BK][D]
  float* ps = vs + BK * D;       // [BK][BQ], probabilities transposed

  const int tid = threadIdx.x;
  const int tx = tid % G, ty = tid / G;
  const int q0 = (n_q_tiles - 1 - int(blockIdx.x)) * BQ;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t stride = int64_t(heads) * D;            // one position
  const int64_t base = ((bh / heads) * seq * heads + bh % heads) * D;
  // a thread stages columns d0 .. d0 + 3 of rows tid / RUNS + STEP*n
  const int d0 = 4 * (tid % RUNS), row0 = tid / RUNS;

  for (int i = row0; i < BQ; i += STEP) {
    const float4 x = q0 + i < seq
                         ? load4(q + base + (q0 + i) * stride + d0)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    qt[swz<BQ>(d0, i)] = x.x;
    qt[swz<BQ>(d0 + 1, i)] = x.y;
    qt[swz<BQ>(d0 + 2, i)] = x.z;
    qt[swz<BQ>(d0 + 3, i)] = x.w;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;
  }

  const int k_end = kCausal ? min(q0 + BQ, seq) : seq;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // Q is staged; the last tile's readers are done
    for (int j = row0; j < BK; j += STEP) {
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < seq) {
        kx = load4(k + base + (k0 + j) * stride + d0);
        vx = load4(v + base + (k0 + j) * stride + d0);
      }
      kt[swz<BK>(d0, j)] = kx.x;
      kt[swz<BK>(d0 + 1, j)] = kx.y;
      kt[swz<BK>(d0 + 2, j)] = kx.z;
      kt[swz<BK>(d0 + 3, j)] = kx.w;
      *reinterpret_cast<float4*>(vs + j * D + d0) = vx;
    }
    __syncthreads();

    float sc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) sc[r][c] = 0.f;
    simt_qk<C, D>(sc, qt, kt, tx, ty);

    simt_softmax<C, kCausal>(sc, m, l, acc, q0, k0, seq, scale, tx, ty, ps);
    __syncthreads();

    simt_pv<C, D>(acc, ps, vs, tx, ty);
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ((r / 4) * RG + ty) * 4 + r % 4;
    if (qi >= seq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < TD; ++c)
      out[base + qi * stride + ((c / 4) * G + tx) * 4 + c % 4] =
          from_f32<T>(acc[r][c] / denom);
  }
}

// ---------------------------------------------------------- simt_split --

// D > 256 (every dtype, float32 arithmetic): the column split.  A block owns
// one (b*h, q tile, slice of kSplitDV output columns); it builds each KV
// tile's logits over the whole D in chunks of kSplitDC columns (Q and K
// chunks staged transposed in shared memory, as the simt kernel stages
// them whole), runs the simt kernel's online softmax, and accumulates P.V
// over its own columns only.  The logits are recomputed once per slice.
// The tiles are the simt kernel's at D = 256 (Simt<256>).  D must be a
// multiple of kSplitDC (the caller zero-pads); the last slice may be
// ragged, its columns past D read as zeros and never written.
constexpr int kSplitDV = 256;
constexpr int kSplitDC = 64;

template <int DV>
struct SplitShape {
  using C = SimtShape<DV>;
  static constexpr size_t smem =
      sizeof(float) * (size_t(kSplitDC) * C::BQ + size_t(kSplitDC) * C::BK +
                       size_t(C::BK) * DV + size_t(C::BK) * C::BQ);
};

template <typename T, int DV, bool kCausal>
__global__ void __launch_bounds__(kSimtThreads, 1)
flash_simt_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int seq,
                        int heads, int dim, float scale, int n_q_tiles,
                        int n_slices, int64_t bh0) {
  using C = SimtShape<DV>;
  constexpr int G = C::G, TM = C::TM, TN = C::TN, RG = C::RG;
  constexpr int BQ = C::BQ, BK = C::BK, TD = C::TD;
  constexpr int DC = kSplitDC;
  constexpr int CRUNS = DC / 4;                 // runs of 4 in a chunk row
  constexpr int CSTEP = kSimtThreads / CRUNS;   // rows a chunk staging pass
  constexpr int VRUNS = DV / 4;                 // runs of 4 in a slice row
  constexpr int VSTEP = kSimtThreads / VRUNS;   // rows a V staging pass
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TD % 4 == 0 && G <= 32 &&
                    (G & (G - 1)) == 0 && kSimtThreads % CRUNS == 0 &&
                    kSimtThreads % VRUNS == 0,
                "tile shape");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;              // [DC][BQ], a Q chunk transposed, swizzled
  float* kt = qt + DC * BQ;      // [DC][BK], a K chunk transposed, swizzled
  float* vs = kt + DC * BK;      // [BK][DV], the slice's V columns
  float* ps = vs + BK * DV;      // [BK][BQ], probabilities transposed

  const int tid = threadIdx.x;
  const int tx = tid % G, ty = tid / G;
  const int q0 = (n_q_tiles - 1 - int(blockIdx.x) / n_slices) * BQ;
  const int c0 = (int(blockIdx.x) % n_slices) * DV;   // the slice's columns
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t stride = int64_t(heads) * dim;          // one position
  const int64_t base = ((bh / heads) * seq * heads + bh % heads) * dim;
  const int d0 = 4 * (tid % CRUNS), row0 = tid / CRUNS;
  const int v0 = 4 * (tid % VRUNS), vrow0 = tid / VRUNS;
  const bool v_in = c0 + v0 < dim;   // runs of 4 never straddle D

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;
  }

  const int k_end = kCausal ? min(q0 + BQ, seq) : seq;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float sc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) sc[r][c] = 0.f;

#pragma unroll 1
    for (int dc = 0; dc < dim; dc += DC) {
      __syncthreads();   // the last chunk's (and tile's) readers are done
      for (int i = row0; i < BQ; i += CSTEP) {
        const float4 x = q0 + i < seq
                             ? load4(q + base + (q0 + i) * stride + dc + d0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        qt[swz<BQ>(d0, i)] = x.x;
        qt[swz<BQ>(d0 + 1, i)] = x.y;
        qt[swz<BQ>(d0 + 2, i)] = x.z;
        qt[swz<BQ>(d0 + 3, i)] = x.w;
      }
      for (int j = row0; j < BK; j += CSTEP) {
        const float4 x = k0 + j < seq
                             ? load4(k + base + (k0 + j) * stride + dc + d0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        kt[swz<BK>(d0, j)] = x.x;
        kt[swz<BK>(d0 + 1, j)] = x.y;
        kt[swz<BK>(d0 + 2, j)] = x.z;
        kt[swz<BK>(d0 + 3, j)] = x.w;
      }
      __syncthreads();
      simt_qk<C, DC>(sc, qt, kt, tx, ty);
    }

    // the slice's V columns; vs and ps were last read before the chunk
    // loop's first barrier
    for (int j = vrow0; j < BK; j += VSTEP) {
      const float4 x = k0 + j < seq && v_in
                           ? load4(v + base + (k0 + j) * stride + c0 + v0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vs + j * DV + v0) = x;
    }

    simt_softmax<C, kCausal>(sc, m, l, acc, q0, k0, seq, scale, tx, ty, ps);
    __syncthreads();

    simt_pv<C, DV>(acc, ps, vs, tx, ty);   // over the slice's columns
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ((r / 4) * RG + ty) * 4 + r % 4;
    if (qi >= seq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = c0 + ((c / 4) * G + tx) * 4 + c % 4;
      if (col < dim)
        out[base + qi * stride + col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

// --------------------------------------------------------------- wgmma --

constexpr int kBQ = 128;                 // query rows a block, 64 a warpgroup
constexpr int kStages = 2;               // K/V ring
constexpr int kWgThreads = 256;          // two warpgroups, 64 rows each
constexpr int kConsumerArrivals = 8;     // one per warp

template <int D>
struct WgShape {
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int PANELS = D / 64;  // 64-column (128-byte) panels
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // K or V, one stage
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle
  static constexpr size_t smem = 1024 + Q_BYTES + 2 * kStages * KV_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// spin until the phase of the given parity has completed; a wait that
// never ends (a lost arrival) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// one box of the 4-D map {D, H, S, B} at (col, h, s, b) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int h, int s, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(s), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Operand lists of the accumulators (32, 64 or 128 float32 a thread).
#define FLASH_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define FLASH_C32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),  \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),  \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
  "+f"(d[30]), "+f"(d[31])
#define FLASH_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FLASH_C64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),  \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),  \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define FLASH_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define FLASH_C128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),  \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),  \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),  \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),  \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),  \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),  \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),  \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),  \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),  \
  "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),  \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),  \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (+)= A B over k16, m64nN: A and B both from shared memory, K-major
#define FLASH_SS_ASM(R, N, TY, IA, IB, IS)                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "           \
  FLASH_D##R ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"
#define FLASH_SS(R, N, IA, IB, IS)                                          \
  template <typename T>                                                     \
  __device__ __forceinline__ void wgmma_ss(float(&d)[R], uint64_t a,       \
                                           uint64_t b, int scale_d) {       \
    if constexpr (std::is_same_v<T, __half>)                                \
      asm volatile(FLASH_SS_ASM(R, N, "f16", IA, IB, IS)                    \
                   : FLASH_C##R : "l"(a), "l"(b), "r"(scale_d));            \
    else                                                                    \
      asm volatile(FLASH_SS_ASM(R, N, "bf16", IA, IB, IS)                   \
                   : FLASH_C##R : "l"(a), "l"(b), "r"(scale_d));            \
  }
FLASH_SS(32, 64, 32, 33, 34)
FLASH_SS(64, 128, 64, 65, 66)

// d (+)= A B over k16, m64nN: A from registers (four 16-bit pairs a
// thread), B from shared memory, MN-major (transposed by the instruction)
#define FLASH_RS_ASM(R, N, TY, A0, A1, A2, A3, IB, IS)                      \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "           \
  FLASH_D##R ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #IB            \
  ", p, 1, 1, 1;\n}\n"
#define FLASH_RS(R, N, A0, A1, A2, A3, IB, IS)                              \
  template <typename T>                                                     \
  __device__ __forceinline__ void wgmma_rs(float(&d)[R], const uint32_t* a, \
                                           uint64_t b, int scale_d) {       \
    if constexpr (std::is_same_v<T, __half>)                                \
      asm volatile(FLASH_RS_ASM(R, N, "f16", A0, A1, A2, A3, IB, IS)        \
                   : FLASH_C##R                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                     "r"(scale_d));                                         \
    else                                                                    \
      asm volatile(FLASH_RS_ASM(R, N, "bf16", A0, A1, A2, A3, IB, IS)       \
                   : FLASH_C##R                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                     "r"(scale_d));                                         \
  }
FLASH_RS(32, 64, 32, 33, 34, 35, 36, 37)
FLASH_RS(64, 128, 64, 65, 66, 67, 68, 69)
FLASH_RS(128, 256, 128, 129, 130, 131, 132, 133)

// two float32 rounded to nearest into one register of two 16-bit values,
// the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   T* __restrict__ out, int seq, int heads, float scale_log2,
                   int n_q_tiles, int64_t bh0) {
  using C = WgShape<D>;
  constexpr int BK = C::BK, PANELS = C::PANELS;
  constexpr int NS = BK / 2;      // logits a thread (m64nBK accumulator)
  constexpr int NO = D / 2;       // outputs a thread (m64nD accumulator)
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kStages],
      bar_empty[kStages];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Q: PANELS x [kBQ rows][128 bytes]; stage s: K then V, each
  // PANELS x [BK rows][128 bytes]
  uint8_t* q_s = tiles;
  auto k_s = [&](int st) { return tiles + C::Q_BYTES + st * 2 * C::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + C::KV_BYTES; };

  const int q0 = (n_q_tiles - 1 - int(blockIdx.x)) * kBQ;
  const int64_t bh = bh0 + blockIdx.y;
  const int b = int(bh / heads), h = int(bh % heads);
  const int kv_end = kCausal ? min(q0 + kBQ, seq) : seq;
  const int n_kv = (kv_end + BK - 1) / BK;

  // thread 0 loads: K and V of tile t into stage t % kStages
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mbar_expect_tx(&bar_full[st], 2 * C::KV_BYTES);
    for (int p = 0; p < PANELS; ++p) {
      tma_load(k_s(st) + p * BK * 128, &map_k, 64 * p, h, t * BK, b,
               &bar_full[st]);
      tma_load(v_s(st) + p * BK * 128, &map_v, 64 * p, h, t * BK, b,
               &bar_full[st]);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar_full[st], 1);
      mbar_init(&bar_empty[st], kConsumerArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar_q, C::Q_BYTES);
    for (int p = 0; p < PANELS; ++p)
      tma_load(q_s + p * kBQ * 128, &map_q, 64 * p, h, q0, b, &bar_q);
    for (int t = 0; t < kStages && t < n_kv; ++t) load_kv(t);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;            // which 64 rows
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row_lo = q0 + 64 * c;             // the warpgroup's first row
  const int r0 = row_lo + 16 * warp + lane / 4;   // and r0 + 8
  const int col = 2 * (lane % 4);             // + 8i, + 8i + 1
  const int my_end = kCausal ? min(row_lo + 64, seq) : seq;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  // descriptors: Q and K K-major (8-row groups 1024 bytes apart), V
  // MN-major (64-column panels BK*128 bytes apart, 8-key groups 1024)
  const uint64_t dq = desc_sw128(q_s + c * 64 * 128, 16, 1024);
  mbar_wait(&bar_q, 0);

  for (int t = 0; t < n_kv; ++t) {
    const int st = t % kStages, k0 = t * BK;
    mbar_wait(&bar_full[st], (t / kStages) & 1);
    if (k0 < my_end) {
      float s[NS];
      const uint64_t dk = desc_sw128(k_s(st), 16, 1024);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // panel kk/4 of Q and K, 32 bytes (16 columns) into it
        const uint32_t qoff = ((kk / 4) * kBQ * 128 + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss<T>(s, dq + qoff, dk + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax on the accumulator's layout, in the log2 domain
      const bool edge = k0 + BK > seq || (kCausal && k0 + BK - 1 > row_lo);
      float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int half = (i / 2) % 2;        // row r0 or r0 + 8
        float x = s[i] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * (i / 4) + col + i % 2;
          const int qi = r0 + 8 * half;
          if (kj >= seq || (kCausal && kj > qi)) x = kMaskValue;
        }
        s[i] = x;
        mx[half] = fmaxf(mx[half], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int half = (i / 2) % 2;
        // m is finite here: every row meets a visible key in tile 0
        const float p = exp2f(s[i] - m[half]);
        l[half] += p;           // this thread's part; quad-summed at the end
        s[i] = p;
      }
      // P as the A fragments of m64nDk16: k-slice kk holds logits
      // 8kk .. 8kk + 7 of this thread
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
        a[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];

      const uint64_t dv = desc_sw128(v_s(st), BK * 128, 1024);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T>(o, a[kk], dv + ((kk * 16 * 128) >> 4), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    if (lane == 0) mbar_arrive(&bar_empty[st]);   // this warp is done
    if (threadIdx.x == 0 && t + kStages < n_kv) {
      // refill the stage once all eight warps have left it
      mbar_wait(&bar_empty[st], (t / kStages) & 1);
      load_kv(t + kStages);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= seq) continue;
    T* row = out + ((int64_t(b) * seq + qi) * heads + h) * D + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t w =
          pack2<T>(o[4 * i + 2 * r] * l[r], o[4 * i + 2 * r + 1] * l[r]);
      *reinterpret_cast<uint32_t*>(row + 8 * i) = w;
    }
  }
}

// ---------------------------------------------------------------- host --

// grid.y carries the b*h index, in launches of at most kMaxGridY of them;
// each launch passes its first index (bh0) to the kernel
constexpr int64_t kMaxGridY = 65535;

inline int64_t slice_of(int64_t bh_total, int64_t bh0) {
  return bh_total - bh0 < kMaxGridY ? bh_total - bh0 : kMaxGridY;
}

template <typename T, int D, bool kCausal>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int64_t batch, int64_t seq, int64_t heads,
                        float scale, cudaStream_t stream) {
  using C = SimtShape<D>;
  if (seq > INT32_MAX - C::BQ) return cudaErrorInvalidValue;
  auto kern = flash_simt_kernel<T, D, kCausal>;
  if (C::smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem));
    if (err != cudaSuccess) return err;
  }
  const int n_q = int((seq + C::BQ - 1) / C::BQ);
  for (int64_t bh0 = 0; bh0 < batch * heads; bh0 += kMaxGridY) {
    const dim3 grid(unsigned(n_q), unsigned(slice_of(batch * heads, bh0)));
    kern<<<grid, kSimtThreads, C::smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), int(seq), int(heads),
        scale, n_q, bh0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool kCausal>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* out, int64_t batch, int64_t seq,
                         int64_t heads, int64_t dim, float scale,
                         cudaStream_t stream) {
  using C = SimtShape<kSplitDV>;
  if (dim % kSplitDC != 0 || dim > INT32_MAX - kSplitDV ||
      seq > INT32_MAX - C::BQ)
    return cudaErrorInvalidValue;
  auto kern = flash_simt_split_kernel<T, kSplitDV, kCausal>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SplitShape<kSplitDV>::smem));
  if (err != cudaSuccess) return err;
  const int n_q = int((seq + C::BQ - 1) / C::BQ);
  const int n_slices = int((dim + kSplitDV - 1) / kSplitDV);
  if (int64_t(n_q) * n_slices > INT32_MAX) return cudaErrorInvalidValue;
  for (int64_t bh0 = 0; bh0 < batch * heads; bh0 += kMaxGridY) {
    const dim3 grid(unsigned(n_q * n_slices),
                    unsigned(slice_of(batch * heads, bh0)));
    kern<<<grid, kSimtThreads, SplitShape<kSplitDV>::smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), int(seq), int(heads),
        int(dim), scale, n_q, n_slices, bh0);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return launch;
  }
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map {D, H, S, B} over a contiguous (B, S, H, D) 16-bit tensor;
// boxes of 64 columns (128 bytes, swizzled) x 1 head x rows x 1 batch.
// Rows past S read as zeros.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t batch,
                     int64_t seq, int64_t heads, int64_t dim, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(dim), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(dim * 2),
                                 cuuint64_t(heads * dim * 2),
                                 cuuint64_t(seq * heads * dim * 2)};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D, bool kCausal>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int64_t batch, int64_t seq, int64_t heads,
                         float scale, cudaStream_t stream) {
  using C = WgShape<D>;
  if (seq > INT32_MAX - kBQ) return cudaErrorInvalidValue;   // int rows
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<T>(&mq, q, batch, seq, heads, D, kBQ);
  if (err == cudaSuccess) err = make_map<T>(&mk, k, batch, seq, heads, D, C::BK);
  if (err == cudaSuccess) err = make_map<T>(&mv, v, batch, seq, heads, D, C::BK);
  if (err != cudaSuccess) return err;
  auto kern = flash_wgmma_kernel<T, D, kCausal>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::smem));
  if (err != cudaSuccess) return err;
  const int n_q = int((seq + kBQ - 1) / kBQ);
  for (int64_t bh0 = 0; bh0 < batch * heads; bh0 += kMaxGridY) {
    const dim3 grid(unsigned(n_q), unsigned(slice_of(batch * heads, bh0)));
    kern<<<grid, kWgThreads, C::smem, stream>>>(
        mq, mk, mv, static_cast<T*>(out), int(seq), int(heads),
        scale * 1.4426950408889634f, n_q, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out,
                       int64_t batch, int64_t seq, int64_t heads, int causal,
                       float scale, cudaStream_t stream) {
  // the route: (dtype, D) alone, as kernels/flashattn.py::design
  constexpr bool kWgmma = !std::is_same_v<T, float> && D >= 64;
  if constexpr (kWgmma) {
    return causal ? launch_wgmma<T, D, true>(q, k, v, out, batch, seq, heads,
                                             scale, stream)
                  : launch_wgmma<T, D, false>(q, k, v, out, batch, seq, heads,
                                              scale, stream);
  } else {
    return causal ? launch_simt<T, D, true>(q, k, v, out, batch, seq, heads,
                                            scale, stream)
                  : launch_simt<T, D, false>(q, k, v, out, batch, seq, heads,
                                             scale, stream);
  }
}

template <typename T>
cudaError_t launch_type(const void* q, const void* k, const void* v,
                        void* out, int64_t batch, int64_t seq, int64_t heads,
                        int64_t dim, int causal, float scale,
                        cudaStream_t stream) {
  switch (dim) {
    case 8:
      return launch_dim<T, 8>(q, k, v, out, batch, seq, heads, causal, scale,
                              stream);
    case 16:
      return launch_dim<T, 16>(q, k, v, out, batch, seq, heads, causal, scale,
                               stream);
    case 64:
      return launch_dim<T, 64>(q, k, v, out, batch, seq, heads, causal, scale,
                               stream);
    case 128:
      return launch_dim<T, 128>(q, k, v, out, batch, seq, heads, causal,
                                scale, stream);
    case 256:
      return launch_dim<T, 256>(q, k, v, out, batch, seq, heads, causal,
                                scale, stream);
    default:
      if (dim <= 256) return cudaErrorInvalidValue;
      return causal ? launch_split<T, true>(q, k, v, out, batch, seq, heads,
                                            dim, scale, stream)
                    : launch_split<T, false>(q, k, v, out, batch, seq, heads,
                                             dim, scale, stream);
  }
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launches (or
// of the tensor maps' encoding).  dtype: 0 float32, 1 bfloat16, 2 float16.
// scale multiplies the logits (1/sqrt(D) of the caller's true head dim
// when it padded D).  dim is 8, 16, 64, 128, 256 or a multiple of 64 above
// 256 (the split kernel).  batch * heads may exceed the grid's y limit: the
// launches take it in slices.  The tensors must be 16-byte aligned (the
// wrapper checks).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t batch, int64_t seq,
                               int64_t heads, int64_t dim, int dtype,
                               int causal, float scale, void* stream) {
  if (batch * seq * heads <= 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_type<float>(q, k, v, out, batch, seq, heads, dim,
                                    causal, scale, s));
    case 1:
      return int(launch_type<__nv_bfloat16>(q, k, v, out, batch, seq, heads,
                                            dim, causal, scale, s));
    case 2:
      return int(launch_type<__half>(q, k, v, out, batch, seq, heads, dim,
                                     causal, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
