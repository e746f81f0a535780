// Kernel K6': the backward of K6 (GQA flash attention), for Hopper, sm_90a.
//
// Replaces: no Pallas kernel.  The reference trains its LM through XLA's
// autodiff of src/repro/models/layers.py::gqa_prefill_attention (jnp, with
// remat per query block), never through the Pallas forward; the port's
// forward on the card is K6, so its gradient is a kernel too.  Given q, k, v,
// K6's output o, its row logsumexp lse (natural log, scaled score domain)
// and do = dL/do, in the [B, S, heads, dh] layout:
//
//   D   = rowsum(do o)                      (f32, one value a query row)
//   P   = exp(q k^T / sqrt(dh) - lse)       (0 where masked: causal or past S)
//   dV  = P^T do,  P rounded to v's dtype as K6's P . V takes it
//   dP  = do v^T
//   dS  = P (dP - D)
//   dQ  = dS k / sqrt(dh),  dK = dS^T q / sqrt(dh)
//
// dK and dV sum over the query heads of each KV head's group.  Accumulation
// is f32; the outputs are q's dtype, [B, S, heads, dh] contiguous.
//
// What bounds it on the card: operations.  Five products of 2 dh FLOP per
// (query, key) pair kept (S, dP, dV, dK, dQ; this design recomputes S and dP
// once more in the dQ pass: seven, and in bf16 runs dK and dQ twice, nine),
// against 2 dh elements of K and V a key
// and 3 dh of q, o, do a query row, so at S = 4096 it does thousands of FLOP
// per byte: far above the ridge.
//
// What the design does about it: a first, simple design whose point is
// determinism and exactness; PERF.md holds its times beside SDPA's
// backward and its bound.
//  * Three launches: D (a warp a row); dK/dV with one block per (b, KV head,
//    64-key tile) looping over the group's query heads and over the query
//    tiles at or after the key tile when causal; dQ with one block per (b,
//    head, 64-row query tile) looping over the key tiles up to its
//    diagonal.  Each output element is owned by one thread of one block and
//    summed in a fixed order: no atomics, two launches give equal bits (a
//    training resume stays bit-equal).
//  * P is recomputed from q, k and lse in both passes; dP from do and v.
//  * bf16 runs the products on the tensor cores with mma.sync m16n8k16
//    (the section "bf16 on mma.sync" below).
//  * f32 runs them as scalar f32 FMAs from shared memory, which keeps every
//    product exact to f32 rounding (the reference holds f32 attention to
//    2e-5) at a fraction of the f32 FMA rate (67 TFLOP/s).  Tiles live in
//    shared memory as f32 with a row pitch of dh + 1 floats (dh is a
//    multiple of 16: the pitch is odd, so 16 threads reading 16 rows at one
//    column hit 16 banks); P and dS at a pitch of 65.  A thread holds a
//    4 x 4 block of S and dP (rows ty + 16a, keys tx + 16b, ty = tid / 16,
//    tx = tid % 16) and 4 rows x dh / 16 columns of each accumulator (rows
//    ty + 16a, columns tx + 16e).
//  * Any S: rows and keys past S load as zeros and are masked; rows past S
//    are not stored.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kPitchP = kTile + 1;  // floats per row of the P and dS tiles
constexpr long long kMaxSeq = (1LL << 31) - 256;  // positions are int32
constexpr float kLog2eBwd = 1.4426950408889634f;

struct Strides {  // element strides (b, s, h) of q, k, v, o, do
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory of both passes (floats): four [kTile][D + 1] tiles (q, do,
// k, v), P and dS [kTile][kPitchP], lse and D of the query tile's rows.
template <int D>
struct Smem {
  static constexpr int kPitch = D + 1;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kTile * kPitch;  // do
  static constexpr int kK = kG + kTile * kPitch;
  static constexpr int kV = kK + kTile * kPitch;
  static constexpr int kP = kV + kTile * kPitch;
  static constexpr int kS = kP + kTile * kPitchP;  // dS
  static constexpr int kLse = kS + kTile * kPitchP;
  static constexpr int kDelta = kLse + kTile;
  static constexpr int kFloats = kDelta + kTile;
  static constexpr int kBytes = kFloats * 4;
};

// Rows [row0, row0 + kTile) of one head (src points at row 0 of it; rows
// rs elements apart) into dst as f32; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row0,
                                          long long S, long long rs) {
  constexpr int P = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const long long row = row0 + r;
    dst[r * P + d] = row < S ? to_f32(src[row * rs + d]) : 0.f;
  }
}

// lse and D of the query tile's rows (0 past S: those rows are masked).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                                          const float* delta, long long row0, long long S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const long long row = row0 + r;
    lse_s[r] = row < S ? lse[row] : 0.f;
    delta_s[r] = row < S ? delta[row] : 0.f;
  }
}

// This thread's 4 x 4 of S = q k^T (unscaled) and dP = do v^T on the tiles in
// shared memory: rows ty + 16a, keys tx + 16b.
template <int D>
__device__ __forceinline__ void score_tiles(float (&s)[4][4], float (&dp)[4][4],
                                            const float* sm, int ty, int tx) {
  using Sm = Smem<D>;
  constexpr int P = Sm::kPitch;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sm[Sm::kQ + (ty + 16 * a) * P + d];
      ga[a] = sm[Sm::kG + (ty + 16 * a) * P + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = sm[Sm::kK + (tx + 16 * b) * P + d];
      vb[b] = sm[Sm::kV + (tx + 16 * b) * P + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(ga[a], vb[b], dp[a][b]);
      }
  }
}

// P and dS of this thread's 4 x 4 (s becomes P, dp becomes dS): query rows
// q0 + ty + 16a, keys k0 + tx + 16b; masked where a key lies past S or, when
// causal, after its query, and on rows past S.
template <int D>
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4], const float* sm,
                                      long long q0, long long k0, long long S, int causal,
                                      float scale, int ty, int tx) {
  using Sm = Smem<D>;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const long long row = q0 + r;
    const float lse = sm[Sm::kLse + r];
    const float delta = sm[Sm::kDelta + r];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long key = k0 + tx + 16 * b;
      const bool valid = row < S && key < S && (!causal || key <= row);
      const float p = valid ? expf(fmaf(s[a][b], scale, -lse)) : 0.f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - delta);
    }
  }
}

// acc[a][e] += sum_r A[r][ty + 16a] B[r][tx + 16e] over the tile's rows r:
// A a [kTile][kPitchP] tile read down its columns (P or dS, giving dV or dK),
// B a [kTile][D + 1] tile.
template <int D>
__device__ __forceinline__ void acc_transposed(float (&acc)[4][D / 16], const float* A,
                                               const float* B, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 2
  for (int r = 0; r < kTile; ++r) {
    float a_[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) a_[a] = A[r * kPitchP + ty + 16 * a];
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      const float b_ = B[r * P + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][e] = fmaf(a_[a], b_, acc[a][e]);
    }
  }
}

// The first query tile that key tile j's dK/dV loop visits (tiles of
// `ratio` query tiles a key tile): when causal, the first that holds a
// query at or after the key tile's first key; else the first.
__device__ __forceinline__ int first_query_tile(int j, int causal, int ratio) {
  return causal ? j * ratio : 0;
}

// The forward's D = rowsum(do o) in f32: a warp a (b, h, row), the lanes
// over dh, then a butterfly.  delta is [B, H, S].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                     float* __restrict__ delta, long long S, int H,
                                     Strides st) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  if (s >= S) return;  // the whole warp: one row a warp
  const T* orow = o + b * st.ob + s * st.os + (long long)h * st.oh;
  const T* grow = g + b * st.gb + s * st.gs + (long long)h * st.gh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(grow[d]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(b * H + h) * S + s] = acc;
}

// dK and dV: a block per (64-key tile, KV head, b), looping over the group's
// query heads and their query tiles (from the key tile's own when causal).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const T* __restrict__ g,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, T* __restrict__ dk,
                                    T* __restrict__ dv, long long S, int H, int Hkv, int causal,
                                    float scale, Strides st) {
  using Sm = Smem<D>;
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int group = H / Hkv;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long long k0 = (long long)j * kTile;
  const int n_q = (int)((S + kTile - 1) / kTile);

  load_tile<T, D>(sm + Sm::kK, k + b * st.kb + (long long)hk * st.kh, k0, S, st.ks);
  load_tile<T, D>(sm + Sm::kV, v + b * st.vb + (long long)hk * st.vh, k0, S, st.vs);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qh = q + b * st.qb + (long long)h * st.qh;
    const T* gh = g + b * st.gb + (long long)h * st.gh;
    const float* lse_h = lse + (b * H + h) * S;
    const float* delta_h = delta + (b * H + h) * S;
    for (int i = first_query_tile(j, causal, 1); i < n_q; ++i) {
      const long long q0 = (long long)i * kTile;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D>(sm + Sm::kQ, qh, q0, S, st.qs);
      load_tile<T, D>(sm + Sm::kG, gh, q0, S, st.gs);
      load_rows(sm + Sm::kLse, sm + Sm::kDelta, lse_h, delta_h, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      score_tiles<D>(s, dp, sm, ty, tx);
      probs<D>(s, dp, sm, q0, k0, S, causal, scale, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) {
          const int at = (ty + 16 * a) * kPitchP + tx + 16 * b2;
          sm[Sm::kP + at] = to_f32(from_f32<T>(s[a][b2]));  // P as K6's P . V took it
          sm[Sm::kS + at] = dp[a][b2];
        }
      __syncthreads();
      acc_transposed<D>(acc_v, sm + Sm::kP, sm + Sm::kG, ty, tx);
      acc_transposed<D>(acc_k, sm + Sm::kS, sm + Sm::kQ, ty, tx);
    }
  }

  // dK, dV [B, S, Hkv, D] contiguous
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long key = k0 + ty + 16 * a;
    if (key >= S) continue;
    const long long at = ((b * S + key) * Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      dk[at + tx + 16 * e] = from_f32<T>(acc_k[a][e] * scale);
      dv[at + tx + 16 * e] = from_f32<T>(acc_v[a][e]);
    }
  }
}

// dQ: a block per (64-row query tile, head, b), looping over the key tiles
// up to its diagonal when causal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ g,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, T* __restrict__ dq,
                                  long long S, int H, int Hkv, int causal, float scale,
                                  Strides st) {
  using Sm = Smem<D>;
  constexpr int P = Sm::kPitch;
  extern __shared__ float sm[];
  const int i = (int)(gridDim.x - 1 - blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const long long q0 = (long long)i * kTile;
  const int n_k = causal ? i + 1 : (int)((S + kTile - 1) / kTile);

  load_tile<T, D>(sm + Sm::kQ, q + b * st.qb + (long long)h * st.qh, q0, S, st.qs);
  load_tile<T, D>(sm + Sm::kG, g + b * st.gb + (long long)h * st.gh, q0, S, st.gs);
  load_rows(sm + Sm::kLse, sm + Sm::kDelta, lse + (b * H + h) * S, delta + (b * H + h) * S,
            q0, S);
  const T* kh = k + b * st.kb + (long long)hk * st.kh;
  const T* vh = v + b * st.vb + (long long)hk * st.vh;
  float acc[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[a][e] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const long long k0 = (long long)j * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(sm + Sm::kK, kh, k0, S, st.ks);
    load_tile<T, D>(sm + Sm::kV, vh, k0, S, st.vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles<D>(s, dp, sm, ty, tx);
    probs<D>(s, dp, sm, q0, k0, S, causal, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) sm[Sm::kS + (ty + 16 * a) * kPitchP + tx + 16 * b2] = dp[a][b2];
    __syncthreads();
    // acc[a][e] += sum_c dS[ty + 16a][c] K[c][tx + 16e]
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float a_[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) a_[a] = sm[Sm::kS + (ty + 16 * a) * kPitchP + c];
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const float k_ = sm[Sm::kK + c * P + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][e] = fmaf(a_[a], k_, acc[a][e]);
      }
    }
  }

  // dQ [B, S, H, D] contiguous
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const long long at = ((b * S + row) * H + h) * D;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dq[at + tx + 16 * e] = from_f32<T>(acc[a][e] * scale);
  }
}

// ------------------------------------------------------- bf16 on mma.sync
//
// The bf16 kernels run the five products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate): 4 warps a block, 16 rows a
// warp.  dK/dV: a block owns 64 keys (16 a warp) and streams the group's
// query tiles of 32 rows; the warp forms S^T = K Q^T and dP^T = V dO^T (16
// keys x 32 queries), then P^T and dS^T in the accumulator layout, which
// packs to bf16 as the A operand of dV += P^T dO and dK += dS^T Q (the
// forward's trick for P . V).  dQ: a block owns 64 query rows (16 a warp)
// and streams key tiles of 64: S = Q K^T, dP = dO V^T, then dQ += dS K.
// Tiles sit in shared memory as bf16 rows of dh + 8 elements (16-byte
// aligned for ldmatrix, and the 8 rows of a fragment load fall in distinct
// banks); A and K-major B fragments are 32-bit loads, the B operands read
// along the tile's rows (dO, Q, K as the second factor) come by
// ldmatrix.trans.  P is rounded to bf16 for dV (as K6 rounds it for P . V).
// dS is not: rounded to bf16 (as FlashAttention-2 takes it), dQ at
// stablelm-3b's layer differed from the plain version's f32 dS by up to
// 1.6e-2 on the card (a row's sum over thousands of keys cancels), 3.9e-3
// split (PERF.md); so dS = hi + lo, two bf16 parts, and each of those
// products is two mma.sync (lo first), which keeps dS to about 2^-17 of
// itself.  Every sum stays f32.  No atomics:
// each output element belongs to one warp and is summed in a fixed order.

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kOwnMma = 16 * kWarpsMma;  // keys (dK/dV) or query rows (dQ) a block owns
constexpr int kQStepMma = 32;  // query rows a dK/dV iteration streams
constexpr int kKStepMma = 64;  // keys a dQ iteration streams
static_assert(kOwnMma == kTile, "both designs tile S by 64: one grid formula");

template <int D>
struct SmemMma {  // four bf16 tiles of kOwnMma rows, then lse and D of the query rows
  static constexpr int kPitch = D + 8;
  static constexpr int kTile = kOwnMma * kPitch;
  static constexpr int kBytes = 4 * kTile * 2 + 2 * kOwnMma * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 (columns 2t, 2t + 1 of an A fragment) as two bf16 parts each:
// big = x rounded to bf16, small = the rest rounded to bf16.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(x0 - bf.x, x1 - bf.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&s);
}

// The A fragment of k-step kk from the accumulators of n-tiles 2kk and
// 2kk + 1 (the C layout of keys 16kk.. is the A layout), split in two.
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&big)[4], uint32_t (&small)[4]) {
  split_bf16(c0[0], c0[1], big[0], small[0]);
  split_bf16(c0[2], c0[3], big[1], small[1]);
  split_bf16(c1[0], c1[1], big[2], small[2]);
  split_bf16(c1[2], c1[3], big[3], small[3]);
}

// c += A . B, m16n8k16, bf16 in, f32 accumulate.  Fragments (g = lane / 4,
// t = lane % 4): A a0 (g, 2t..2t+1), a1 (g + 8, ..), a2 (g, 2t+8..), a3
// (g + 8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); C c0, c1
// (g, 2t + {0, 1}), c2, c3 (g + 8, ..).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0.. and columns k0.. of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int pitch,
                                       int r0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * pitch + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 8);
}

// The B fragment of X^T (k = X's columns k0.., n = X's rows n0..): pairs
// along X's rows, two 32-bit loads.
__device__ __forceinline__ void frag_bt(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                        int pitch, int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (n0 + g) * pitch + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The B fragment of X itself (k = X's rows k0..k0+15, n = X's columns
// n0..n0+7): ldmatrix.trans of two 8 x 8 blocks, lane l naming row k0 + l
// (lanes 16-31 repeat 0-15).
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                       int pitch, int k0, int n0, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(tile + (k0 + (lane & 15)) * pitch + n0)));
}

// Rows [row0, row0 + n) of one head into a bf16 tile, 16 bytes a copy
// (the wrapper checks that rows and strides are 16-byte multiples); rows
// past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile_mma(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long row0, int n, long long S, long long rs) {
  constexpr int P = SmemMma<D>::kPitch;
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < n * CH; e += kThreadsMma) {
    const int r = e / CH;
    const int c = e - r * CH;
    const long long row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(src + row * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * P + c * 8) = val;
  }
}

// lse (times log2 e, for exp2) and D of n query rows; 0 past S (masked).
__device__ __forceinline__ void load_rows_mma(float* lse_s, float* delta_s, const float* lse,
                                              const float* delta, long long row0, int n,
                                              long long S) {
  for (int r = threadIdx.x; r < n; r += kThreadsMma) {
    const long long row = row0 + r;
    lse_s[r] = row < S ? lse[row] * kLog2eBwd : 0.f;
    delta_s[r] = row < S ? delta[row] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
    flash_attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v,
                                        const __nv_bfloat16* __restrict__ g,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        __nv_bfloat16* __restrict__ dk,
                                        __nv_bfloat16* __restrict__ dv, long long S, int H,
                                        int Hkv, int causal, float scale, Strides st) {
  using Sm = SmemMma<D>;
  constexpr int P = Sm::kPitch;
  constexpr int ND = D / 8;  // n-blocks of dh
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vt = kt + Sm::kTile;
  __nv_bfloat16* qt = vt + Sm::kTile;
  __nv_bfloat16* gt = qt + Sm::kTile;
  float* lse_s = reinterpret_cast<float*>(gt + Sm::kTile);
  float* delta_s = lse_s + kOwnMma;

  const int j = blockIdx.x;
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int kr = 16 * warp;  // the warp's first key in the tile
  const long long k0 = (long long)j * kOwnMma;
  const int n_q = (int)((S + kQStepMma - 1) / kQStepMma);
  const float scale_log2 = scale * kLog2eBwd;

  load_tile_mma<D>(kt, k + b * st.kb + (long long)hk * st.kh, k0, kOwnMma, S, st.ks);
  load_tile_mma<D>(vt, v + b * st.vb + (long long)hk * st.vh, k0, kOwnMma, S, st.vs);
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const __nv_bfloat16* qh = q + b * st.qb + (long long)h * st.qh;
    const __nv_bfloat16* gh = g + b * st.gb + (long long)h * st.gh;
    const float* lse_h = lse + (b * H + h) * S;
    const float* delta_h = delta + (b * H + h) * S;
    for (int i = first_query_tile(j, causal, kOwnMma / kQStepMma); i < n_q; ++i) {
      const long long q0 = (long long)i * kQStepMma;
      __syncthreads();  // the last tile's readers are done
      load_tile_mma<D>(qt, qh, q0, kQStepMma, S, st.qs);
      load_tile_mma<D>(gt, gh, q0, kQStepMma, S, st.gs);
      load_rows_mma(lse_s, delta_s, lse_h, delta_h, q0, kQStepMma, S);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries, 4 n-tiles
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, kt, P, kr, 16 * kk, gr, t);
        frag_a(av, vt, P, kr, 16 * kk, gr, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b0, b1;
          frag_bt(b0, b1, qt, P, 8 * n, 16 * kk, gr, t);
          mma_bf16(s[n], ak, b0, b1);
          frag_bt(b0, b1, gt, P, 8 * n, 16 * kk, gr, t);
          mma_bf16(dp[n], av, b0, b1);
        }
      }
      // P^T and dS^T: keys k0 + kr + gr (+ 8), queries q0 + 8n + 2t (+ 1)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long key = k0 + kr + gr + 8 * (e >> 1);
          const int qc = 8 * n + 2 * t + (e & 1);
          const long long row = q0 + qc;
          const bool valid = row < S && key < S && (!causal || key <= row);
          const float p = valid ? exp2f(fmaf(s[n][e], scale_log2, -lse_s[qc])) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_s[qc]);
        }
      // dV += P^T dO, dK += dS^T Q over the 32 queries: 2 k-steps
#pragma unroll
      for (int kq = 0; kq < kQStepMma / 16; ++kq) {
        const uint32_t ap[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                                pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                                pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                                pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
        uint32_t as[4], as_lo[4];
        split_frag(dp[2 * kq], dp[2 * kq + 1], as, as_lo);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          frag_b(b0, b1, gt, P, 16 * kq, 8 * n, lane);
          mma_bf16(acc_v[n], ap, b0, b1);
          frag_b(b0, b1, qt, P, 16 * kq, 8 * n, lane);
          mma_bf16(acc_k[n], as_lo, b0, b1);
          mma_bf16(acc_k[n], as, b0, b1);
        }
      }
    }
  }

  // dK, dV [B, S, Hkv, D] contiguous: rows k0 + kr + gr (+ 8), columns 8n + 2t
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long key = k0 + kr + gr + 8 * half;
    if (key >= S) continue;
    const long long at = ((b * S + key) * Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
          pack_bf16(acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          pack_bf16(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
    flash_attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v,
                                      const __nv_bfloat16* __restrict__ g,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      __nv_bfloat16* __restrict__ dq, long long S, int H, int Hkv,
                                      int causal, float scale, Strides st) {
  using Sm = SmemMma<D>;
  constexpr int P = Sm::kPitch;
  constexpr int ND = D / 8;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* gt = qt + Sm::kTile;
  __nv_bfloat16* kt = gt + Sm::kTile;
  __nv_bfloat16* vt = kt + Sm::kTile;
  float* lse_s = reinterpret_cast<float*>(vt + Sm::kTile);
  float* delta_s = lse_s + kOwnMma;

  const int i = (int)(gridDim.x - 1 - blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int qr = 16 * warp;  // the warp's first query row in the tile
  const long long q0 = (long long)i * kOwnMma;
  const long long kv_end = causal ? (q0 + kOwnMma < S ? q0 + kOwnMma : S) : S;
  const int n_k = (int)((kv_end + kKStepMma - 1) / kKStepMma);
  const float scale_log2 = scale * kLog2eBwd;

  load_tile_mma<D>(qt, q + b * st.qb + (long long)h * st.qh, q0, kOwnMma, S, st.qs);
  load_tile_mma<D>(gt, g + b * st.gb + (long long)h * st.gh, q0, kOwnMma, S, st.gs);
  load_rows_mma(lse_s, delta_s, lse + (b * H + h) * S, delta + (b * H + h) * S, q0, kOwnMma,
                S);
  const __nv_bfloat16* kh = k + b * st.kb + (long long)hk * st.kh;
  const __nv_bfloat16* vh = v + b * st.vb + (long long)hk * st.vh;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt < n_k; ++jt) {
    const long long k0 = (long long)jt * kKStepMma;
    __syncthreads();  // the last tile's readers are done (and Q, dO, lse have landed)
    load_tile_mma<D>(kt, kh, k0, kKStepMma, S, st.ks);
    load_tile_mma<D>(vt, vh, k0, kKStepMma, S, st.vs);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys, 8 n-tiles
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a(aq, qt, P, qr, 16 * kk, gr, t);
      frag_a(ag, gt, P, qr, 16 * kk, gr, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, kt, P, 8 * n, 16 * kk, gr, t);
        mma_bf16(s[n], aq, b0, b1);
        frag_bt(b0, b1, vt, P, 8 * n, 16 * kk, gr, t);
        mma_bf16(dp[n], ag, b0, b1);
      }
    }
    // dS: rows q0 + qr + gr (+ 8), keys k0 + 8n + 2t (+ 1)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qr + gr + 8 * (e >> 1);
        const long long row = q0 + r;
        const long long key = k0 + 8 * n + 2 * t + (e & 1);
        const bool valid = row < S && key < S && (!causal || key <= row);
        const float p = valid ? exp2f(fmaf(s[n][e], scale_log2, -lse_s[r])) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta_s[r]);
      }
    // dQ += dS K over the 64 keys: 4 k-steps
#pragma unroll
    for (int kk = 0; kk < kKStepMma / 16; ++kk) {
      uint32_t as[4], as_lo[4];
      split_frag(dp[2 * kk], dp[2 * kk + 1], as, as_lo);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, kt, P, 16 * kk, 8 * n, lane);
        mma_bf16(acc[n], as_lo, b0, b1);
        mma_bf16(acc[n], as, b0, b1);
      }
    }
  }

  // dQ [B, S, H, D] contiguous
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = q0 + qr + gr + 8 * half;
    if (row >= S) continue;
    const long long at = ((b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * n) =
          pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// D, then dK/dV, then dQ on one stream: f32 on the FMA kernels, bf16 on the
// mma.sync ones.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* g,
           const float* lse, float* delta, void* dq, void* dk, void* dv, long long B,
           long long S, int H, int Hkv, int causal, const Strides& st, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int smem = kMma ? SmemMma<D>::kBytes : Smem<D>::kBytes;
  constexpr int threads = kMma ? kThreadsMma : kThreads;
  auto dkdv = [] {
    if constexpr (kMma) return flash_attention_bwd_dkdv_mma_kernel<D>;
    else return flash_attention_bwd_dkdv_kernel<T, D>;
  }();
  auto dqk = [] {
    if constexpr (kMma) return flash_attention_bwd_dq_mma_kernel<D>;
    else return flash_attention_bwd_dq_kernel<T, D>;
  }();
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)D);
  const unsigned tiles = (unsigned)((S + kTile - 1) / kTile);  // kTile = kOwnMma = 64
  const dim3 grid_rows((unsigned)((S + kThreads / 32 - 1) / (kThreads / 32)), (unsigned)H,
                       (unsigned)B);
  flash_attention_bwd_delta_kernel<T, D><<<grid_rows, kThreads, 0, stream>>>(
      (const T*)o, (const T*)g, delta, S, H, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(tiles, (unsigned)Hkv, (unsigned)B), threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, delta, (T*)dk, (T*)dv, S, H, Hkv,
      causal, scale, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(tiles, (unsigned)H, (unsigned)B), threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, delta, (T*)dq, S, H, Hkv, causal,
      scale, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
             const float* lse, float* delta, void* dq, void* dk, void* dv, long long B,
             long long S, int H, int Hkv, int D, int causal, const long long* strides,
             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || S > kMaxSeq) return (int)cudaErrorInvalidValue;
  Strides st;
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  st.gb = strides[12]; st.gs = strides[13]; st.gh = strides[14];
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {  // f32 takes the small head dims too
    switch (D) {
      case 16: return launch<T, 16>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
      case 32: return launch<T, 32>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
      default: break;
    }
  }
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 80: return launch<T, 80>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 96: return launch<T, 96>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 128: return launch<T, 128>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, S, Hkv, D], o and g (dL/do) [B, S, H, D], one
// dtype, by the 15 element strides (b, s, h) of q, k, v, o, g in `strides`,
// the last dim contiguous; lse [B, H, S] f32 (K6's row logsumexp); delta a
// [B, H, S] f32 scratch; dq [B, S, H, D], dk and dv [B, S, Hkv, D] contiguous
// outputs in q's dtype.  D in {16, 32, 64, 80, 96, 128} for f32 and {64, 80,
// 96, 128} for bf16.  Three launches on `stream`; returns the first nonzero
// cudaGetLastError(), else 0.
int flash_attention_backward_f32(const void* q, const void* k, const void* v, const void* o,
                                 const void* g, const float* lse, float* delta, void* dq,
                                 void* dk, void* dv, long long B, long long S, int H, int Hkv,
                                 int D, int causal, const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, D, causal,
                         strides, stream);
}

int flash_attention_backward_bf16(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const float* lse, float* delta, void* dq,
                                  void* dk, void* dv, long long B, long long S, int H, int Hkv,
                                  int D, int causal, const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, g, lse, delta, dq, dk, dv, B, S, H, Hkv, D, causal,
                                 strides, stream);
}

const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
