// A design of K6' bf16 that was timed and lost, kept for repeating the
// turns: python3 tools/kernel_variants.py --against
// tools/kernel_variants/k6b_onepass tools/kernel_variants/turns_k6b.json
// runs it (through its own wrapper, ../kernels/flash_attention.py, whose
// scratch it needs) beside the committed source.  Not built by the package.
//
// One pass instead of two: a persistent, cooperatively launched grid walks
// units of 128 keys of one (b, KV head), key tiles in descending order
// (BwdWalk); each step forms S^T, dP^T, P^T and dS^T as the two-pass dK/dV
// loop does, stores P^T and dS^T's two bf16 parts to shared memory, and
// runs dV and dK (this warpgroup's 64 keys) and dQ (the step's 64 query rows
// over all 128 keys, each warpgroup a region-aligned half of dh's columns:
// DqSplit) from there, seven products a kept pair instead of nine.  A
// step's dQ partial goes through a staging buffer to writer threads that
// add it to an f32 sum [B, H, n_q, 64 x dh] by cp.reduce.async.bulk in a
// fixed order of key tiles, one u32 turn per (b, head, query step) with
// acquire and release (dq_turn); a last launch converts the sum to dq.
// With one key tile (S <= 128) the consumers write dq themselves.  Every
// turn waits on an earlier unit of the walk and every CTA is resident, so
// the earliest unfinished unit can always go on.  Bit-equal across
// launches and within tolerance at every shape checked; slower than the
// two-pass design at stablelm-3b's layer (2.56 against 1.93 ms on an
// NVIDIA H100 80GB HBM3 at 700 W): the two warpgroups must meet twice a
// step to exchange dS, so neither's elementwise work overlaps the other's
// products, every product reads its A operand from shared memory, and
// the pipelined loop spills (PERF.md, PR 36).
//
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
// (query, key) pair kept (S, dP, dV, dK, dQ; both designs recompute S and
// dP once more in the dQ pass: seven, and in bf16 run dK and dQ twice, nine),
// against 2 dh elements of K and V a key
// and 3 dh of q, o, do a query row, so at S = 4096 it does thousands of FLOP
// per byte: far above the ridge.
//
// What the design does about it.  Both dtypes: three launches, D (a warp a
// row), dK/dV with one CTA per (b, KV head, key tile) looping over the
// group's query heads in order and over the query tiles at or after the key
// tile (first_query_tile) when causal, and dQ with one CTA per (b, head,
// query tile) looping over the key tiles up to its diagonal.  Each output
// element is owned by one thread of one CTA and summed in a fixed order: no
// atomics, two launches give equal bits (a training resume stays
// bit-equal).  P is recomputed from q, k and lse in both passes; dP from do
// and v.  Any S: rows and keys past S load as zeros and are masked; rows
// past S are not stored.
//
// bf16 on Hopper (FlashAttention-3's shape, without its atomics; the
// section "bf16 on wgmma" below):
//  * A warp-specialised CTA of 384 threads owns 128 rows: keys in the dK/dV
//    pass, query rows in the dQ pass, 64 for each of two consumer
//    warpgroups.  One thread of the producer warpgroup loads the CTA's two
//    owned tiles (K and V, or Q and dO) once by TMA and streams the other
//    two (Q and dO in query tiles of 64, or K and V in key tiles of 64)
//    through a ring of 2 stages with full and empty mbarriers.  The dK/dV
//    consumers read each step's lse (times log2 e) and D into a
//    per-warpgroup shared buffer a step ahead; the dQ consumers read their
//    two rows' once.
//  * dK/dV, a consumer warpgroup a step: S^T = K Q^T and dP^T = V dO^T are
//    wgmma with both operands in shared memory, K-major (m64n64, dh / 16
//    k-steps); P^T and dS^T are formed in registers on the accumulator
//    layout while dP^T still runs, and pack into the register A fragment of
//    the next products (as K6's P does): dV += P^T dO and dK += dS^T Q are
//    wgmma with A from registers and dO, Q read MN-major through the
//    descriptor's transpose bit.  dQ: S = Q K^T, dP = dO V^T shared-shared,
//    dS in registers, dQ += dS K with K MN-major.
//  * Numerics as the mma.sync design before it: P rounded to bf16 for dV
//    (as K6's P . V takes it); dS as two bf16 parts, hi = bf16(dS) and lo =
//    bf16(dS - hi), each product run twice, lo first (rounded once, dS put
//    dq 1.56e-2 off the f32 plain version at stablelm's layer, PERF.md);
//    every sum f32.  This design still forms S and dP in both passes and
//    runs dK and dQ twice: nine products a kept pair against the bound's
//    five.
//  * Causal: only the diagonal and ragged tiles mask; a warpgroup skips a
//    step that is wholly masked for it (the other warpgroup's keys or rows
//    need the tile), and no tile that both skip is loaded.  Longest work
//    first: key tile 0 first in dK/dV, the last query tile first in dQ.
//
// Where the trouble was, and how it was met:
//  * Registers.  dK and dV of 64 keys at dh 128 are 128 f32 a thread beside
//    S^T and dP^T (64): past the 168 that a CTA of 288 or 384 threads
//    gives each thread (an SM's four schedulers each hold a quarter of the
//    register file and a CTA's warps go to them in turn, so a producer
//    warp beside 8 consumer warps costs a warpgroup's registers; a launch
//    at 184-202 was refused).  setmaxnreg moves the producer warpgroup's
//    registers to the consumers (40 and 232, K6's split), but ptxas gives
//    the code after setmaxnreg.inc its registers only when no trap sits in
//    it inline: with hopper::mbar_wait's inline trap dK/dV spilled 52-1016
//    bytes at dh 80-128 and ptxas serialised its wgmma (C7512); with the
//    trap out of line (hopper::mbar_wait<true>) nothing spills.  Without
//    a producer (256 threads, thread 0 issuing the loads between its own
//    products) nothing spilled either, but it ran 1.33x slower at
//    stablelm's layer.
//  * One tile, two majors.  Q and dO (dK/dV) and K (dQ) are read K-major by
//    one product and MN-major by another, from one layout: 64-column
//    regions with a 128-byte swizzle (and dh 96's last 32 columns with a
//    64-byte one), or at dh 80 five 16-column regions with a 32-byte
//    swizzle (K6 keeps its V so): a K-major k-step is 32 bytes of each row
//    of one region, an MN-major k-step 16 whole rows of every region.  dh 16
//    is dh 80's layout with one region, dh 32 dh 96's last region alone
//    (64-byte rows and swizzle); neither has a 64-column region or map.
//  * Product shapes: shared-shared m64n64 (new in hopper.cuh) and
//    register-A n64, n32, n16 and n80.
//  * Tensor maps: tensor_map.cuh, shared with K6.
//
// f32 on the tensor cores ("3xTF32", the section "f32 on mma.sync" below).
// The reference holds f32 attention to 2e-5, which one TF32 product misses;
// K6's f32 kernel (flash_attention.cu) meets it with three.  The same here,
// in all seven products of both passes:
//  * Every operand is split once as it leaves shared memory or an
//    accumulator, x = big + small (hopper::split_tf32), and a product is
//    small . big + big . small + big . big on mma.sync.m16n8k8
//    (hopper::mma_3xtf32).  Each k-step's three products are summed in a
//    fresh accumulator that one f32 add then adds to the product's sum
//    (add4): the tensor core does not round its own additions to nearest,
//    and a dK summed in the mma across 4,096 query rows drifted ten times
//    past 2e-5 (tests/test_torch_k6b_f32_plan.py models it as truncation).
//  * mma.sync, not wgmma: tf32 wgmma reads only K-major operands from
//    shared memory, and four of the seven products read a tile MN-major
//    (dV, dK: dO and Q with their rows as the reduction; dQ: K), which would
//    each need a transposed copy.  mma.sync's fragments are loaded by hand
//    in either direction.
//  * A CTA of 8 warps owns 128 rows (keys in dK/dV, query rows in dQ), 16 a
//    warp, in shared memory; the other two tiles stream in steps of 64 rows
//    (32 at dh 128, where 64 would not fit beside the owned tiles) through a
//    2-stage cp.async ring (zero-filled past S), the next step's copy under
//    this step's products.  The dK/dV ring also carries the step's rows'
//    lse and D.
//  * Registers.  A dK/dV lane holds dK and dV (dh floats) for the whole
//    loop, a dQ lane dQ (dh / 2).  So a warp takes a step in sub-steps, 16
//    query rows in dK/dV and 32 keys in dQ, each with its own S and dP, and
//    dK/dV forms P^T and runs dV before it forms dP^T; a product runs its
//    head dims in a loop that is not unrolled (product_nt) or n-tiles four
//    at a time (product_nn).  Larger sub-steps, dP^T formed beside S^T or
//    these loops unrolled held ptxas past 255 registers and spilled
//    (PERF.md).
//  * dQ: S = Q K^T and dP = dO V^T (A from the owned tiles, B a streamed
//    tile's rows), P and dS on the accumulators, dQ += dS K.  dK/dV: S^T =
//    K Q^T and P^T, dV += P^T dO, then dP^T = V dO^T, dS^T and dK += dS^T
//    Q.  As in K6
//    f32, the first products' k-steps take head dims 16p + 4t + {0,1} and
//    {2,3}, so both operands load as 16-byte pieces, and the second
//    products' k-step j takes rows 8j + 2t and 8j + 2t + 1 as columns t and
//    t + 4, so the accumulator of the first is the A fragment of the second
//    as it stands (no shuffle).
//  * One tile, two reads.  Q and dO (dK/dV) and K (dQ) are read as
//    16-byte pieces of rows 8j + g (the first products) and as single
//    floats of rows 8j + 2t, 8j + 2t + 1 at column 8n + g (the second); no
//    pitch is free of bank conflicts for both (K6 f32 gives its K and V
//    pitches of 16 and 4 mod 32).  Every tile is stored at a pitch of dh
//    rounded up to 32 floats with column c of row r at c ^ swz(r), an XOR
//    of column bits 3 and 4 by row bits 0-2: each 8-lane phase of a 16-byte
//    read and each scalar read then meets 32 different banks
//    (tests/test_torch_k6b_f32_plan.py counts them).
//  * Causal: a warp skips a sub-step wholly masked for it; the loops stop
//    at the CTA's diagonal (dQ) or start at it (dK/dV, first_query_tile).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <type_traits>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using tensor_map::kEncodeError;
using tensor_map::make_map;

constexpr int kThreads = 256;  // the D and dq kernels'
constexpr long long kMaxSeq = (1LL << 31) - 256;  // positions are int32
constexpr float kLog2eBwd = 1.4426950408889634f;
// Query rows a bf16 step streams (the section "bf16 on wgmma").  32 at dh
// 128 ran 28% slower than 64 at olmoe's layer (0.964 against 0.751 ms) in
// the two-pass design.
constexpr int kQueryStep = 64;

struct Strides {  // element strides (b, s, h) of q, k, v, o, do
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The first query tile that key tile j's dK/dV loop visits (tiles of
// `ratio` query tiles a key tile): when causal, the first that holds a
// query at or after the key tile's first key; else the first.
__device__ __forceinline__ int first_query_tile(int j, int causal, int ratio) {
  return causal ? j * ratio : 0;
}

// The sum of the products of 16 bytes of a and b, in f32.
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xp[i]), v = __bfloat1622float2(yp[i]);
    acc = fmaf(u.y, v.y, fmaf(u.x, v.x, acc));
  }
  return acc;
}

// The D launch's plan: a row of dh values is D * sizeof(T) / 16 loads of 16
// bytes, taken by a group of kLanes lanes (the loads rounded up to a power
// of two), kRows rows a block.
template <typename T, int D>
struct DeltaPlan {
  static constexpr int kLoads = D * (int)sizeof(T) / 16;
  static constexpr int kLanes = kLoads <= 2 ? 2 : kLoads <= 4 ? 4 : kLoads <= 8 ? 8 : kLoads <= 16 ? 16 : 32;
  static constexpr int kRows = kThreads / kLanes;
};

// The forward's D = rowsum(do o) in f32: a group of DeltaPlan's lanes a
// (b, h, row), 16 bytes of o and do a load, then a butterfly in the group.
// delta is [B, H, S].  With `turns` (bf16 with more than one key tile), the
// first row of each query step of kQueryStep rows also zeroes its turn:
// [B, H, n_q], so nothing is left from an earlier call.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                     float* __restrict__ delta, long long S, int H,
                                     Strides st, uint32_t* __restrict__ turns, int n_q) {
  using P = DeltaPlan<T, D>;
  constexpr int V = 16 / (int)sizeof(T);  // elements a load
  const int lane = threadIdx.x % P::kLanes;
  const long long s = (long long)blockIdx.x * P::kRows + threadIdx.x / P::kLanes;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  float acc = 0.f;
  if (s < S) {
    const T* orow = o + b * st.ob + s * st.os + (long long)h * st.oh;
    const T* grow = g + b * st.gb + s * st.gs + (long long)h * st.gh;
    for (int c = lane; c < P::kLoads; c += P::kLanes) acc += dot16(orow + c * V, grow + c * V);
  }
#pragma unroll
  for (int off = P::kLanes / 2; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (s >= S || lane != 0) return;
  delta[(b * H + h) * S + s] = acc;
  if (turns != nullptr && s % kQueryStep == 0) turns[(b * H + h) * n_q + s / kQueryStep] = 0u;
}

// ----------------------------------------------------------- f32 on mma.sync
//
// The design note at the top ("f32 on the tensor cores").  Both passes are
// one CTA of kWarpsF32 warps: it owns kOwnF32 rows of two tiles (K and V in
// the dK/dV pass, Q and dO in the dQ pass), copied once, and streams the
// other two (Q and dO, or K and V) in steps of TileF32<D>::kStep rows
// through a ring of kStagesF32 stages, each taken in sub-steps.  Warp w
// owns rows 16w..16w+15 of the owned tiles; lane (g, t) = (lane / 4, lane %
// 4) holds, as mma.sync's m16n8 accumulator, rows g and g + 8 of them.

constexpr int kWarpsF32 = 8;
constexpr int kThreadsF32 = 32 * kWarpsF32;
constexpr int kOwnF32 = 16 * kWarpsF32;  // keys (dK/dV) or query rows (dQ) a CTA owns
constexpr int kStagesF32 = 2;  // the cp.async ring of the streamed tiles
// Rows of a streamed step that one pass of the products takes (a
// sub-step): a dK/dV warp holds dK and dV (dh floats a lane) beside its
// sub-step's S^T and dP^T, a dQ warp dQ (dh / 2) beside S and dP.  Larger
// sub-steps held ptxas past 255 registers (PERF.md).
constexpr int kSubKvF32 = 16;  // query rows, dK/dV
constexpr int kSubQF32 = 32;  // keys, dQ

// A tile of f32 rows in shared memory: a pitch of dh rounded up to 32
// floats (a row starts at bank 0), column c of row r at c ^ swz(r).
template <int D>
struct TileF32 {
  static constexpr int kStep = D > 96 ? 32 : 64;  // rows a step streams
  static constexpr int kLd = (D + 31) / 32 * 32;  // floats a row
  static constexpr int kOwn = kOwnF32 * kLd;  // floats of an owned tile
  static constexpr int kStepTile = kStep * kLd;  // floats of a streamed tile
  // A stage: the two streamed tiles, then (dK/dV) the step's rows' lse and D.
  static constexpr int kStage = 2 * kStepTile + 2 * kStep;
  static constexpr int kBytes = (2 * kOwn + kStagesF32 * kStage) * 4;
  static_assert(D % 16 == 0 && kBytes <= 232448, "dh in 16, 32, 64, 80, 96, 128");
  static_assert(kStep % kSubKvF32 == 0 && kStep % kSubQF32 == 0, "whole sub-steps");
};

// The XOR of a row's columns: bit 3 from row bit 1, bit 4 from row bits 0
// and 2.  A 16-byte read of rows 8j + g, g = 0..7, at columns 16p + 4t puts
// rows 2m and 2m + 1 (one 8-lane phase) in opposite halves of the 32 banks;
// a scalar read of rows 8j + 2t (or 8j + 2t + 1), t = 0..3, at columns
// 8n + g, g = 0..7, puts the four rows on four different 8-bank groups.
// Only bits 3 and 4 change, so a 16-byte piece stays whole and a row's
// columns stay below its pitch.
__device__ __forceinline__ int swz(int r) { return ((r & 2) << 2) | (((r >> 2 ^ r) & 1) << 4); }

// Rows row0..row0 + R - 1 of one head (src its row 0, rows rs floats apart)
// into the tile at dst by cp.async, 16 bytes a copy; rows past S are zeros.
template <int D, int R>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int row0, int S,
                                          long long rs) {
  constexpr int CH = D / 4;  // 16-byte pieces a row
  constexpr int Ld = TileF32<D>::kLd;
  for (int e = threadIdx.x; e < R * CH; e += kThreadsF32) {
    const int r = e / CH;
    const int c = 4 * (e - r * CH);
    const int row = row0 + r;
    const bool in = row < S;
    hopper::cp_async16(dst + r * Ld + (c ^ swz(r)), src + (long long)(in ? row : 0) * rs + c, in);
  }
}

// 4 bytes from global to shared memory (zero-filled when `full` is false).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// The ring's turn at step it of n: step it has landed (every thread's
// copies) and step it - 1's readers are done; then step it + kStagesF32 - 1
// goes into the stage that step it - 1 used.  The group is committed even
// when empty: the wait counts groups.
template <typename Load>
__device__ __forceinline__ void ring_turn(int it, int n, Load load) {
  hopper::cp_async_wait<kStagesF32 - 2>();
  __syncthreads();
  if (it + kStagesF32 - 1 < n) load(it + kStagesF32 - 1);
  hopper::cp_async_commit();
}

// c += part: a k-step's terms, summed apart, added to their sum with one
// f32 add each (rounded to nearest).  The tensor core does not round its own
// additions to nearest: with every k-step added in the mma itself, a dK sum
// over 4,096 query rows drifted to 2.2e-4 off the plain version (PERF.md),
// where each k-step's own terms summed apart stay within 2e-5.
__device__ __forceinline__ void add4(float* c, const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

// The A fragments of k-steps 2p and 2p + 1 (big and small parts) from the
// warp's 16 rows at x: rows g and g + 8, head dims 16p + 4t + {0, 1} as
// k-step 2p's columns t and t + 4, 16p + 4t + {2, 3} as k-step 2p + 1's;
// col is the lane's swizzled column of them.
__device__ __forceinline__ void a_frags(uint32_t (&ab)[2][4], uint32_t (&as)[2][4],
                                        const float* x0, const float* x1, int col) {
  const float4 xa = *reinterpret_cast<const float4*>(x0 + col);
  const float4 xb = *reinterpret_cast<const float4*>(x1 + col);
  hopper::split_tf32(xa.x, ab[0][0], as[0][0]);
  hopper::split_tf32(xb.x, ab[0][1], as[0][1]);
  hopper::split_tf32(xa.y, ab[0][2], as[0][2]);
  hopper::split_tf32(xb.y, ab[0][3], as[0][3]);
  hopper::split_tf32(xa.z, ab[1][0], as[1][0]);
  hopper::split_tf32(xb.z, ab[1][1], as[1][1]);
  hopper::split_tf32(xa.w, ab[1][2], as[1][2]);
  hopper::split_tf32(xb.w, ab[1][3], as[1][3]);
}

// c = X . Y^T over dh: X the warp's 16 rows at x, Y N rows of a tile at y
// (a streamed tile's rows, or keys); n-tile j of c holds Y's rows 8j..8j+7:
// c[4j], c[4j + 1] at (g, 8j + 2t + {0, 1}), c[4j + 2], c[4j + 3] at g + 8.
// The loop over dh is not unrolled: unrolled, it spilled (PERF.md).
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&c)[N / 2], const float* x, const float* y,
                                           int lane) {
  constexpr int Ld = TileF32<D>::kLd;
  const int g = lane >> 2;
  // Column 16p + 4t of a row 8j + g sits at 32 (p / 2) + col[p % 2].
  const int col0 = (4 * (lane & 3)) ^ swz(g), col1 = (16 + 4 * (lane & 3)) ^ swz(g);
  const float* x0 = x + g * Ld;
  const float* y0 = y + g * Ld;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
#pragma unroll 1
  for (int p = 0; p < D / 16; ++p) {
    const int col = 32 * (p >> 1) + ((p & 1) ? col1 : col0);
    uint32_t ab[2][4], as[2][4];
    a_frags(ab, as, x0, x0 + 8 * Ld, col);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(y0 + 8 * j * Ld + col);
      uint32_t bb[4], bs[4];
      hopper::split_tf32(yv.x, bb[0], bs[0]);
      hopper::split_tf32(yv.y, bb[1], bs[1]);
      hopper::split_tf32(yv.z, bb[2], bs[2]);
      hopper::split_tf32(yv.w, bb[3], bs[3]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};  // k-steps 2p and 2p + 1, summed apart
      hopper::mma_3xtf32(part, ab[0], as[0], bb[0], bb[1], bs[0], bs[1]);
      hopper::mma_3xtf32(part, ab[1], as[1], bb[2], bb[3], bs[2], bs[3]);
      add4(&c[4 * j], part);
    }
  }
}

// n-tiles of acc that product_nn runs at once: all of them spilled in the
// dK/dV kernel (PERF.md).
constexpr int kNnChunk = 4;

// acc += M . Y: M (16 x N) an accumulator of product_nt (P, dS, P^T or
// dS^T), Y N rows x dh of a tile at y.  k-step j takes M's columns 8j + 2t
// and 8j + 2t + 1 as its columns t and t + 4, so its A fragment is c[4j],
// c[4j + 2], c[4j + 1], c[4j + 3] as they stand, and Y's B fragment is rows
// 8j + 2t and 8j + 2t + 1 at column 8n + g.  n-tile n of acc holds head dims
// 8n..8n+7: acc[4n], acc[4n + 1] at (g, 8n + 2t + {0, 1}), the next two at
// g + 8.
template <int D, int N>
__device__ __forceinline__ void product_nn(float (&acc)[D / 2], const float (&m)[N / 2],
                                           const float* y, int lane) {
  constexpr int Ld = TileF32<D>::kLd;
  const int g = lane >> 2;
  const int t = lane & 3;
  // Column 8n + g of rows 8j + 2t and 8j + 2t + 1 sits at 32 (n / 4) +
  // col0[n % 4] and 32 (n / 4) + col1[n % 4].
  int col0[4], col1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    col0[i] = (8 * i + g) ^ swz(2 * t);
    col1[i] = (8 * i + g) ^ swz(2 * t + 1);
  }
  const float* y0 = y + 2 * t * Ld;
  const float* y1 = y0 + Ld;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kNnChunk)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t ab[4], as[4];
      hopper::split_tf32(m[4 * j], ab[0], as[0]);
      hopper::split_tf32(m[4 * j + 2], ab[1], as[1]);
      hopper::split_tf32(m[4 * j + 1], ab[2], as[2]);
      hopper::split_tf32(m[4 * j + 3], ab[3], as[3]);
#pragma unroll
      for (int n = n0; n < (n0 + kNnChunk < D / 8 ? n0 + kNnChunk : D / 8); ++n) {
        const int at = 8 * j * Ld + 32 * (n >> 2);
        uint32_t bb0, bs0, bb1, bs1;
        hopper::split_tf32(y0[at + col0[n & 3]], bb0, bs0);
        hopper::split_tf32(y1[at + col1[n & 3]], bb1, bs1);
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // k-step j, summed apart
        hopper::mma_3xtf32(part, ab, as, bb0, bb1, bs0, bs1);
        add4(&acc[4 * n], part);
      }
    }
}

// dK and dV: a CTA per (kOwnF32 keys, KV head, b), warp w owning keys
// 16w.. of them; the steps are the group's query heads in order and, within
// each, the query tiles of QS rows from first_query_tile on, each taken in
// sub-steps of SUB rows.
template <int D>
__global__ void __launch_bounds__(kThreadsF32, 1)
    flash_attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, const float* __restrict__ g,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, float* __restrict__ dk,
                                        float* __restrict__ dv, long long S_, int H, int Hkv,
                                        int causal, float scale, Strides st) {
  using Ty = TileF32<D>;
  constexpr int QS = Ty::kStep;
  constexpr int SUB = kSubKvF32;
  constexpr int Ld = Ty::kLd;
  extern __shared__ uint4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int S = (int)S_;  // positions fit in 32 bits (S <= kMaxSeq)
  const int j = blockIdx.x;  // key tile: the first has the most query tiles
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = j * kOwnF32;
  const int n_q = (S + QS - 1) / QS;
  const int first = first_query_tile(j, causal, kOwnF32 / QS);
  const int per_head = n_q > first ? n_q - first : 0;
  const int n_steps = group * per_head;
  float* stages = sm + 2 * Ty::kOwn;
  auto load_step = [&](int it) {  // query head, query tile; the rows' lse and D
    const int h = hk * group + it / per_head;
    const int q0 = (first + it % per_head) * QS;
    float* s_ = stages + (it % kStagesF32) * Ty::kStage;
    copy_tile<D, QS>(s_, q + b * st.qb + (long long)h * st.qh, q0, S, st.qs);
    copy_tile<D, QS>(s_ + Ty::kStepTile, g + b * st.gb + (long long)h * st.gh, q0, S, st.gs);
    const long long at = (b * H + h) * S;
    for (int e = threadIdx.x; e < 2 * QS; e += kThreadsF32) {
      const int r = e % QS;
      const bool in = q0 + r < S;
      cp_async4(s_ + 2 * Ty::kStepTile + e, (e < QS ? lse : delta) + at + (in ? q0 + r : 0), in);
    }
  };
  copy_tile<D, kOwnF32>(sm, k + b * st.kb + (long long)hk * st.kh, k0, S, st.ks);
  copy_tile<D, kOwnF32>(sm + Ty::kOwn, v + b * st.vb + (long long)hk * st.vh, k0, S, st.vs);
#pragma unroll
  for (int s = 0; s < kStagesF32 - 1; ++s) {  // the owned tiles ride in the first group
    if (s < n_steps) load_step(s);
    hopper::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int kw0 = k0 + 16 * warp;  // this warp's first key
  const int key_a = kw0 + (lane >> 2);  // accumulator rows key_a, key_a + 8
  const float scale_log2 = scale * kLog2eBwd;
  const float* k_w = sm + 16 * warp * Ld;
  const float* v_w = sm + Ty::kOwn + 16 * warp * Ld;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    ring_turn(it, n_steps, load_step);
    const float* stage = stages + (it % kStagesF32) * Ty::kStage;
    const int q0 = (first + it % per_head) * QS;
#pragma unroll 1
    for (int r0 = q0; r0 < q0 + QS; r0 += SUB) {
      // Wholly masked for this warp: its keys or the sub-step's rows past
      // S, or every query of the sub-step before its first key.
      if (kw0 >= S || r0 >= S || (causal && r0 + SUB - 1 < kw0)) continue;
      const float* q_s = stage + (r0 - q0) * Ld;
      const float* g_s = q_s + Ty::kStepTile;
      const float* lse_s = stage + 2 * Ty::kStepTile + (r0 - q0);
      const float* delta_s = lse_s + QS;
      float sc[SUB / 2], dp[SUB / 2];  // S^T, then P^T; dP^T, then dS^T
      product_nt<D, SUB>(sc, k_w, q_s, lane);
      const bool masked = r0 + SUB > S || kw0 + 16 > S || (causal && r0 < kw0 + 15);
      // P^T: keys key_a (+ 8) x queries r0 + 8c + 2 t4 (+ 1)
#pragma unroll
      for (int c = 0; c < SUB / 8; ++c) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = hopper::ex2(
              fmaf(sc[4 * c + e], scale_log2, -kLog2eBwd * ((e & 1) ? l.y : l.x)));
          if (masked) {
            const int key = key_a + 8 * (e >> 1);
            const int query = r0 + 8 * c + 2 * t4 + (e & 1);
            if (query >= S || key >= S || (causal && key > query)) p = 0.f;
          }
          sc[4 * c + e] = p;
        }
      }
      product_nn<D, SUB>(acc_v, sc, g_s, lane);  // dV += P^T dO
      product_nt<D, SUB>(dp, v_w, g_s, lane);
#pragma unroll
      for (int c = 0; c < SUB / 8; ++c) {  // dS^T; a masked p is 0: so is its dS
        const float2 dd = *reinterpret_cast<const float2*>(delta_s + 8 * c + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * c + e] = sc[4 * c + e] * (dp[4 * c + e] - ((e & 1) ? dd.y : dd.x));
      }
      product_nn<D, SUB>(acc_k, dp, q_s, lane);  // dK += dS^T Q
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  // dK, dV [B, S, Hkv, D] contiguous: rows key_a (+ 8), columns 8n + 2 t4
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= S) continue;
    const long long at = ((b * S + key) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(acc_k[4 * n + 2 * half] * scale, acc_k[4 * n + 2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(acc_v[4 * n + 2 * half], acc_v[4 * n + 2 * half + 1]);
    }
  }
}

// dQ: a CTA per (kOwnF32 query rows, head, b), longest first, warp w owning
// rows 16w.. of them; the steps are the key tiles of KS keys up to the CTA's
// diagonal, each taken in sub-steps of SUB keys.
template <int D>
__global__ void __launch_bounds__(kThreadsF32, 1)
    flash_attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v, const float* __restrict__ g,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, float* __restrict__ dq,
                                      long long S_, int H, int Hkv, int causal, float scale,
                                      Strides st) {
  using Ty = TileF32<D>;
  constexpr int KS = Ty::kStep;
  constexpr int SUB = kSubQF32;
  constexpr int Ld = Ty::kLd;
  extern __shared__ uint4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int S = (int)S_;
  const int i = (int)(gridDim.x - 1 - blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = i * kOwnF32;
  const int kv_end = causal ? (q0 + kOwnF32 < S ? q0 + kOwnF32 : S) : S;
  const int n_k = (kv_end + KS - 1) / KS;
  const float* kh = k + b * st.kb + (long long)hk * st.kh;
  const float* vh = v + b * st.vb + (long long)hk * st.vh;
  float* stages = sm + 2 * Ty::kOwn;
  auto load_step = [&](int it) {
    float* s_ = stages + (it % kStagesF32) * Ty::kStage;
    copy_tile<D, KS>(s_, kh, it * KS, S, st.ks);
    copy_tile<D, KS>(s_ + Ty::kStepTile, vh, it * KS, S, st.vs);
  };
  copy_tile<D, kOwnF32>(sm, q + b * st.qb + (long long)h * st.qh, q0, S, st.qs);
  copy_tile<D, kOwnF32>(sm + Ty::kOwn, g + b * st.gb + (long long)h * st.gh, q0, S, st.gs);
#pragma unroll
  for (int s = 0; s < kStagesF32 - 1; ++s) {  // the owned tiles ride in the first group
    if (s < n_k) load_step(s);
    hopper::cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int qw0 = q0 + 16 * warp;  // this warp's first query row
  const int row_a = qw0 + (lane >> 2);  // accumulator rows row_a, row_a + 8
  const float scale_log2 = scale * kLog2eBwd;
  const float* q_w = sm + 16 * warp * Ld;
  const float* g_w = sm + Ty::kOwn + 16 * warp * Ld;
  float lse_r[2], delta_r[2];  // the two rows' lse (times log2 e) and D; 0 past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const long long at = (b * H + h) * S + row;
    lse_r[r] = row < S ? lse[at] * kLog2eBwd : 0.f;
    delta_r[r] = row < S ? delta[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  for (int jt = 0; jt < n_k; ++jt) {
    ring_turn(jt, n_k, load_step);
    const float* stage = stages + (jt % kStagesF32) * Ty::kStage;
#pragma unroll 1
    for (int k0 = jt * KS; k0 < (jt + 1) * KS; k0 += SUB) {
      // Wholly masked for this warp: its rows or the sub-step's keys past
      // S, or every key of the sub-step after its last row.
      if (qw0 >= S || k0 >= S || (causal && k0 > qw0 + 15)) continue;
      const float* k_s = stage + (k0 - jt * KS) * Ld;
      const float* v_s = k_s + Ty::kStepTile;
      float sc[SUB / 2], dp[SUB / 2];  // S, then P; dP, then dS
      product_nt<D, SUB>(sc, q_w, k_s, lane);
      product_nt<D, SUB>(dp, g_w, v_s, lane);
      const bool masked = k0 + SUB > S || qw0 + 16 > S || (causal && k0 + SUB - 1 > qw0);
      // P and dS: rows row_a (+ 8) x keys k0 + 8c + 2 t4 (+ 1)
#pragma unroll
      for (int c = 0; c < SUB / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = hopper::ex2(fmaf(sc[4 * c + e], scale_log2, -lse_r[e >> 1]));
          if (masked) {
            const int row = row_a + 8 * (e >> 1);
            const int key = k0 + 8 * c + 2 * t4 + (e & 1);
            if (row >= S || key >= S || (causal && key > row)) p = 0.f;
          }
          dp[4 * c + e] = p * (dp[4 * c + e] - delta_r[e >> 1]);  // dS; 0 where masked
        }
      product_nn<D, SUB>(acc, dp, k_s, lane);  // dQ += dS K
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  // dQ [B, S, H, D] contiguous: rows row_a (+ 8), columns 8n + 2 t4
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= S) continue;
    const long long at = ((b * S + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dq + at + 8 * n) =
          make_float2(acc[4 * n + 2 * half] * scale, acc[4 * n + 2 * half + 1] * scale);
  }
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

// ---------------------------------------------------------- bf16 on wgmma
//
// The design note at the top ("bf16 on Hopper").  One persistent,
// warp-specialised kernel: a CTA of two consumer warpgroups (64 keys each)
// and a producer warpgroup, whose first thread issues every TMA load and
// whose second warp's first thread adds each step's dQ to the sum in device
// memory.  A unit is 128 keys of one (b, KV head): the CTA loads its K and
// V once and streams the group's Q and dO through a ring of
// BwdSmem::kStages
// stages.

constexpr int kOwnRows = 128;  // keys a unit owns
constexpr int kWgRows = 64;  // of those, a consumer warpgroup's
constexpr int kConsumersBwd = kOwnRows / kWgRows;
constexpr int kThreadsBwd = 128 * (kConsumersBwd + 1);
// Registers: an SM's four schedulers each hold a quarter of the register
// file, and a CTA's warps go to them in turn, so a 288-thread CTA (a
// producer warp) held every thread to 168, where dK/dV spilled 36-440 bytes
// at dh 80, 96 and 128 and ptxas serialised its wgmma (C7512).  setmaxnreg
// moves the producer warpgroup's registers to the consumers (K6's split),
// which ptxas honours only with the waits' trap out of line
// (hopper::mbar_wait<true>; the note at the top).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// A tile of R rows of dh bf16 in shared memory, TMA-loaded as regions that
// are one box each: every head dim but 128 as D / 16 regions of 16 columns
// (32-byte rows, 32-byte swizzle), dh 128 as two regions of 64 columns
// (128-byte rows, 128-byte swizzle): [region][R][span].  One layout serves
// both majors: a K-major k-step of 16 columns is 32 bytes of a region's
// rows, and an MN-major k-step of 16 rows is 16 whole rows of every region
// (K6 reads V so; flash_attention.cu).  16-column regions let the two
// warpgroups split dQ's columns at 16-column bounds (DqSplit).
template <int D>
struct TileBf16 {
  static constexpr bool kChunked = D != 128;
  static constexpr int kMain = kChunked ? 0 : D / 64;
  static constexpr int kRem = kChunked ? 0 : D % 64;
  static_assert(kChunked || kRem == 0 || kRem == 32, "dh in 16, 32, 64, 80, 96, 128");
};

// dQ's columns, split between the consumer warpgroups at a region bound:
// warpgroup 0 takes columns 0..kN0-1, warpgroup 1 the rest (none at dh 16,
// one region; 48 and 32 at dh 80's five).
template <int D>
struct DqSplit {
  static constexpr int kN0 = D == 16 ? 16 : D == 80 ? 48 : D / 2;
};

// The descriptor of k-step c (columns 16c..16c+15) of rows row0..row0+63 of a
// K-major tile of R rows at `tile`.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int R, int row0, int c) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) {
    return hopper::desc<32>(tile + c * R * 32 + row0 * 32, 16, 256);
  } else {
    if (c < 4 * T::kMain)
      return hopper::desc<128>(tile + (c / 4) * R * 128 + row0 * 128 + (c % 4) * 32, 16, 1024);
    return hopper::desc<64>(tile + T::kMain * R * 128 + row0 * 64 + (c - 4 * T::kMain) * 32, 16,
                            512);
  }
}

// acc = X . Y^T: X rows x0..x0+63 of a K-major tile of XR rows, Y a K-major
// tile of N = 64 rows, dh / 16 k-steps, both from shared memory.  The
// first k-step writes acc without reading it.
template <int D, int N, int XR>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t x, int x0, uint32_t y) {
  static_assert(N == 64, "the shared-shared products are m64n64");
  hopper::wgmma_ss_m64n64_first<0, 0>(acc, kmajor_desc<D>(x, XR, x0, 0),
                                      kmajor_desc<D>(y, N, 0, 0));
#pragma unroll
  for (int c = 1; c < D / 16; ++c) {
    const uint64_t a = kmajor_desc<D>(x, XR, x0, c);
    const uint64_t b = kmajor_desc<D>(y, N, 0, c);
    hopper::wgmma_ss_m64n64<0, 0>(acc, a, b, 1);
  }
}

// acc += A . Y for k-step kk: A the descriptor of 16 columns (the
// reduction) of a K-major tile, Y a tile of K rows (the reduction) read
// MN-major (dh, wgmma's N, contiguous: the transpose bit).  A chunked dh is
// one product over its regions (LBO = one region, SBO = 8 rows of 32 B);
// dh 128 one n64 product a 64-column region (LBO = one region, SBO = 8
// rows of 128 B, a k-step 2 KB).  acc follows dh in order.
template <int D, int K>
__device__ __forceinline__ void ss_step(float (&acc)[D / 2], uint64_t a, uint32_t y, int kk) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) {
    const uint64_t b = hopper::desc<32>(y + kk * 16 * 32, K * 32, 256);
    if constexpr (D == 16) hopper::wgmma_ss_m64n16<0, 1>(acc, a, b, 1);
    else if constexpr (D == 32) hopper::wgmma_ss_m64n32<0, 1>(acc, a, b, 1);
    else if constexpr (D == 64) hopper::wgmma_ss_m64n64<0, 1>(acc, a, b, 1);
    else if constexpr (D == 80) hopper::wgmma_ss_m64n80<0, 1>(acc, a, b, 1);
    else hopper::wgmma_ss_m64n96<0, 1>(acc, a, b, 1);
  } else {
#pragma unroll
    for (int j = 0; j < T::kMain; ++j)
      hopper::wgmma_ss_m64n64<0, 1>(*reinterpret_cast<float(*)[32]>(&acc[32 * j]), a,
                                    hopper::desc<128>(y + j * K * 128 + kk * 16 * 128, K * 128,
                                                      1024),
                                    1);
  }
}

// P^T and dS^T in shared memory: a [kOwnRows keys][kQueryStep queries]
// bf16 tile each (P rounded, dS's parts hi and lo), 128-byte rows (a key's
// 64 queries) under the 128-byte swizzle.  A consumer thread stores its
// accumulator rows as they stand (two queries a word).  dV's and dK's
// products read a warpgroup's 64 rows K-major (a k-step 16 queries, 32
// bytes of each row); dQ's reads dS through the transpose bit: M (the
// queries) contiguous, a k-step 16 keys (2 KB), SBO 8 keys.
constexpr int kDsBytes = kOwnRows * kQueryStep * 2;

// Byte offset of queries 8c + 2t, +1 of key `key` in such a tile.
__device__ __forceinline__ uint32_t ds_at(int key, int c, int t) {
  return key * 128 + (((c ^ (key & 7)) << 4) | (4 * t));
}

// The descriptor of k-step kk (queries 16kk..16kk+15) of rows row0..row0+63
// of such a tile: K-major.
__device__ __forceinline__ uint64_t rows_desc(uint32_t tile, int row0, int kk) {
  return hopper::desc<128>(tile + row0 * 128 + kk * 32, 16, 1024);
}

// acc += A . Y over the kQueryStep rows of Y, A rows row0.. of the tile at
// `a` (dV: P^T and dO).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t a, int row0, uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < kQueryStep / 16; ++kk)
    ss_step<D, kQueryStep>(acc, rows_desc(a, row0, kk), y, kk);
}

// acc += (lo + hi) . Y: dS's two bf16 parts, lo's product first at each
// k-step (dK: dS^T and Q).
template <int D>
__device__ __forceinline__ void issue_split(float (&acc)[D / 2], uint32_t lo, uint32_t hi,
                                            int row0, uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < kQueryStep / 16; ++kk) {
    ss_step<D, kQueryStep>(acc, rows_desc(lo, row0, kk), y, kk);
    ss_step<D, kQueryStep>(acc, rows_desc(hi, row0, kk), y, kk);
  }
}

// acc = dS . K[:, col0..col0+N-1] over the unit's kOwnRows keys: dS's parts
// at ds_lo, ds_hi (MN-major A), K the owned tile read MN-major from column
// col0 (a region bound); per k-step of 16 keys lo's product, then hi's.
// The first product writes acc without reading it.
template <int D, int N, int C0>
__device__ __forceinline__ void issue_dq(float (&acc)[N / 2 > 0 ? N / 2 : 1], uint32_t ds_lo,
                                         uint32_t ds_hi, uint32_t k_tile) {
  using T = TileBf16<D>;
  if constexpr (N > 0) {
#pragma unroll
    for (int kk = 0; kk < kOwnRows / 16; ++kk) {
      const uint64_t lo = hopper::desc<128>(ds_lo + kk * 16 * 128, kDsBytes, 1024);
      const uint64_t hi = hopper::desc<128>(ds_hi + kk * 16 * 128, kDsBytes, 1024);
      uint64_t b;
      if constexpr (T::kChunked)
        b = hopper::desc<32>(k_tile + (C0 / 16) * kOwnRows * 32 + kk * 16 * 32, kOwnRows * 32,
                             256);
      else
        b = hopper::desc<128>(k_tile + (C0 / 64) * kOwnRows * 128 + kk * 16 * 128,
                              kOwnRows * 128, 1024);
      if constexpr (N == 16) {
        if (kk == 0) hopper::wgmma_ss_m64n16_first<1, 1>(acc, lo, b);
        else hopper::wgmma_ss_m64n16<1, 1>(acc, lo, b, 1);
        hopper::wgmma_ss_m64n16<1, 1>(acc, hi, b, 1);
      } else if constexpr (N == 32) {
        if (kk == 0) hopper::wgmma_ss_m64n32_first<1, 1>(acc, lo, b);
        else hopper::wgmma_ss_m64n32<1, 1>(acc, lo, b, 1);
        hopper::wgmma_ss_m64n32<1, 1>(acc, hi, b, 1);
      } else if constexpr (N == 48) {
        if (kk == 0) hopper::wgmma_ss_m64n48_first<1, 1>(acc, lo, b);
        else hopper::wgmma_ss_m64n48<1, 1>(acc, lo, b, 1);
        hopper::wgmma_ss_m64n48<1, 1>(acc, hi, b, 1);
      } else {
        static_assert(N == 64, "dQ's products are n16, n32, n48 or n64");
        if (kk == 0) hopper::wgmma_ss_m64n64_first<1, 1>(acc, lo, b);
        else hopper::wgmma_ss_m64n64<1, 1>(acc, lo, b, 1);
        hopper::wgmma_ss_m64n64<1, 1>(acc, hi, b, 1);
      }
    }
  }
}

// The TMA maps: the unit's owned tiles (K, V: 128 rows) and the streamed
// ones (Q, dO: kQueryStep rows), [0] boxes of 64 columns (dh 128), [1] of
// 16 (every other head dim).
struct BwdMaps {
  CUtensorMap own_a[2], own_b[2], step_a[2], step_b[2];
};

// One tile of R rows (row0.. of head `head`, batch b) into its regions at dst.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap (&m)[2], uint64_t* bar,
                                         int head, int row0, int b, int R) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      hopper::tma_load_4d(dst + c * R * 32, &m[1], bar, 16 * c, head, row0, b);
  } else {
#pragma unroll
    for (int j = 0; j < T::kMain; ++j)
      hopper::tma_load_4d(dst + j * R * 128, &m[0], bar, 64 * j, head, row0, b);
    if constexpr (T::kRem > 0)
      hopper::tma_load_4d(dst + T::kMain * R * 128, &m[1], bar, 64 * T::kMain, head, row0, b);
  }
}

// Shared memory (from a 1024-byte aligned base): the two owned tiles of
// kOwnRows rows, kStages stages of the two streamed tiles, dS's two
// parts and P^T, the dQ staging buffers (a step's 64 x dh f32 in the order of the
// sum in device memory), each consumer warpgroup's two buffers of its
// step's rows' lse (times log2 e) and D, then the barriers.  Every tile is
// a multiple of 1024 bytes.
template <int D>
struct BwdSmem {
  static constexpr int kOwn = kOwnRows * D * 2;
  static constexpr int kStep = kQueryStep * D * 2;
  // A step's dV, dK and dQ products run behind the next step's S^T and dP^T
  // (bwd_consumer's pipelined loop) where the registers hold both steps:
  // dh 96 and below.
  static constexpr bool kPipelined = D <= 96;
  // Ring depth: a third stage ran level at the trainer's and stablelm's
  // layers with the pipelined loop, and two ran faster than three in the
  // two-pass design (tools/kernel_variants/k6b_onepass.json,
  // k6b_split.json).
  static constexpr int kStages = 2;
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = kOwn;
  static constexpr int kStepA = 2 * kOwn;  // + stage * kStep
  static constexpr int kStepB = kStepA + kStages * kStep;
  static constexpr int kDsHi = kStepB + kStages * kStep;
  static constexpr int kDsLo = kDsHi + kDsBytes;
  static constexpr int kPt = kDsLo + kDsBytes;
  static constexpr int kDqStage = kQueryStep * D * 4;
  // dQ staging buffers: two at every head dim but 128, where one fits
  static constexpr int kDqBufs = D == 128 ? 1 : 2;
  static constexpr int kDq = kPt + kDsBytes;  // + buffer * kDqStage
  static constexpr int kRows = kDq + kDqBufs * kDqStage;  // floats [wg][2][lse, D][64]
  static constexpr int kBar = kRows + kConsumersBwd * 2 * 2 * kQueryStep * 4;
  // full, empty (a stage each), own full and empty, dQ full and empty (a buffer each)
  static constexpr int kBars = 2 * kStages + 2 + 2 * kDqBufs;
  static constexpr int kBytes = kBar + kBars * 8 + 1024;  // + alignment slack
  static_assert(kOwn % 1024 == 0 && kStep % 1024 == 0, "tiles on 1024-byte boundaries");
  static_assert(kBytes <= 232448, "shared memory of an H100 block");
};

// The static walk of a launch.  A unit is key tile j (kOwnRows keys) of
// one (b, KV head); units run key tiles in descending order, (b, KV head)
// the faster index: every unit that adds to a query step before unit u
// (a later key tile: the order of the adds, dq_turn) comes before it.  CTA
// c takes one unit a round, unit r * grid + c in even rounds and r * grid
// + grid - 1 - c in odd ones, so that the causal units, which grow along
// the walk, even out over the CTAs; a CTA's units rise along the walk.
struct BwdWalk {
  int n_kt, Hkv;
  long long bh;  // B * Hkv
  BwdWalk() = default;
  __host__ __device__ BwdWalk(long long B, long long S, int hkv)
      : n_kt((int)((S + kOwnRows - 1) / kOwnRows)), Hkv(hkv), bh(B * hkv) {}
  __host__ __device__ long long units() const { return bh * n_kt; }
  // CTA c's unit of round r in a grid of g, or -1 past the walk's end.
  __host__ __device__ long long at(long long r, int c, int g) const {
    const long long u = r * g + ((r & 1) ? g - 1 - c : c);
    return u < units() ? u : -1;
  }
  __host__ __device__ void unit(long long u, int& j, int& b, int& hk) const {
    j = n_kt - 1 - (int)(u / bh);
    const long long x = u - (long long)(n_kt - 1 - j) * bh;
    b = (int)(x / Hkv);
    hk = (int)(x - (long long)b * Hkv);
  }
};

// Key tile j's place among the tiles that add to query step i: the number
// of later key tiles whose loops visit step i (first_query_tile).  They add
// first, latest tile first: the tile nearest a causal diagonal reaches the
// step first.  A function of (i, j) alone, so the sum's order is fixed.
__device__ __forceinline__ int dq_turn(int i, int j, int n_kt, int causal, int ratio) {
  int pos = 0;
  for (int l = j + 1; l < n_kt && first_query_tile(l, causal, ratio) <= i; ++l) ++pos;
  return pos;
}

// Whether key tile j adds its dQ (every tile does; chip_smoke.py's second
// planted fault makes one skip its add and keep its turn).
__device__ __forceinline__ bool adds_dq(int j) { return j >= 0; }

// A unit's steps: the group's query heads in order and, within each, the
// query steps from first_query_tile on.
struct BwdUnit {
  int j, b, hk, first, per_head, n_steps;
  __device__ BwdUnit(const BwdWalk& walk, long long u, int n_q, int group, int causal) {
    walk.unit(u, j, b, hk);
    first = first_query_tile(j, causal, kOwnRows / kQueryStep);
    per_head = n_q > first ? n_q - first : 0;
    n_steps = group * per_head;
  }
  __device__ int head(int it, int group) const { return hk * group + it / per_head; }
  __device__ int qstep(int it) const { return first + it % per_head; }
};

struct BwdArgs {
  const float* lse;
  const float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  float* dq_acc;  // [B, H, n_q, 64 x dh] f32: the ordered sum, in staging order
  uint32_t* turns;  // [B, H, n_q]: the adds made to each query step
  long long S;
  int H, Hkv, causal, n_q;
  float scale;
  int direct;  // one key tile: each query step's only adder writes dq itself
  BwdWalk walk;
};

// x passes through an empty asm: the compiler no longer knows it as the
// constant it is.
__device__ __forceinline__ void launder(uint32_t& x) { asm volatile("" : "+r"(x)); }

// One consumer warpgroup (W) of the kernel below, over the CTA's units.
template <int D, int W>
__device__ __forceinline__ void bwd_consumer(const BwdArgs& a, uint8_t* smem) {
  using Sm = BwdSmem<D>;
  constexpr int QS = kQueryStep;
  constexpr int C0 = W == 0 ? 0 : DqSplit<D>::kN0;  // this warpgroup's columns of dQ
  constexpr int NQ = W == 0 ? DqSplit<D>::kN0 : D - DqSplit<D>::kN0;
  constexpr int NQR = NQ / 2 > 0 ? NQ / 2 : 1;  // dQ registers
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBar);
  uint64_t* empty = full + Sm::kStages;
  uint64_t* own_full = empty + Sm::kStages;
  uint64_t* own_empty = own_full + 1;
  uint64_t* dq_full = own_empty + 1;
  uint64_t* dq_empty = dq_full + Sm::kDqBufs;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int S = (int)a.S;  // positions fit in 32 bits (S <= kMaxSeq)
  const int group = a.H / a.Hkv;
  const float scale_log2 = a.scale * kLog2eBwd;
  uint32_t k_tile = hopper::smem_u32(smem + Sm::kOwnA);
  uint32_t v_tile = hopper::smem_u32(smem + Sm::kOwnB);
  uint32_t ds_hi = hopper::smem_u32(smem + Sm::kDsHi);
  uint32_t ds_lo = hopper::smem_u32(smem + Sm::kDsLo);
  uint32_t pt = hopper::smem_u32(smem + Sm::kPt);
  const int row_w = W * kWgRows + warp * 16 + (lane >> 2);  // accumulator rows row_w, row_w + 8
  // The warpgroup's two buffers of a step's rows: lse (times log2 e), D.
  float* rows_wg = reinterpret_cast<float*>(smem + Sm::kRows) + W * 2 * 2 * QS;
  auto tile_a = [&](int s) { return hopper::smem_u32(smem + Sm::kStepA + s * Sm::kStep); };
  auto tile_b = [&](int s) { return hopper::smem_u32(smem + Sm::kStepB + s * Sm::kStep); };

  float acc_k[D / 2], acc_v[D / 2], dq[NQR];
  float sc[QS / 2], dp[QS / 2];  // S^T, then P^T; dP^T, then dS^T
  int gs = 0, dq_n = 0, unit_n = 0;  // the CTA's steps, dQ stagings and units so far

  // Step it's dQ (query step i of head h) to the writer: into a staging
  // buffer in the sum's order (n-tile jj of the warpgroup's columns, then
  // the thread, 4 floats), or with one key tile straight to dq in bf16.
  auto stage_dq = [&](int j, int b, int h, int i) {
    hopper::fence_regs(dq);
    if (a.direct) {
      if (!adds_dq(j)) return;
      const int row = i * QS + warp * 16 + (lane >> 2);
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj) {
        const int col = C0 + 8 * jj + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (row + 8 * half >= S) continue;
          *reinterpret_cast<uint32_t*>(
              a.dq + (((long long)b * S + row + 8 * half) * a.H + h) * D + col) =
              pack_bf16(dq[4 * jj + 2 * half] * a.scale, dq[4 * jj + 2 * half + 1] * a.scale);
        }
      }
      return;
    }
    const int buf = dq_n % Sm::kDqBufs;
    hopper::mbar_wait<true>(&dq_empty[buf], ((dq_n / Sm::kDqBufs) & 1) ^ 1);
    float* part = reinterpret_cast<float*>(smem + Sm::kDq + buf * Sm::kDqStage) + QS * C0;
#pragma unroll
    for (int jj = 0; jj < NQ / 8; ++jj)
      *reinterpret_cast<float4*>(part + (jj * 128 + tid) * 4) =
          make_float4(dq[4 * jj], dq[4 * jj + 1], dq[4 * jj + 2], dq[4 * jj + 3]);
    hopper::fence_proxy_async_shared();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&dq_full[buf]);
    ++dq_n;
  };

  for (long long r = 0;; ++r) {
    const long long u = a.walk.at(r, blockIdx.x, gridDim.x);
    if (u < 0) break;
    const BwdUnit un(a.walk, u, a.n_q, group, a.causal);
    if (un.n_steps == 0) continue;
    const int kw0 = un.j * kOwnRows + W * kWgRows;  // this warpgroup's first key
    const int key_a = kw0 + warp * 16 + (lane >> 2);
    // Thread tid < QS fetches row tid of step it's lse and D a step ahead
    // into registers (0 past S: masked) and stores them, lse times log2 e,
    // at the step's start: nothing waits on the loads before then.
    float next_l = 0.f, next_d = 0.f;
    auto fetch = [&](int it) {
      if (it < un.n_steps && tid < QS) {
        const int row = un.qstep(it) * QS + tid;
        const long long at_row = ((long long)un.b * a.H + un.head(it, group)) * S + row;
        next_l = row < S ? a.lse[at_row] : 0.f;
        next_d = row < S ? a.delta[at_row] : 0.f;
      }
    };
    fetch(0);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    hopper::mbar_wait<true>(own_full, unit_n & 1);

    // Step it: its rows in, its stage landed, S^T and dP^T issued.  The
    // tile addresses pass through an empty asm each step, so that ptxas
    // derives the products' descriptors afresh instead of holding them all
    // in registers across the loop.
    auto begin = [&](int it) {
      launder(k_tile);
      launder(v_tile);
      launder(ds_lo);
      launder(ds_hi);
      launder(pt);
      if (tid < QS) {
        rows_wg[(it & 1) * 2 * QS + tid] = next_l * kLog2eBwd;
        rows_wg[(it & 1) * 2 * QS + QS + tid] = next_d;
      }
      fetch(it + 1);
      hopper::named_barrier_sync(1 + W, 128);  // step it's rows are in
      const int s = (gs + it) % Sm::kStages;
      hopper::mbar_wait<true>(&full[s], ((gs + it) / Sm::kStages) & 1);
      hopper::wgmma_fence();
      issue_ss<D, QS, kOwnRows>(sc, k_tile, W * kWgRows, tile_a(s));
      hopper::wgmma_commit();
      issue_ss<D, QS, kOwnRows>(dp, v_tile, W * kWgRows, tile_b(s));
      hopper::wgmma_commit();
    };
    // Step p's products, every operand in shared memory: dV += P^T dO and
    // dK += dS^T Q (this warpgroup's keys), then dQ = dS K (its columns);
    // two groups.
    auto products = [&](int p) {
      const int s = (gs + p) % Sm::kStages;
      hopper::wgmma_fence();
      issue_pv<D>(acc_v, pt, W * kWgRows, tile_b(s));
      issue_split<D>(acc_k, ds_lo, ds_hi, W * kWgRows, tile_a(s));
      hopper::wgmma_commit();
      issue_dq<D, NQ, C0>(dq, ds_lo, ds_hi, k_tile);
      hopper::wgmma_commit();
    };
    // Step p's products are in: its stage goes back to the producer (dQ
    // reads K and dS only) and its dQ to the writer.
    auto retire = [&](int p) {
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(gs + p) % Sm::kStages]);
      stage_dq(un.j, un.b, un.head(p, group), un.qstep(p));
    };
    // Step it once its S^T and dP^T are issued, with K products of the last
    // step behind them (0 or 2 groups): P^T under dP^T (and those); dS^T;
    // the last step retired; step it's P^T (rounded to bf16, as K6's P . V
    // takes it) and dS^T's two parts stored to shared memory once both
    // warpgroups' last products are in.
    auto form = [&](int it, auto behind) {
      constexpr int K = decltype(behind)::value;
      const int q0 = un.qstep(it) * QS;
      const float* lse_s = rows_wg + (it & 1) * 2 * QS;
      const float* delta_s = lse_s + QS;
      hopper::wgmma_wait<K + 1>();
      hopper::fence_regs(sc);
      // Wholly or partly masked for this warpgroup: causal diagonal steps
      // (the unit's first: every pair of warpgroup 1 masked), rows or keys
      // past S.
      const bool masked = q0 + QS > S || kw0 + kWgRows > S || (a.causal && q0 < kw0 + kWgRows - 1);
      // P^T: keys key_a (+ 8) x queries q0 + 8c + 2 t4 (+ 1), while dP^T runs
#pragma unroll
      for (int c = 0; c < QS / 8; ++c) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = hopper::ex2(fmaf(sc[4 * c + e], scale_log2, -((e & 1) ? l.y : l.x)));
          if (masked) {
            const int key = key_a + 8 * (e >> 1);
            const int query = q0 + 8 * c + 2 * t4 + (e & 1);
            if (query >= S || key >= S || (a.causal && key > query)) p = 0.f;
          }
          sc[4 * c + e] = p;
        }
      }
      hopper::wgmma_wait<K>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int c = 0; c < QS / 8; ++c) {
        const float2 dd = *reinterpret_cast<const float2*>(delta_s + 8 * c + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a masked p is 0: so is its dS (dP, D finite)
          const float p = sc[4 * c + e];
          dp[4 * c + e] = p * (dp[4 * c + e] - ((e & 1) ? dd.y : dd.x));
        }
      }
      if constexpr (K > 0) {
        hopper::wgmma_wait<0>();
        retire(it - 1);
      }
      hopper::named_barrier_sync(3, 2 * 128);  // both warpgroups' last products are in
#pragma unroll
      for (int c = 0; c < QS / 8; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = ds_at(row_w + 8 * half, c, t4);
          const int e = 4 * c + 2 * half;
          uint32_t hi, lo;
          split_bf16(dp[e], dp[e + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(smem + Sm::kPt + at) = pack_bf16(sc[e], sc[e + 1]);
          *reinterpret_cast<uint32_t*>(smem + Sm::kDsHi + at) = hi;
          *reinterpret_cast<uint32_t*>(smem + Sm::kDsLo + at) = lo;
        }
      }
      hopper::fence_proxy_async_shared();
      hopper::named_barrier_sync(4, 2 * 128);  // all of dS is in
    };
    using Zero = std::integral_constant<int, 0>;
    using Two = std::integral_constant<int, 2>;
    if constexpr (Sm::kPipelined) {
      // The unit's first step (peeled: no products behind it), then each
      // later one with the last step's products behind its S^T and dP^T.
      begin(0);
      form(0, Zero());
      for (int it = 1; it < un.n_steps; ++it) {
        begin(it);
        // Both warpgroups' S^T and dP^T go to the tensor cores before
        // either's products: a step's softmax waits on them alone.
        hopper::named_barrier_sync(5, 2 * 128);
        products(it - 1);
        form(it, Two());
      }
      products(un.n_steps - 1);
      hopper::wgmma_wait<0>();
      retire(un.n_steps - 1);
    } else {
      for (int it = 0; it < un.n_steps; ++it) {
        begin(it);
        form(it, Zero());
        products(it);
        hopper::wgmma_wait<0>();
        retire(it);
      }
    }
    gs += un.n_steps;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(own_empty);  // K and V are free for the next unit
    ++unit_n;

    // dK, dV [B, S, Hkv, D] contiguous: rows key_a (+ 8), columns 8c + 2 t4
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      if (key >= S) continue;
      const long long at = (((long long)un.b * S + key) * a.Hkv + un.hk) * D + 2 * t4;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(a.dk + at + 8 * c) =
            pack_bf16(acc_k[4 * c + 2 * half] * a.scale, acc_k[4 * c + 2 * half + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + at + 8 * c) =
            pack_bf16(acc_v[4 * c + 2 * half], acc_v[4 * c + 2 * half + 1]);
      }
    }
  }
}

// Polls `turn` until it holds `want` (acquire); a poll count far past any
// run's traps, so a lost add ends the launch with an error instead of
// hanging the card.
__device__ __noinline__ void wait_turn(const uint32_t* turn, uint32_t want) {
  for (uint32_t polls = 0; hopper::ld_acquire_gpu(turn) != want; ++polls)
    if (polls == (1u << 24)) __trap();
}

// dK, dV and dQ: the static walk of units (BwdWalk) over a persistent grid
// launched cooperatively (every CTA resident at once: the turns cannot wait
// on a CTA that is not running).
template <int D>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_attention_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                                     const __grid_constant__ BwdArgs a) {
  using Sm = BwdSmem<D>;
  constexpr int QS = kQueryStep;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBar);
  uint64_t* empty = full + Sm::kStages;
  uint64_t* own_full = empty + Sm::kStages;
  uint64_t* own_empty = own_full + 1;
  uint64_t* dq_full = own_empty + 1;
  uint64_t* dq_empty = dq_full + Sm::kDqBufs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sm::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);  // the producer's arrive + the TMA bytes
      hopper::mbar_init(&empty[s], 4 * kConsumersBwd);  // one arrival a consumer warp
    }
    hopper::mbar_init(own_full, 1);
    hopper::mbar_init(own_empty, 4 * kConsumersBwd);
    for (int s = 0; s < Sm::kDqBufs; ++s) {
      hopper::mbar_init(&dq_full[s], 4 * kConsumersBwd);
      hopper::mbar_init(&dq_empty[s], 1);  // the writer, once its add has read the buffer
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int group = a.H / a.Hkv;

  if (threadIdx.x >= 128 * kConsumersBwd) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumersBwd) {
      // The loads: each unit's K and V once the last unit's consumers are
      // done with theirs, then its steps' Q and dO through the ring.
      int gs = 0, unit_n = 0;
      for (long long r = 0;; ++r) {
        const long long u = a.walk.at(r, blockIdx.x, gridDim.x);
        if (u < 0) break;
        const BwdUnit un(a.walk, u, a.n_q, group, a.causal);
        if (un.n_steps == 0) continue;
        hopper::mbar_wait<true>(own_empty, (unit_n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(own_full, 2 * Sm::kOwn);
        tma_tile<D>(smem + Sm::kOwnA, maps.own_a, own_full, un.hk, un.j * kOwnRows, un.b,
                    kOwnRows);
        tma_tile<D>(smem + Sm::kOwnB, maps.own_b, own_full, un.hk, un.j * kOwnRows, un.b,
                    kOwnRows);
        for (int it = 0; it < un.n_steps; ++it, ++gs) {
          const int s = gs % Sm::kStages;
          hopper::mbar_wait<true>(&empty[s], ((gs / Sm::kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * Sm::kStep);
          const int h = un.head(it, group), q0 = un.qstep(it) * QS;
          tma_tile<D>(smem + Sm::kStepA + s * Sm::kStep, maps.step_a, &full[s], h, q0, un.b, QS);
          tma_tile<D>(smem + Sm::kStepB + s * Sm::kStep, maps.step_b, &full[s], h, q0, un.b, QS);
        }
        ++unit_n;
      }
    } else if (const int pw = (int)threadIdx.x / 32 - 4 * kConsumersBwd;  // producer warp
               !a.direct && threadIdx.x % 32 == 0 && pw >= 1 && pw <= Sm::kDqBufs) {
      // The writers, one a staging buffer (lane 0 of the producer's warps
      // 1..): each takes the steps staged in its buffer and adds them to the
      // sum in their turn (the first adder stores, the rest add), then
      // passes the turn on once its add is in.  A turn is waited on while
      // the consumers still form the step; two writers keep two adds in
      // flight.
      const int w = pw - 1;
      int dq_n = 0;
      for (long long r = 0;; ++r) {
        const long long u = a.walk.at(r, blockIdx.x, gridDim.x);
        if (u < 0) break;
        const BwdUnit un(a.walk, u, a.n_q, group, a.causal);
        for (int it = 0; it < un.n_steps; ++it, ++dq_n) {
          if (dq_n % Sm::kDqBufs != w) continue;
          const int h = un.head(it, group), i = un.qstep(it);
          const long long blk = ((long long)un.b * a.H + h) * a.n_q + i;
          uint32_t* turn = a.turns + blk;
          const int pos = dq_turn(i, un.j, a.walk.n_kt, a.causal, kOwnRows / QS);
          if (pos > 0) {
            wait_turn(turn, (uint32_t)pos);
            hopper::fence_proxy_async_global();
          }
          hopper::mbar_wait<true>(&dq_full[w], (dq_n / Sm::kDqBufs) & 1);
          const uint8_t* src = smem + Sm::kDq + w * Sm::kDqStage;
          float* dst = a.dq_acc + blk * (QS * D);
          if (adds_dq(un.j)) {
            if (pos == 0) hopper::bulk_store(dst, src, Sm::kDqStage);
            else hopper::bulk_reduce_add_f32(dst, src, Sm::kDqStage);
          }
          hopper::bulk_commit();
          hopper::bulk_wait_read<0>();
          hopper::mbar_arrive(&dq_empty[w]);
          hopper::bulk_wait<0>();
          hopper::fence_proxy_async_global();
          hopper::st_release_gpu(turn, (uint32_t)pos + 1);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();
  if (threadIdx.x < 128) bwd_consumer<D, 0>(a, smem);
  else bwd_consumer<D, 1>(a, smem);
}

// dq = bf16(sum * scale): the sum [B, H, n_q, 64 x dh] in staging order
// (warpgroup 0's columns, then warpgroup 1's; within each, n-tile jj, the
// accumulator's thread tid, its 4 floats) into dq [B, S, H, dh]; a thread a
// float4 (rows r, r + 8 of columns c, c + 1).  Rows past S are not stored.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_convert_kernel(const float4* __restrict__ acc,
                                          __nv_bfloat16* __restrict__ dq, long long S, int H,
                                          int n_q, long long total, float scale) {
  constexpr int kN0 = DqSplit<D>::kN0;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long blk = e / (kQueryStep * D / 4);
  int f = (int)(e - blk * (kQueryStep * D / 4));
  int col0 = 0;
  if (f >= (kN0 / 8) * 128) {
    f -= (kN0 / 8) * 128;
    col0 = kN0;
  }
  const int jj = f >> 7, tid = f & 127;
  const int col = col0 + 8 * jj + 2 * (tid & 3);
  const int row = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int i = (int)(blk % n_q);
  const long long bh = blk / n_q;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const long long q = (long long)i * kQueryStep + row;
  const float4 v = acc[e];
  if (q < S)
    *reinterpret_cast<uint32_t*>(dq + ((b * S + q) * H + h) * D + col) =
        pack_bf16(v.x * scale, v.y * scale);
  if (q + 8 < S)
    *reinterpret_cast<uint32_t*>(dq + ((b * S + q + 8) * H + h) * D + col) =
        pack_bf16(v.z * scale, v.w * scale);
}

// The maps of one tile role: a chunked dh one map of 16-column boxes in
// [1]; dh 128 64-column boxes in [0].
template <int D>
int make_maps(CUtensorMap (&m)[2], const void* p, long long B, long long S, int heads,
              long long sb, long long ss, long long sh, int rows) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) return make_map(&m[1], p, B, S, heads, D, sb, ss, sh, 16, rows);
  int err = T::kMain ? make_map(&m[0], p, B, S, heads, D, sb, ss, sh, 64, rows) : 0;
  if (!err && T::kRem) err = make_map(&m[1], p, B, S, heads, D, sb, ss, sh, T::kRem, rows);
  return err;
}

template <int D>
int make_maps_bwd(BwdMaps& m, const void* q, const void* k, const void* v, const void* g,
                  long long B, long long S, int H, int Hkv, const Strides& st) {
  int err = make_maps<D>(m.own_a, k, B, S, Hkv, st.kb, st.ks, st.kh, kOwnRows);
  if (!err) err = make_maps<D>(m.own_b, v, B, S, Hkv, st.vb, st.vs, st.vh, kOwnRows);
  if (!err) err = make_maps<D>(m.step_a, q, B, S, H, st.qb, st.qs, st.qh, kQueryStep);
  if (!err) err = make_maps<D>(m.step_b, g, B, S, H, st.gb, st.gs, st.gh, kQueryStep);
  return err;
}

// The device's SM count times the resident CTAs of the bf16 kernel at head
// dim D (the cooperative launch's most), with its shared-memory attribute
// set: both once a device.  0 where the runtime refused.
template <int D>
int resident_ctas_once() {
  static std::atomic<int> known[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  int n = known[dev].load(std::memory_order_acquire);
  if (n > 0) return n;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(flash_attention_bwd_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BwdSmem<D>::kBytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_attention_bwd_wgmma_kernel<D>,
                                                    kThreadsBwd, BwdSmem<D>::kBytes) !=
          cudaSuccess)
    return 0;
  n = sms * per_sm;
  known[dev].store(n, std::memory_order_release);
  return n;
}

// The scratch of a bf16 call, in floats from its start: D [B, H, S], then
// the turns [B, H, n_q] (u32) and the sum [B, H, n_q, 64 x dh] (f32), each
// on a 128-byte boundary; with one key tile (S <= kOwnRows) neither.
// kernels/flash_attention.py's _scratch_floats is its twin.
inline long long round32(long long x) { return (x + 31) / 32 * 32; }
inline long long turns_at(long long B, long long S, int H) { return round32(B * H * S); }
inline long long sum_at(long long B, long long S, int H) {
  return round32(turns_at(B, S, H) + B * H * ((S + kQueryStep - 1) / kQueryStep));
}

// D (and the turns zeroed), the dK/dV/dQ kernel, then dq from the sum, on
// one stream, bf16.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* g,
                const float* lse, float* scratch, void* dq, void* dk, void* dv, long long B,
                long long S, int H, int Hkv, int causal, const Strides& st,
                cudaStream_t stream) {
  BwdMaps maps = {};
  const int err = make_maps_bwd<D>(maps, q, k, v, g, B, S, H, Hkv, st);
  if (err) return err;
  const int resident = resident_ctas_once<D>();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int n_q = (int)((S + kQueryStep - 1) / kQueryStep);
  const BwdWalk walk(B, S, Hkv);
  BwdArgs a;
  a.lse = lse;
  a.delta = scratch;
  a.dq = (__nv_bfloat16*)dq;
  a.dk = (__nv_bfloat16*)dk;
  a.dv = (__nv_bfloat16*)dv;
  a.direct = walk.n_kt == 1;
  a.turns = a.direct ? nullptr : reinterpret_cast<uint32_t*>(scratch + turns_at(B, S, H));
  a.dq_acc = a.direct ? nullptr : scratch + sum_at(B, S, H);
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.n_q = n_q;
  a.scale = 1.f / sqrtf((float)D);
  a.walk = walk;
  constexpr int rows = DeltaPlan<__nv_bfloat16, D>::kRows;
  const dim3 grid_rows((unsigned)((S + rows - 1) / rows), (unsigned)H, (unsigned)B);
  flash_attention_bwd_delta_kernel<__nv_bfloat16, D><<<grid_rows, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)g, scratch, S, H, st, a.turns, n_q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long units = walk.units();
  const unsigned grid = (unsigned)(units < resident ? units : resident);
  void* args[] = {&maps, &a};
  e = cudaLaunchCooperativeKernel((const void*)flash_attention_bwd_wgmma_kernel<D>, dim3(grid),
                                  dim3(kThreadsBwd), args, BwdSmem<D>::kBytes, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess || a.direct) return (int)e;
  const long long total = B * H * (long long)n_q * kQueryStep * D / 4;
  flash_attention_bwd_dq_convert_kernel<D>
      <<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(a.dq_acc), (__nv_bfloat16*)dq, S, H, n_q, total,
          a.scale);
  return (int)cudaGetLastError();
}

// Host time of a bf16 call's parts, in ns a call over `reps` calls: [0] the
// four maps encoded afresh (cuTensorMapEncodeTiled each), [1] the
// shared-memory attribute set and the occupancy asked (as every call of the
// two-pass design set its two attributes); [2] the maps as a call makes
// them now (copied from the cache, the address replaced), [3] the attribute
// and occupancy as a call reads them now.  Launches nothing.
template <int D>
int host_parts_bf16(const void* q, const void* k, const void* v, const void* g, long long B,
                    long long S, int H, int Hkv, const Strides& st, int reps, long long* ns) {
  using clock = std::chrono::steady_clock;
  BwdMaps m = {};
  int err = 0;
  auto per_call = [&](clock::time_point t0) {
    return (long long)(std::chrono::duration_cast<std::chrono::nanoseconds>(clock::now() - t0)
                           .count() / reps);
  };
  const int j = TileBf16<D>::kChunked ? 1 : 0, cols = j ? 16 : 64;
  auto t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r) {
    err = tensor_map::encode_map(&m.own_a[j], k, B, S, Hkv, D, st.kb, st.ks, st.kh, cols,
                                 kOwnRows);
    if (!err)
      err = tensor_map::encode_map(&m.own_b[j], v, B, S, Hkv, D, st.vb, st.vs, st.vh, cols,
                                   kOwnRows);
    if (!err)
      err = tensor_map::encode_map(&m.step_a[j], q, B, S, H, D, st.qb, st.qs, st.qh, cols,
                                   kQueryStep);
    if (!err)
      err = tensor_map::encode_map(&m.step_b[j], g, B, S, H, D, st.gb, st.gs, st.gh, cols,
                                   kQueryStep);
  }
  ns[0] = per_call(t0);
  t0 = clock::now();
  int dev = 0, per_sm = 0;
  for (int r = 0; r < reps && !err; ++r) {
    err = (int)cudaFuncSetAttribute(flash_attention_bwd_wgmma_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    BwdSmem<D>::kBytes);
    if (!err) err = (int)cudaGetDevice(&dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_attention_bwd_wgmma_kernel<D>, kThreadsBwd, BwdSmem<D>::kBytes);
  }
  ns[1] = per_call(t0);
  if (!err) err = make_maps_bwd<D>(m, q, k, v, g, B, S, H, Hkv, st);  // fills the cache
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r) err = make_maps_bwd<D>(m, q, k, v, g, B, S, H, Hkv, st);
  ns[2] = per_call(t0);
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    if (resident_ctas_once<D>() <= 0) err = (int)cudaErrorInvalidConfiguration;
  ns[3] = per_call(t0);
  return err;
}

// D, then dK/dV, then dQ on one stream, f32: the mma.sync kernels.
template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* g,
               const float* lse, float* delta, void* dq, void* dk, void* dv, long long B,
               long long S, int H, int Hkv, int causal, const Strides& st, cudaStream_t stream) {
  constexpr int smem = TileF32<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)D);
  const unsigned tiles = (unsigned)((S + kOwnF32 - 1) / kOwnF32);
  constexpr int rows = DeltaPlan<float, D>::kRows;
  const dim3 grid_rows((unsigned)((S + rows - 1) / rows), (unsigned)H, (unsigned)B);
  flash_attention_bwd_delta_kernel<float, D><<<grid_rows, kThreads, 0, stream>>>(
      (const float*)o, (const float*)g, delta, S, H, st, nullptr, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dkdv_f32_kernel<D>
      <<<dim3(tiles, (unsigned)Hkv, (unsigned)B), kThreadsF32, smem, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)g, lse, delta,
          (float*)dk, (float*)dv, S, H, Hkv, causal, scale, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dq_f32_kernel<D>
      <<<dim3(tiles, (unsigned)H, (unsigned)B), kThreadsF32, smem, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)g, lse, delta,
          (float*)dq, S, H, Hkv, causal, scale, st);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* g,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, long long B,
           long long S, int H, int Hkv, int causal, const Strides& st, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)
    return launch_f32<D>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st,
                         stream);
  else
    return launch_bf16<D>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st,
                          stream);
}

bool read_strides(long long B, long long S, int H, int Hkv, const long long* strides,
                  Strides& st, int& code) {
  code = 0;
  if (B <= 0 || S <= 0 || H <= 0) return false;
  if (Hkv <= 0 || H % Hkv || S > kMaxSeq) {
    code = (int)cudaErrorInvalidValue;
    return false;
  }
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  st.gb = strides[12]; st.gs = strides[13]; st.gh = strides[14];
  return true;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
             const float* lse, float* scratch, void* dq, void* dk, void* dv, long long B,
             long long S, int H, int Hkv, int D, int causal, const long long* strides,
             void* stream) {
  Strides st;
  int code;
  if (!read_strides(B, S, H, Hkv, strides, st, code)) return code;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 32: return launch<T, 32>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 64: return launch<T, 64>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 80: return launch<T, 80>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 96: return launch<T, 96>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    case 128: return launch<T, 128>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, causal, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int host_parts(const void* q, const void* k, const void* v, const void* g, long long B,
               long long S, int H, int Hkv, int D, const long long* strides, int reps,
               long long* ns) {
  Strides st;
  int code;
  if (!read_strides(B, S, H, Hkv, strides, st, code))
    return code ? code : (int)cudaErrorInvalidValue;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return host_parts_bf16<16>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    case 32: return host_parts_bf16<32>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    case 64: return host_parts_bf16<64>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    case 80: return host_parts_bf16<80>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    case 96: return host_parts_bf16<96>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    case 128: return host_parts_bf16<128>(q, k, v, g, B, S, H, Hkv, st, reps, ns);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, S, Hkv, D], o and g (dL/do) [B, S, H, D], one
// dtype, by the 15 element strides (b, s, h) of q, k, v, o, g in `strides`,
// the last dim contiguous; lse [B, H, S] f32 (K6's row logsumexp); scratch
// f32 of kernels/flash_attention.py's _scratch_floats (f32: D [B, H, S];
// bf16: D, the turns and the dQ sum, sum_at); dq [B, S, H, D], dk and dv
// [B, S, Hkv, D] contiguous outputs in q's dtype.  D in {16, 32, 64, 80,
// 96, 128} for both dtypes.  Three launches on `stream` (bf16 with one key
// tile, S <= 128: two); returns the first nonzero CUDA error, else 0.
int flash_attention_backward_f32(const void* q, const void* k, const void* v, const void* o,
                                 const void* g, const float* lse, float* scratch, void* dq,
                                 void* dk, void* dv, long long B, long long S, int H, int Hkv,
                                 int D, int causal, const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, D, causal,
                         strides, stream);
}

int flash_attention_backward_bf16(const void* q, const void* k, const void* v, const void* o,
                                  const void* g, const float* lse, float* scratch, void* dq,
                                  void* dk, void* dv, long long B, long long S, int H, int Hkv,
                                  int D, int causal, const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, S, H, Hkv, D,
                                 causal, strides, stream);
}

// The host time of flash_attention_backward_bf16's parts (host_parts_bf16):
// ns[4], in ns a call over `reps` calls, at the arguments of a call (o,
// lse, the outputs, causal and the stream are not needed: nothing is
// launched).
int flash_attention_backward_bf16_host_ns(const void* q, const void* k, const void* v,
                                          const void* g, long long B, long long S, int H,
                                          int Hkv, int D, const long long* strides, int reps,
                                          long long* ns) {
  return host_parts(q, k, v, g, B, S, H, Hkv, D, strides, reps, ns);
}

const char* flash_attention_backward_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
