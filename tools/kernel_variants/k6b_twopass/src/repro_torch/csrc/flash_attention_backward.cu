// A rework of K6' bf16's two passes, kept for the next session: it ran
// right on the card (NVIDIA H100 80GB HBM3, 700 W; 13 shapes, dh 16-128,
// ragged, full, groups 1-8, twice bit-equal) but no chip was free to time
// it.  python3 tools/kernel_variants.py --against
// tools/kernel_variants/k6b_twopass tools/kernel_variants/turns_k6b.json
// times it (through its own wrapper, ../kernels/flash_attention.py, whose
// scratch it needs) beside the committed source.  Not built by the
// package.  What it changes: ping-pong between the consumer warpgroups, a
// step's second products issued with the next step's first (dh 80 and
// below; ptxas serialised dK/dV's wgmma at dh 96 that way), the lse and D
// rows padded by the D launch and bulk-loaded with each dK/dV stage, the
// first S/dP k-step output-only, 3 stages, both attributes set once a
// device, and a host-time probe (flash_attention_backward_bf16_host_ns).
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
// (query, key) pair kept (S, dP, dV, dK, dQ), against 2 dh elements of K
// and V a key and 3 dh of q, o, do a query row, so at S = 4096 it does
// thousands of FLOP per byte: far above the ridge.  Both designs here
// recompute S and dP in the dQ pass (seven products), and bf16 runs dK and
// dQ twice for dS's two parts (nine).
//
// What the design does about it.  Both dtypes: three launches, D (a group
// of lanes a row), dK/dV with one CTA per (b, KV head, key tile) looping
// over the group's query heads in order and over the query tiles at or
// after the key tile (first_query_tile) when causal, and dQ with one CTA
// per (b, head, query tile) looping over the key tiles up to its diagonal,
// in order.  Each output element is owned by one thread of one CTA and
// summed in a fixed order: no atomics, two launches give equal bits (a
// training resume stays bit-equal).  P is recomputed from q, k and lse in
// both passes; dP from do and v.  Any S: rows and keys past S load as zeros
// and are masked; rows past S are not stored.
//
// bf16 on Hopper (FlashAttention-3's shape, without its atomics; the
// section "bf16 on wgmma" below):
//  * A warp-specialised CTA of 384 threads owns 128 rows: keys in the dK/dV
//    pass, query rows in the dQ pass, 64 for each of two consumer
//    warpgroups.  One thread of the producer warpgroup loads the CTA's two
//    owned tiles (K and V, or Q and dO) once by TMA and streams the other
//    two (Q and dO in query tiles of 64, or K and V in key tiles of 64)
//    through a ring of 3 stages with full and empty mbarriers.  The D
//    launch writes each row's lse times log2 e and D, padded to whole query
//    tiles with zeros, so that a dK/dV stage bulk-loads its rows of both
//    beside its tiles (the consumers load nothing themselves: a named
//    barrier waits for a warp's outstanding loads, and a row fetch a step
//    ahead cost that barrier about 1,000 cycles a step); the dQ consumers
//    read their two rows' once.
//  * A step, in each consumer warpgroup: first products (dK/dV: S^T = K Q^T
//    and dP^T = V dO^T; dQ: S = Q K^T and dP = dO V^T), wgmma m64n64 with
//    both operands in shared memory, K-major, the first k-step
//    output-only; then P and dS in registers on the accumulator layout
//    while dP still runs, packed into the register A fragments of the
//    second products (as K6's P is): dV += P^T dO and dK += dS^T Q, or dQ +=
//    dS K, with the B tile read MN-major through the descriptor's
//    transpose bit.  A step's second products are issued in one turn with
//    the next step's first products, ahead of them, and are in before that
//    step's elementwise work rewrites the fragments (pipelined_steps; dK/dV
//    above dh 80, whose registers cannot hold both, issues them in turns of
//    their own).
//  * Ping-pong (as K6's): the two consumer warpgroups take turns to issue
//    (named barriers 3 and 4), so that one's elementwise work runs under
//    the other's products.  Every warpgroup runs every step: a step wholly
//    masked for one (warpgroup 1 at a causal key tile's first step in
//    dK/dV, warpgroup 0 at a query tile's last in dQ) runs on zeros of P,
//    which keeps the turns even and no wgmma under a runtime condition.
//  * Numerics as the mma.sync design before it: P rounded to bf16 for dV
//    (as K6's P . V takes it); dS as two bf16 parts, hi = bf16(dS) and lo =
//    bf16(dS - hi), each product run twice, lo first (rounded once, dS put
//    dq 1.56e-2 off the f32 plain version at stablelm's layer, PERF.md);
//    every sum f32.
//  * Causal: only the diagonal and ragged tiles mask.  Longest work first:
//    key tile 0 first in dK/dV, the last query tile first in dQ.
//  * One pass, dQ summed across key tiles in a fixed order by bulk
//    reductions (seven products instead of nine), was built and lost in
//    turns (tools/kernel_variants/k6b_onepass, PERF.md).
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

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using tensor_map::kEncodeError;
using tensor_map::make_map;

constexpr int kThreads = 256;  // the D kernel's
constexpr long long kMaxSeq = (1LL << 31) - 256;  // positions are int32
constexpr float kLog2eBwd = 1.4426950408889634f;

struct Strides {  // element strides (b, s, h) of q, k, v, o, do
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
};

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
  static constexpr int kLanes =
      kLoads <= 2 ? 2 : kLoads <= 4 ? 4 : kLoads <= 8 ? 8 : kLoads <= 16 ? 16 : 32;
  static constexpr int kRows = kThreads / kLanes;
};

// The forward's D = rowsum(do o) in f32: a group of DeltaPlan's lanes a
// (b, h, row), 16 bytes of o and do a load, then a butterfly in the group,
// into out [B, H, sp] (rows S..sp - 1 zero).  With `lse` (bf16), out holds
// first lse times log2 e [B, H, sp] (0 past S), then D, so that a dK/dV
// step bulk-loads its rows of both; f32 passes no lse and sp = S.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                     const float* __restrict__ lse, float* __restrict__ out,
                                     long long S, long long sp, int H, Strides st) {
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
  if (s >= sp || lane != 0) return;
  const long long at = (b * H + h) * sp + s;
  if (lse == nullptr) {
    out[at] = acc;
    return;
  }
  out[at] = s < S ? lse[(b * H + h) * S + s] * kLog2eBwd : 0.f;
  out[(long long)gridDim.z * H * sp + at] = acc;
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
// The design note at the top ("bf16 on Hopper").  Both passes are one
// warp-specialised CTA of two consumer warpgroups (64 rows each) and a
// producer warpgroup, one thread of which issues every TMA load: the CTA
// owns kOwnRows rows of two tiles (K and V in the dK/dV pass, Q and dO in
// the dQ pass), loaded once, and streams the other two (Q and dO, or K and
// V) through a ring of kStagesBwd stages.

constexpr int kOwnRows = 128;  // keys (dK/dV) or query rows (dQ) a CTA owns
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
constexpr int kKeyStep = 64;  // keys a dQ step streams
// Ring depth of both passes.  A step's tiles stay in use until its second
// products, issued beside the next step's first ones, are in: a third stage
// keeps the next load in flight meanwhile.  (With the products in the
// step, PR 25's loop, two stages ran faster than three at stablelm's layer,
// 1.915 against 2.007 ms; tools/kernel_variants/k6b_split.json.)
constexpr int kStagesBwd = 3;
// Query rows a dK/dV step streams.  32 at dh 128 (where 64 once left too
// few registers) ran 28% slower than 64 at olmoe's layer (0.964 against
// 0.751 ms).
constexpr int kQueryStep = 64;

// A tile of R rows of dh bf16 in shared memory, TMA-loaded as regions that
// are one box each: dh 80 and 16 as D / 16 regions of 16 columns (32-byte
// rows, 32-byte swizzle), other head dims as D / 64 regions of 64 columns
// (128-byte rows, 128-byte swizzle) and, at dh 96 and 32, one of 32 (64-byte
// rows and swizzle): [region][R][span].  One layout serves both majors: a
// K-major k-step of 16 columns is 32 bytes of a region's rows, and an
// MN-major k-step of 16 rows is 16 whole rows of every region (K6 reads V
// so; flash_attention.cu).
template <int D>
struct TileBf16 {
  static constexpr bool kChunked = D == 16 || D == 80;
  static constexpr int kMain = kChunked ? 0 : D / 64;
  static constexpr int kRem = kChunked ? 0 : D % 64;
  static_assert(kChunked || kRem == 0 || kRem == 32, "dh in 16, 32, 64, 80, 96, 128");
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
// first k-step writes acc without reading it (an output-only operand: acc's
// registers are free until then).
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

// acc += A . Y for k-step kk: A's 16 columns from registers, Y a tile of K
// rows (the reduction) read MN-major (dh, wgmma's N, contiguous: the
// transpose bit).  dh 80 is one n80 product over the five regions (LBO = one
// region, SBO = 8 rows of 32 B) and dh 16 one n16 over its one; a 64-column
// region is an n64 product each (LBO = one region, SBO = 8 rows of 128 B, a
// k-step 2 KB) and the last region of dh 96 (or dh 32's only) an n32 (SBO =
// 8 rows of 64 B).  acc follows dh in order.
template <int D, int K>
__device__ __forceinline__ void rs_step(float (&acc)[D / 2], const uint32_t (&a)[4], uint32_t y,
                                        int kk) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) {
    const uint64_t b = hopper::desc<32>(y + kk * 16 * 32, K * 32, 256);
    if constexpr (D == 80) hopper::wgmma_rs_m64n80<1>(acc, a, b);
    else hopper::wgmma_rs_m64n16<1>(acc, a, b);
  } else {
#pragma unroll
    for (int j = 0; j < T::kMain; ++j)
      hopper::wgmma_rs_m64n64<1>(*reinterpret_cast<float(*)[32]>(&acc[32 * j]), a,
                                 hopper::desc<128>(y + j * K * 128 + kk * 16 * 128, K * 128, 1024));
    if constexpr (T::kRem == 32)
      hopper::wgmma_rs_m64n32<1>(
          *reinterpret_cast<float(*)[16]>(&acc[32 * T::kMain]), a,
          hopper::desc<64>(y + T::kMain * K * 128 + kk * 16 * 64, K * 64, 512));
  }
}

// The four A registers of k-step kk of a fragment.
template <int K>
__device__ __forceinline__ const uint32_t (&kstep(const uint32_t (&a)[K / 4], int kk))[4] {
  return *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * kk]);
}

// acc += A . Y over the K rows of Y.
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 4],
                                         uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) rs_step<D, K>(acc, kstep<K>(a, kk), y, kk);
}

// acc += (lo + hi) . Y: dS's two bf16 parts, lo's product first at each k-step.
template <int D, int K>
__device__ __forceinline__ void issue_rs_split(float (&acc)[D / 2], const uint32_t (&lo)[K / 4],
                                               const uint32_t (&hi)[K / 4], uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    rs_step<D, K>(acc, kstep<K>(lo, kk), y, kk);
    rs_step<D, K>(acc, kstep<K>(hi, kk), y, kk);
  }
}

// The accumulator of columns 16kk..16kk+15 is the A fragment of k-step kk
// (flash_attention.cu's pack_p): P rounded to bf16, and dS in two parts.
template <int N>
__device__ __forceinline__ void pack_frag(const float (&x)[N / 2], uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[2 * j] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[2 * j + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}
template <int N>
__device__ __forceinline__ void split_acc(const float (&x)[N / 2], uint32_t (&hi)[N / 4],
                                          uint32_t (&lo)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_bf16(x[4 * j], x[4 * j + 1], hi[2 * j], lo[2 * j]);
    split_bf16(x[4 * j + 2], x[4 * j + 3], hi[2 * j + 1], lo[2 * j + 1]);
  }
}

// The TMA maps of a pass: the two tiles a CTA owns and the two it streams,
// [0] boxes of 64 columns, [1] of dh 96's last 32 (dh 32's only ones) or of
// dh 80's and dh 16's 16.
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

// Shared memory of a pass (from a 1024-byte aligned base): the two owned
// tiles of kOwnRows rows, kStagesBwd stages of the two streamed tiles of
// StepR rows, each stage's rows' lse (times log2 e) and D (dK/dV: StepR
// floats each, bulk-loaded with the stage), then the barriers.  Every tile
// is a multiple of 1024 bytes.
template <int D, int StepR>
struct BwdSmem {
  static constexpr int kOwn = kOwnRows * D * 2;
  static constexpr int kStep = StepR * D * 2;
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = kOwn;
  static constexpr int kStepA = 2 * kOwn;  // + stage * kStep
  static constexpr int kStepB = kStepA + kStagesBwd * kStep;
  static constexpr int kRowsStage = 2 * StepR * 4;  // [lse, D][StepR] f32
  static constexpr int kRows = kStepB + kStagesBwd * kStep;  // + stage * kRowsStage
  static constexpr int kBar = kRows + kStagesBwd * kRowsStage;
  static constexpr int kBytes = kBar + (2 * kStagesBwd + 1) * 8 + 1024;  // + alignment slack
  static_assert(kOwn % 1024 == 0 && kStep % 1024 == 0, "tiles on 1024-byte boundaries");
  static_assert(kBytes <= 232448, "shared memory of an H100 block");
};

// The loads, all issued by the producer's first thread.  full[s] completes
// on the bytes of stage s (one arrival), empty[s] when the 8 consumer warps
// have released it, ownbar on the owned tiles' bytes.
template <int D, int StepR>
struct Loader {
  using Sm = BwdSmem<D, StepR>;
  const BwdMaps& maps;
  uint8_t* smem;
  uint64_t *full, *empty, *ownbar;
  int b;

  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStagesBwd; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], 4 * kConsumersBwd);
      }
      hopper::mbar_init(ownbar, 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
  }
  // Step `it` (rows at.y.. of head at.x) into its stage; with `rows` (the
  // step's StepR values of lse times log2 e, and D StepR x `plane` floats
  // after them) those too.
  __device__ __forceinline__ void step(int it, int2 at, const float* rows,
                                       long long plane) const {
    const int s = it % kStagesBwd;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * Sm::kStep + (rows ? Sm::kRowsStage : 0));
    tma_tile<D>(smem + Sm::kStepA + s * Sm::kStep, maps.step_a, &full[s], at.x, at.y, b, StepR);
    tma_tile<D>(smem + Sm::kStepB + s * Sm::kStep, maps.step_b, &full[s], at.x, at.y, b, StepR);
    if (rows != nullptr) {
      uint8_t* dst = smem + Sm::kRows + s * Sm::kRowsStage;
      hopper::bulk_load(dst, rows, StepR * 4, &full[s]);
      hopper::bulk_load(dst + StepR * 4, rows + plane, StepR * 4, &full[s]);
    }
  }
  // The owned tiles, then every step: step it into its stage once the
  // consumers have released step it - kStagesBwd there.  rows_at(it) is
  // step it's rows (or null).
  template <typename StepAt, typename RowsAt>
  __device__ __forceinline__ void produce(int head, int row0, int n_steps, StepAt step_at,
                                          RowsAt rows_at, long long plane) const {
    hopper::mbar_arrive_expect_tx(ownbar, 2 * Sm::kOwn);
    tma_tile<D>(smem + Sm::kOwnA, maps.own_a, ownbar, head, row0, b, kOwnRows);
    tma_tile<D>(smem + Sm::kOwnB, maps.own_b, ownbar, head, row0, b, kOwnRows);
    for (int it = 0; it < n_steps; ++it) {
      hopper::mbar_wait<true>(&empty[it % kStagesBwd], ((it / kStagesBwd) & 1) ^ 1);
      step(it, step_at(it), rows_at(it), plane);
    }
  }
  __device__ __forceinline__ uint32_t tile_a(int it) const {
    return hopper::smem_u32(smem + Sm::kStepA + (it % kStagesBwd) * Sm::kStep);
  }
  __device__ __forceinline__ uint32_t tile_b(int it) const {
    return hopper::smem_u32(smem + Sm::kStepB + (it % kStagesBwd) * Sm::kStep);
  }
  __device__ __forceinline__ const float* rows(int it) const {
    return reinterpret_cast<const float*>(smem + Sm::kRows + (it % kStagesBwd) * Sm::kRowsStage);
  }
  // The consumer warps are done with step it's stage.
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[it % kStagesBwd]);
  }
};

// The consumer warpgroups take turns to issue their products (named
// barriers 3 and 4, as K6's ping-pong), so that one's elementwise work runs
// under the other's products.  Warpgroup 0 goes first; each issues the same
// number of times.
struct PingPong {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 1) hopper::named_barrier_arrive(3, 2 * 128);
  }
  __device__ __forceinline__ void mine() const { hopper::named_barrier_sync(3 + wg, 2 * 128); }
  __device__ __forceinline__ void theirs() const {
    hopper::named_barrier_arrive(4 - wg, 2 * 128);
  }
};

// The loop of both passes, for a warpgroup: n steps, each with first
// products A (S and dP, on the step's tiles) and second products B (dK and
// dV, or dQ; on the tiles and the fragments that step's elementwise work
// made).  kRotated: step it's B is issued in one turn with step it + 1's A,
// ahead of it, and is in before step it + 1's elementwise work rewrites the
// fragments; the fragments stay live while A's outputs are taken, which
// dK/dV above dh 80 cannot hold (at dh 128 its accumulators take 128
// registers, the fragments 48, S and dP 64: past the consumers' 232; at dh
// 96 ptxas serialised the products, C7512), so there each step issues A
// and B in turns of their own.  Either way the other warpgroup's products keep
// the tensor cores busy while this one forms its fragments.  form(it)
// forms step it's fragments once its S and then its dP are in (wait<1>,
// wait<0>: nothing else is in flight then).  The rotated loop's first step
// is peeled (no B ahead of its A): ptxas serialises wgmma issued or waited
// on under a runtime condition (C7515).
template <bool kRotated, typename Ld, typename A, typename B, typename Form, typename Retire>
__device__ __forceinline__ void pipelined_steps(const Ld& ld, const PingPong& turn, int n,
                                                A issue_a, B issue_b, Form form,
                                                Retire retire) {
  if constexpr (!kRotated) {
    for (int it = 0; it < n; ++it) {
      hopper::mbar_wait<true>(&ld.full[it % kStagesBwd], (it / kStagesBwd) & 1);
      turn.mine();
      issue_a(it);
      turn.theirs();
      form(it);
      turn.mine();
      issue_b(it);
      turn.theirs();
      hopper::wgmma_wait<0>();
      retire(it);
    }
    return;
  }
  hopper::mbar_wait<true>(&ld.full[0], 0);
  turn.mine();
  issue_a(0);
  turn.theirs();
  form(0);
  for (int it = 1; it < n; ++it) {
    hopper::mbar_wait<true>(&ld.full[it % kStagesBwd], (it / kStagesBwd) & 1);
    turn.mine();
    issue_b(it - 1);
    issue_a(it);
    turn.theirs();
    hopper::wgmma_wait<2>();  // step it - 1's B is in
    retire(it - 1);
    form(it);
  }
  turn.mine();
  issue_b(n - 1);
  turn.theirs();
  hopper::wgmma_wait<0>();
  retire(n - 1);
}

// dK and dV: a CTA per (128-key tile, KV head, b), warpgroup w owning keys
// 64w.. of it; the steps are the group's query heads in order and, within
// each, the query tiles of QS rows from first_query_tile on.  `rows` is the
// D launch's [B, H, Sp] lse times log2 e, then D at `plane` floats after.
template <int D>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                                          const float* __restrict__ rows, long long plane,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv, long long S_, int H,
                                          int Hkv, int causal, float scale) {
  constexpr int QS = kQueryStep;
  using Sm = BwdSmem<D, QS>;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBar);
  const int S = (int)S_;  // positions fit in 32 bits (S <= kMaxSeq)
  const int j = blockIdx.x;  // key tile: the first has the most query tiles
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const Loader<D, QS> ld{maps, smem, full, full + kStagesBwd, full + 2 * kStagesBwd, b};
  const int group = H / Hkv;
  const int k0 = j * kOwnRows;
  const int n_q = (S + QS - 1) / QS;
  const int first = first_query_tile(j, causal, kOwnRows / QS);
  const int per_head = n_q > first ? n_q - first : 0;
  const int n_steps = group * per_head;
  const long long sp = (long long)n_q * QS;  // a head's rows in `rows`
  auto step_at = [&](int it) {  // (query head, first row) of step it
    return make_int2(hk * group + it / per_head, (first + it % per_head) * QS);
  };
  ld.init();
  if (threadIdx.x >= 128 * kConsumersBwd) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumersBwd && n_steps > 0)
      ld.produce(hk, k0, n_steps, step_at, [&](int it) {
        const int2 at = step_at(it);
        return rows + ((long long)b * H + at.x) * sp + at.y;
      }, plane);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int kw0 = k0 + wg * kWgRows;  // this warpgroup's first key
  const int key_a = kw0 + warp * 16 + (lane >> 2);  // accumulator rows key_a, key_a + 8
  const float scale_log2 = scale * kLog2eBwd;
  const uint32_t k_tile = hopper::smem_u32(smem + Sm::kOwnA);
  const uint32_t v_tile = hopper::smem_u32(smem + Sm::kOwnB);
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float sc[QS / 2], dp[QS / 2];  // S^T, then P^T; dP^T, then dS^T
  uint32_t pa[QS / 4], hi[QS / 4], lo[QS / 4];  // P^T, dS^T's parts: the A fragments
  const PingPong turn{wg};
  turn.start();
  if (n_steps > 0) {
    hopper::mbar_wait<true>(ld.ownbar, 0);
    // S^T = K Q^T and dP^T = V dO^T of this warpgroup's keys.
    auto issue_a = [&](int it) {
      hopper::wgmma_fence();
      issue_ss<D, QS, kOwnRows>(sc, k_tile, wg * kWgRows, ld.tile_a(it));
      hopper::wgmma_commit();
      issue_ss<D, QS, kOwnRows>(dp, v_tile, wg * kWgRows, ld.tile_b(it));
      hopper::wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q, the A operands from registers.
    auto issue_b = [&](int it) {
      hopper::wgmma_fence();
      issue_rs<D, QS>(acc_v, pa, ld.tile_b(it));
      issue_rs_split<D, QS>(acc_k, lo, hi, ld.tile_a(it));
      hopper::wgmma_commit();
    };
    auto retire = [&](int it) {
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      hopper::fence_regs(pa);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      ld.release(it, lane);
    };
    auto form = [&](int it) {
      const int q0 = step_at(it).y;
      const float* lse_s = ld.rows(it);  // lse times log2 e, 0 past S
      const float* delta_s = lse_s + QS;  // D, 0 past S
      // Wholly or partly masked for this warpgroup: causal diagonal steps,
      // rows or keys past S (a step wholly masked for warpgroup 1, the
      // first of a causal key tile, runs on zeros of P).
      const bool masked = q0 + QS > S || kw0 + kWgRows > S || (causal && q0 < kw0 + kWgRows - 1);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
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
            if (query >= S || key >= S || (causal && key > query)) p = 0.f;
          }
          sc[4 * c + e] = p;
        }
      }
      hopper::wgmma_wait<0>();
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
      pack_frag<QS>(sc, pa);  // P rounded to bf16, as K6's P . V takes it
      split_acc<QS>(dp, hi, lo);
    };
    pipelined_steps<(D <= 80)>(ld, turn, n_steps, issue_a, issue_b, form, retire);
  }

  // dK, dV [B, S, Hkv, D] contiguous: rows key_a (+ 8), columns 8c + 2 t4
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= S) continue;
    const long long at = (((long long)b * S + key) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * c) =
          pack_bf16(acc_k[4 * c + 2 * half] * scale, acc_k[4 * c + 2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
          pack_bf16(acc_v[4 * c + 2 * half], acc_v[4 * c + 2 * half + 1]);
    }
  }
}

// dQ: a CTA per (128-row query tile, head, b), longest first, warpgroup w
// owning rows 64w.. of it; the steps are the key tiles of kKeyStep up to the
// CTA's diagonal, in order.  `rows` as the dK/dV kernel's.
template <int D>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                                        const float* __restrict__ rows, long long plane,
                                        __nv_bfloat16* __restrict__ dq, long long S_, int H,
                                        int Hkv, int causal, float scale) {
  constexpr int KS = kKeyStep;
  using Sm = BwdSmem<D, KS>;
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sm::kBar);
  const int S = (int)S_;
  const int i = (int)(gridDim.x - 1 - blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const Loader<D, KS> ld{maps, smem, full, full + kStagesBwd, full + 2 * kStagesBwd, b};
  const int hk = h / (H / Hkv);
  const int q0 = i * kOwnRows;
  const int kv_end = causal ? (q0 + kOwnRows < S ? q0 + kOwnRows : S) : S;
  const int n_k = (kv_end + KS - 1) / KS;
  auto step_at = [&](int it) { return make_int2(hk, it * KS); };
  ld.init();
  if (threadIdx.x >= 128 * kConsumersBwd) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumersBwd)
      ld.produce(h, q0, n_k, step_at, [](int) { return (const float*)nullptr; }, 0);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int qw0 = q0 + wg * kWgRows;  // this warpgroup's first query row
  const int row_a = qw0 + warp * 16 + (lane >> 2);  // accumulator rows row_a, row_a + 8
  const float scale_log2 = scale * kLog2eBwd;
  const uint32_t q_tile = hopper::smem_u32(smem + Sm::kOwnA);
  const uint32_t g_tile = hopper::smem_u32(smem + Sm::kOwnB);
  const long long sp = (long long)((S + kQueryStep - 1) / kQueryStep) * kQueryStep;
  float lse_r[2], delta_r[2];  // the two rows' lse (times log2 e) and D; 0 past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const long long at_row = ((long long)b * H + h) * sp + row;
    lse_r[r] = row < S ? rows[at_row] : 0.f;
    delta_r[r] = row < S ? rows[plane + at_row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float sc[KS / 2], dp[KS / 2];  // S, then P; dP, then dS
  uint32_t hi[KS / 4], lo[KS / 4];  // dS's parts: the A fragments
  const PingPong turn{wg};
  turn.start();
  hopper::mbar_wait<true>(ld.ownbar, 0);
  // S = Q K^T and dP = dO V^T of this warpgroup's rows.
  auto issue_a = [&](int jt) {
    hopper::wgmma_fence();
    issue_ss<D, KS, kOwnRows>(sc, q_tile, wg * kWgRows, ld.tile_a(jt));
    hopper::wgmma_commit();
    issue_ss<D, KS, kOwnRows>(dp, g_tile, wg * kWgRows, ld.tile_b(jt));
    hopper::wgmma_commit();
  };
  auto issue_b = [&](int jt) {  // dQ += dS K
    hopper::wgmma_fence();
    issue_rs_split<D, KS>(acc, lo, hi, ld.tile_a(jt));
    hopper::wgmma_commit();
  };
  auto retire = [&](int jt) {
    hopper::fence_regs(acc);
    hopper::fence_regs(hi);
    hopper::fence_regs(lo);
    ld.release(jt, lane);
  };
  auto form = [&](int jt) {
    const int k0 = jt * KS;
    // Wholly or partly masked for this warpgroup: the diagonal's key tiles
    // (warpgroup 0's last one wholly: it runs on zeros of P), keys or rows
    // past S.
    const bool masked = k0 + KS > S || qw0 + kWgRows > S || (causal && k0 + KS - 1 > qw0);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    // P: rows row_a (+ 8) x keys k0 + 8c + 2 t4 (+ 1), while dP runs
#pragma unroll
    for (int c = 0; c < KS / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = hopper::ex2(fmaf(sc[4 * c + e], scale_log2, -lse_r[e >> 1]));
        if (masked) {
          const int row = row_a + 8 * (e >> 1);
          const int key = k0 + 8 * c + 2 * t4 + (e & 1);
          if (row >= S || key >= S || (causal && key > row)) p = 0.f;
        }
        sc[4 * c + e] = p;
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int e = 0; e < KS / 2; ++e) {  // a masked p is 0: so is its dS (dP, D finite)
      const float p = sc[e];
      dp[e] = p * (dp[e] - delta_r[(e >> 1) & 1]);
    }
    split_acc<KS>(dp, hi, lo);
  };
  pipelined_steps<true>(ld, turn, n_k, issue_a, issue_b, form, retire);

  // dQ [B, S, H, D] contiguous: rows row_a (+ 8), columns 8c + 2 t4
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= S) continue;
    const long long at = (((long long)b * S + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * c) =
          pack_bf16(acc[4 * c + 2 * half] * scale, acc[4 * c + 2 * half + 1] * scale);
  }
}

// The maps of one tile role: dh 80 and 16 one map of 16-column boxes in
// [1]; else 64-column boxes in [0] (none at dh 32: a box wider than the
// tensor's rows) and, at dh 96 and 32, 32-column ones in [1].
template <int D>
int make_maps(CUtensorMap (&m)[2], const void* p, long long B, long long S, int heads,
              long long sb, long long ss, long long sh, int rows) {
  using T = TileBf16<D>;
  if constexpr (T::kChunked) return make_map(&m[1], p, B, S, heads, D, sb, ss, sh, 16, rows);
  int err = T::kMain ? make_map(&m[0], p, B, S, heads, D, sb, ss, sh, 64, rows) : 0;
  if (!err && T::kRem) err = make_map(&m[1], p, B, S, heads, D, sb, ss, sh, T::kRem, rows);
  return err;
}

// The maps of both passes: the dK/dV pass's (K, V owned; Q, dO streamed)
// and the dQ pass's (Q, dO owned; K, V streamed).
template <int D>
int make_maps_bwd(BwdMaps& mkv, BwdMaps& mq, const void* q, const void* k, const void* v,
                  const void* g, long long B, long long S, int H, int Hkv, const Strides& st) {
  int err = make_maps<D>(mkv.own_a, k, B, S, Hkv, st.kb, st.ks, st.kh, kOwnRows);
  if (!err) err = make_maps<D>(mkv.own_b, v, B, S, Hkv, st.vb, st.vs, st.vh, kOwnRows);
  if (!err) err = make_maps<D>(mkv.step_a, q, B, S, H, st.qb, st.qs, st.qh, kQueryStep);
  if (!err) err = make_maps<D>(mkv.step_b, g, B, S, H, st.gb, st.gs, st.gh, kQueryStep);
  if (!err) err = make_maps<D>(mq.own_a, q, B, S, H, st.qb, st.qs, st.qh, kOwnRows);
  if (!err) err = make_maps<D>(mq.own_b, g, B, S, H, st.gb, st.gs, st.gh, kOwnRows);
  if (!err) err = make_maps<D>(mq.step_a, k, B, S, Hkv, st.kb, st.ks, st.kh, kKeyStep);
  if (!err) err = make_maps<D>(mq.step_b, v, B, S, Hkv, st.vb, st.vs, st.vh, kKeyStep);
  return err;
}

// Both bf16 kernels' dynamic shared memory at head dim D, set once a device.
template <int D>
cudaError_t set_smem_once() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       BwdSmem<D, kQueryStep>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BwdSmem<D, kKeyStep>::kBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// D, then dK/dV, then dQ on one stream, bf16: the wgmma kernels.  The
// scratch holds the D launch's rows: lse times log2 e, then D, each [B, H,
// Sp] with Sp = S rounded up to kQueryStep (0 past S), so that every step
// bulk-loads whole rows.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* g,
                const float* lse, float* scratch, void* dq, void* dk, void* dv, long long B,
                long long S, int H, int Hkv, int causal, const Strides& st,
                cudaStream_t stream) {
  BwdMaps mkv = {}, mq = {};  // the dK/dV pass's and the dQ pass's (unused maps empty)
  int err = make_maps_bwd<D>(mkv, mq, q, k, v, g, B, S, H, Hkv, st);
  if (err) return err;
  cudaError_t e = set_smem_once<D>();
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)D);
  const unsigned tiles = (unsigned)((S + kOwnRows - 1) / kOwnRows);
  const long long sp = (S + kQueryStep - 1) / kQueryStep * kQueryStep;
  const long long plane = B * H * sp;
  constexpr int rows = DeltaPlan<__nv_bfloat16, D>::kRows;
  const dim3 grid_rows((unsigned)((sp + rows - 1) / rows), (unsigned)H, (unsigned)B);
  flash_attention_bwd_delta_kernel<__nv_bfloat16, D><<<grid_rows, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)g, lse, scratch, S, sp, H, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dkdv_wgmma_kernel<D>
      <<<dim3(tiles, (unsigned)Hkv, (unsigned)B), kThreadsBwd,
         BwdSmem<D, kQueryStep>::kBytes, stream>>>(mkv, scratch, plane, (__nv_bfloat16*)dk,
                                                   (__nv_bfloat16*)dv, S, H, Hkv, causal,
                                                   scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dq_wgmma_kernel<D>
      <<<dim3(tiles, (unsigned)H, (unsigned)B), kThreadsBwd, BwdSmem<D, kKeyStep>::kBytes,
         stream>>>(mq, scratch, plane, (__nv_bfloat16*)dq, S, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// Host time of a bf16 call's parts, in ns a call over `reps` calls: [0] the
// eight maps encoded afresh (cuTensorMapEncodeTiled each), [1] the two
// shared-memory attributes set (cudaFuncSetAttribute), as every call of PR
// 35's design did both; [2] the maps as a call makes them now (copied from
// the cache, the address replaced), [3] the attributes as a call checks
// them now.  Launches nothing.
template <int D>
int host_parts_bf16(const void* q, const void* k, const void* v, const void* g, long long B,
                    long long S, int H, int Hkv, const Strides& st, int reps, long long* ns) {
  using clock = std::chrono::steady_clock;
  using T = TileBf16<D>;
  BwdMaps mkv = {}, mq = {};
  int err = 0;
  auto per_call = [&](clock::time_point t0) {
    return (long long)(std::chrono::duration_cast<std::chrono::nanoseconds>(clock::now() - t0)
                           .count() / reps);
  };
  // The roles' tensors, heads, strides and rows, as make_maps_bwd takes them.
  struct Role {
    CUtensorMap* m;
    const void* p;
    int heads;
    long long sb, ss, sh;
    int rows;
  };
  const Role roles[8] = {{mkv.own_a, k, Hkv, st.kb, st.ks, st.kh, kOwnRows},
                         {mkv.own_b, v, Hkv, st.vb, st.vs, st.vh, kOwnRows},
                         {mkv.step_a, q, H, st.qb, st.qs, st.qh, kQueryStep},
                         {mkv.step_b, g, H, st.gb, st.gs, st.gh, kQueryStep},
                         {mq.own_a, q, H, st.qb, st.qs, st.qh, kOwnRows},
                         {mq.own_b, g, H, st.gb, st.gs, st.gh, kOwnRows},
                         {mq.step_a, k, Hkv, st.kb, st.ks, st.kh, kKeyStep},
                         {mq.step_b, v, Hkv, st.vb, st.vs, st.vh, kKeyStep}};
  auto encode = [&](const Role& x, int j, int cols) {
    if (!err)
      err = tensor_map::encode_map(&x.m[j], x.p, B, S, x.heads, D, x.sb, x.ss, x.sh, cols,
                                   x.rows);
  };
  auto t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    for (const Role& x : roles) {  // make_maps' boxes
      if (T::kChunked) encode(x, 1, 16);
      if (!T::kChunked && T::kMain) encode(x, 0, 64);
      if (!T::kChunked && T::kRem) encode(x, 1, T::kRem);
    }
  ns[0] = per_call(t0);
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r) {
    err = (int)cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    BwdSmem<D, kQueryStep>::kBytes);
    if (!err)
      err = (int)cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel<D>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      BwdSmem<D, kKeyStep>::kBytes);
  }
  ns[1] = per_call(t0);
  if (!err) err = make_maps_bwd<D>(mkv, mq, q, k, v, g, B, S, H, Hkv, st);  // fills the cache
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    err = make_maps_bwd<D>(mkv, mq, q, k, v, g, B, S, H, Hkv, st);
  ns[2] = per_call(t0);
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r) err = (int)set_smem_once<D>();
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
      (const float*)o, (const float*)g, nullptr, delta, S, S, H, st);
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
// bf16: lse times log2 e and D, each [B, H, S rounded up to 64]); dq [B, S,
// H, D], dk and dv [B, S, Hkv, D] contiguous outputs in q's dtype.  D in
// {16, 32, 64, 80, 96, 128} for both dtypes.  Three launches on `stream`;
// returns the first nonzero cudaGetLastError(), else 0.
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
