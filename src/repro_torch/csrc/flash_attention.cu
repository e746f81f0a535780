// Kernel K6: causal or full GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel (pallas_call at :99) whose grid (B, H, S/bq, S/bk) runs its KV
// axis in order on one core and carries the online-softmax state (m, l, acc)
// in VMEM scratch from one grid step to the next.
//
//   s = (q . k) / sqrt(dh) in f32, masked to -1e30 where a key lies in the
//   future (causal) or past the sequence; m, l, acc updated online;
//   p rounded to v's dtype before p . v; out = acc / max(l, 1e-30) in q's dtype.
//   Query head h reads KV head h / (H / Hkv): GQA by index, KV never repeated.
//   For training, each row's logsumexp m + log l (natural log, scaled scores)
//   goes to an optional [B, H, S] f32 output that the backward kernel K6'
//   (flash_attention_backward.cu) reads; without it the launch is the
//   serving one, unchanged.  Head dims 16, 32, 64, 80, 96 and 128 in both
//   dtypes (16 and 32: the LM trainer's lm-small and the registry's smoke
//   configs, which the reference runs in bf16 compute by default).
//
// What bounds it on the card: operations.  Every valid (q, k) pair costs
// 4 * dh FLOP (q . k and p . v) against 2 * dh bytes of K and V that a
// 128-row query tile shares, so at S = 4096, dh = 80 in bf16 the kernel does
// about 2,000 FLOP per byte of device memory, far above the card's ridge of
// about 295 (989 TFLOP/s bf16 over 3.35 TB/s): the tensor cores set the floor,
// and only wgmma reaches their full rate.
//
// What the design does about it (bf16, FlashAttention-3 class):
//  * A persistent, warp-specialised CTA of 384 threads, one an SM (the
//    launch bound's 168 registers a thread fill its register file): the
//    grid is the SM count, or the number of work units where there are
//    fewer, and each CTA walks a static list of work tiles of 128 query
//    rows of one (batch, head) (Walk: units c, c + gridDim.x, ...).  Causal
//    tiles go in pairs, q-tile n - 1 - p then p, so that every unit costs
//    n + 1 KV tiles and the static walk balances (at stablelm-3b's prefill
//    the CTAs' loads differ by one pair); (b, h) is the slower index, so the
//    units that run together share a few heads' K and V in L2 (by head
//    alone, no pairs: 6-36% slower at the long layers, k6_persistent.json).
//    No atomic counter: the order of tiles does not depend on timing.
//  * Warpgroup 2 is the producer: one thread loads each work tile's Q by TMA
//    into one of two Q buffers (one at dh 128) and keeps K and V tiles of
//    128 keys in flight (cp.async.bulk.tensor) in a ring of 3 stages, each
//    stage and each Q buffer with a full and an empty mbarrier.  It runs
//    ahead across work tiles: the next tile's Q and first K/V land while the
//    consumers finish this one.  Warpgroups 0 and 1 are consumers of 64
//    query rows each.  At dh 128 a second Q buffer and a third stage do not
//    fit in 227 KB together; 3 stages and one Q buffer ran faster than 2
//    and 2, and 2 stages lost at dh 80 too (k6_persistent.json; the
//    launch-per-tile design of before: k6_stages.json; the figures are in PERF.md).
//  * Registers.  setmaxnreg lowers the producer to 40 registers and raises
//    the consumers to 232, the split FlashAttention-3 makes.  ptxas gives the
//    code after setmaxnreg.inc those registers only where no trap sits in it
//    inline: every wait here traps out of line (hopper::mbar_wait<true>),
//    as K6''s do; with the inline trap the consumers stayed within the
//    launch bound's 168.  The overlap below needs the room: S (64), P (32)
//    and O (dh / 2) are live together.
//  * Overlap within a warpgroup.  For KV tile i the consumer issues S_i =
//    Q . K_i^T and then O += P_{i-1} . V_{i-1} behind it, waits for S_i
//    alone (wgmma.wait_group 1) and runs tile i's softmax while the tensor
//    cores run the previous tile's P . V; once that is in it rescales O by
//    tile i's factors and packs P_i.  O sees the same operations in the
//    same order as when each P . V followed its own softmax: rescale by
//    tile i's factors, then add P_i . V_i.  Across work tiles the same: a
//    tile's last P . V goes behind the next tile's first S, and its output
//    goes out under that tile's first softmax.  Every product is issued
//    and waited on unconditionally (the CTA's first tile is peeled): under
//    a runtime condition ptxas serialises wgmma (C7515).
//  * Overlap across the two warpgroups (kPingPong, FlashAttention-3's
//    ping-pong): each issues its products in turn, on named barriers 3 and
//    4, so that one's softmax runs under the other's products: 13-17%
//    faster at the long layers, 1-2% at the trainer's (k6_pingpong.json).
//  * S = Q . K^T is wgmma m64n128k16 with A and B from shared memory, dh / 16
//    steps (5 at dh 80).  The online softmax runs in registers on the
//    accumulator layout: each thread holds 2 rows x 32 keys, a row's max and
//    sum reduce over its quad with two shuffles, l stays a per-thread partial
//    sum until the end, and the 1/sqrt(dh) scale folds into one FMA before
//    each ex2.  p is rounded to bf16 for P . V (l comes from the unrounded
//    p, as in the Pallas kernel).  The accumulator of key columns
//    16kk..16kk+15 packs, two values per register, into exactly the A
//    fragment of k-step kk, so P never leaves registers: O += P . V is wgmma
//    with A from registers and V as B from shared memory, transposed by the
//    descriptor's transpose bit (V's rows are keys, its contiguous axis dh is
//    wgmma's N).
//  * Causal: KV tiles wholly in the future are never loaded (a tile's loop
//    stops at its diagonal); only diagonal and ragged tiles pay for the
//    mask, one compare a score (mask_tile: 10% of the trainer's layer,
//    where every tile is a diagonal one).  Any S: TMA fills rows past S
//    with zeros and the ragged tile masks its keys; rows past S are not
//    stored.  Each thread stores its own pairs of output columns from
//    registers, in the [B, S, H, dh] layout and q's dtype, and a tile's Q
//    buffer goes back to the producer once its last S product is in
//    (staging the output through the Q buffer in 16-byte stores ran
//    level at dh 80 and 1.5x slower at the trainer's layer).
//  * Host: a call's six tensor maps come from a cache by shape, strides and
//    box (tensor_map.cuh: cuTensorMapReplaceAddress gives a copy the call's
//    address), and the shared-memory attribute is set once a device; the
//    host time of both, before and after, is what
//    flash_attention_bf16_host_ns measures (PERF.md).
//
// Where the trouble was, and how it was met:
//  * dh = 80 and swizzling.  A row of 80 bf16 is 160 bytes, more than the
//    128-byte swizzle span.  A tile is stored as regions, one TMA box each:
//    dh / 64 regions of 64 columns (128-byte rows, 128-byte swizzle) and,
//    where dh % 64 is 16 or 32, one region of the rest (32- or 64-byte rows,
//    that span's swizzle).  dh 16 and 32 are that remainder region alone
//    (no 64-column region, and no 64-column tensor map: its box would be
//    wider than the tensor's rows).  Q and K are K-major (dh, the reduction axis,
//    contiguous): a k-step of 16 columns in a 64-column region advances the
//    descriptor's start by 32 B inside the swizzle atom, SBO = 8 rows of
//    128 B; in the remainder region SBO = 8 rows of its span.  V is
//    MN-major: each 64-column region is one n64 product (SBO = 8 keys of
//    128 B, 2 KB per k-step of 16 keys) and the rest an n32 product; at dh
//    80, V stays in five 16-column regions (32-byte swizzle: SBO = 256 B,
//    LBO = one region, 512 B per k-step) so that P . V is one n80 product:
//    n64 + n16 ran slower (tools/kernel_variants/k6_v_layout.json; the
//    figures are in PERF.md).  At dh 16 and 32 P . V is one n16 or n32
//    product and S one k-step or two.  Nothing is padded to 128.
//    chip_smoke.py holds each layout against the plain version at every
//    head dim; tests/test_torch_k6_swizzle.py models the swizzles and
//    checks each descriptor against the boxes the producer wrote.
//  * Tensor maps need the driver API.  cuTensorMapEncodeTiled lives in
//    libcuda; the build links nothing, so the launch function fetches it
//    once through cudaGetDriverEntryPoint(ByVersion) from the runtime
//    (tensor_map.cuh, which K6' shares).  Maps are 4-D over (dh, heads, S,
//    B) with the caller's strides (which the wrapper checks are 16-byte
//    multiples, as TMA requires), made on the host in the launch function
//    (from the cache, with the call's addresses) and passed by value in a
//    __grid_constant__ struct, so a captured launch keeps its own.
//  * Accumulator layout.  wgmma's m64 accumulator is, warp by warp, the
//    mma.sync m16n8 layout stacked over 4 warps, and its register A fragment
//    is mma.sync's m16n8k16 one, so registers 8kk..8kk+7 of S pack into the
//    four A registers of P . V's k-step kk with no shuffle.
//  * Asynchronous registers.  wgmma reads its register operand and writes
//    its accumulator after the instruction issues; fence_regs pins them
//    around each wait, so the compiler neither reads S early nor reuses P's
//    registers while the product runs.
//  * Build: wgmma and setmaxnreg need sm_90a, which build.py targets; the
//    build phase of chip_smoke.py prints -Xptxas -v (registers, shared
//    memory, spills) for this file, and tools/kernel_variants.py the
//    registers each kernel's SASS names (the consumers' count past the
//    launch bound's).  The consumers hold S (64 f32), O (dh / 2 f32) and P
//    (32 registers); no head dim spills.
//
// f32 (flash_attention_f32_kernel): the reference holds f32 attention to
// 2e-5, and one TF32 product keeps about three decimal digits; scalar FMAs
// with a shared-memory load each reach about a quarter of the f32 rate.
// What bounds it on the card: the tensor cores' TF32 rate, three products
// of every pair (q . k and p . v), against which it moves 2 * dh * 4 bytes
// of K and V per key for 128 query rows.
// What the design does about it ("3xTF32"):
//  * Every operand is split as x = big + small, big the tf32 part of x (its
//    low 13 mantissa bits cleared) and small the rest, which the tensor
//    core reads truncated to tf32; a product is small . big + big . small +
//    big . big in f32 on mma.sync.m16n8k8 (hopper::mma_3xtf32), which keeps
//    every product of two f32 values to about 3 * 2^-20 of itself.  The
//    split is a mask and a subtraction: with cvt.rna.tf32 instead the kernel
//    took 8.27 ms at the path shape, not 5.65 (PERF.md).
//    tests/test_torch_attention.py emulates the products in numpy: they meet
//    2e-5 where one does not.
//  * mma.sync, not wgmma: tf32 wgmma takes only K-major operands and V is
//    stored with dh contiguous (MN-major for P . V); mma.sync's fragments are
//    loaded by hand, so nothing is transposed.
//  * A CTA of 8 warps owns 128 query rows of one (batch, head), 16 a warp.
//    K and V come through a 2-stage ring of cp.async copies (zero-filled
//    past S) in 64-key tiles, so the next tile's copy runs under this one's
//    products.  Q is read once into registers at every dh and split per
//    k-step; K and V are split as their fragments leave shared memory, P in
//    registers after the softmax.  At dh 128 ptxas spills 64 bytes; Q in
//    shared memory there had no spill and ran 6.4% faster, but no path runs
//    f32 at dh 128, so one Q path serves every dh (PERF.md, ROADMAP).
//  * Fragment orders that need no shuffle.  The order of a reduction is
//    free as long as both operands follow it: S's k-steps take head dims
//    16p + 4t + {0, 1} and {2, 3}, so a lane reads Q and K as 16-byte
//    pieces; P . V's k-step j takes keys 8j + 2t and 8j + 2t + 1 as columns t
//    and t + 4, so S's accumulator registers are P's A fragment as they
//    stand (the m16n8 accumulator is not the tf32 A layout), and V's B
//    fragment reads rows 8j + 2t, 8j + 2t + 1.  Row pitches of D + 16 (D at
//    dh 80) and D + 4 floats keep both loads free of bank conflicts.
//  * The online softmax is the bf16 kernel's (softmax_tile), on one tile;
//    p stays f32 (as its two tf32 parts); out = acc / max(l, 1e-30).
//  * Causal: the CTA's loop stops at its diagonal, and a warp skips a tile
//    whose keys all lie after its rows.  Rows are read (16-byte pieces) and
//    written through the caller's strides, which the wrapper checks are
//    16-byte multiples; offsets are 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // query rows per consumer warpgroup (bf16)
constexpr long long kMaxSeq = (1LL << 31) - 256;  // positions (and TMA coordinates) are int32

struct Strides {  // element strides of the [B, S, H, dh] tensors
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ------------------------------------------------------------------ bf16

constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreadsBf16 = 128 * (kConsumers + 1);
constexpr int kRowsCta = kBQ * kConsumers;  // query rows of a work tile
constexpr int kBKV = 128;  // keys per KV tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kCtasPerSm = 1;  // the launch bound's: 384 threads of 168 registers fill an SM
// The consumer warpgroups take turns to issue their products (named
// barriers 3 and 4), so that one's softmax runs under the other's products
// (FlashAttention-3's ping-pong); false, the variant of k6_pingpong.json,
// has each issue as soon as its K/V tile is in.
constexpr bool kPingPong = true;

// A tile of `rows` rows of dh bf16 is stored as kMain regions of 64 columns
// (128-byte rows, 128-byte swizzle) and, where dh % 64 = 16 or 32, one
// region of the remaining kRem columns (32- or 64-byte rows, the swizzle of
// that span): [region][rows][span], each region a TMA box of its own.
template <int D>
struct Layout {  // shared memory, from a 1024-byte aligned base
  static constexpr int kMain = D / 64;
  static constexpr int kRem = D % 64;  // 0, 16 or 32
  // dh 80 keeps V in 16-column regions (32-byte swizzle), so that P . V is
  // one n80 product (a 64-column region plus an n16 product ran slower on
  // the card: k6_v_layout.json); dh 96 splits P . V into n64 and n32
  // products; dh 16 and 32 are one n16 or n32 product on the remainder.
  static constexpr bool kVChunked = D == 80;
  static_assert(kRem == 0 || kRem == 16 || kRem == 32, "dh in 16, 32, 64, 80, 96, 128");
  // K/V ring depth.  At dh 128 a third stage and a second Q buffer do not
  // fit in 227 KB together: 3 stages and one Q buffer ran faster there than
  // 2 and 2 (k6_persistent.json), the next tile's Q landing once this one's
  // output is out.
  static constexpr int kStages = 3;
  // Q buffers: the next work tile's Q lands while this one's is in use.  A
  // buffer goes back to the producer as soon as the tile's last S product
  // is in: the output is stored from registers, not staged there.
  static constexpr int kQBufs = D == 128 ? 1 : 2;
  static constexpr int kQBytes = kBQ * D * 2;  // one warpgroup's Q
  static constexpr int kQTile = kConsumers * kQBytes;  // a work tile's Q
  static constexpr int kKVBytes = kBKV * D * 2;  // one K or V tile
  static constexpr int kK = kQBufs * kQTile;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 2 * kQBufs) * 8 + 1024;  // + alignment slack
};

// The tensor maps of q, k and v: [0] boxes of 64 columns (none at dh 16 and
// 32), [1] of kRem (of 16 for dh 80's V).
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

// The work of a launch: tiles of kRowsCta query rows of one (b, h), n_qt a
// (b, h).  A CTA takes a unit at a time.  Causal, a unit is the pair of
// q-tiles n_qt - 1 - p (the heavier, first) and p, n_qt + 1 KV tiles
// together, so that units cost alike; the middle q-tile of an odd n_qt, and
// every q-tile of full attention (the last first), are units of one tile,
// after all the pairs.  (b, h) is the slower index of each kind, so that
// the units that run together share a few heads' K and V in L2.  CTA c
// takes units c, c + gridDim.x, ... (flash_attention.py's k6_walk is its
// twin).
struct Walk {
  int n_qt, pairs, singles, H;
  long long bh;  // B * H
  __host__ __device__ Walk(long long B, long long S, int heads, int causal)
      : n_qt((int)((S + kRowsCta - 1) / kRowsCta)), pairs(causal ? n_qt / 2 : 0),
        singles(n_qt - 2 * pairs), H(heads), bh(B * heads) {}
  __host__ __device__ long long units() const { return bh * (pairs + singles); }
  __host__ __device__ int tiles(long long u) const { return u < bh * pairs ? 2 : 1; }
  // Tile k of unit u: its b, h and q-tile (in 32-bit arithmetic where the
  // units fit: a 64-bit division costs the walk more than the rest of it).
  __host__ __device__ void tile(long long u, int k, int& b, int& h, int& qt) const {
    if (units() < (1LL << 31)) tile_as<unsigned>((unsigned)u, k, b, h, qt);
    else tile_as<unsigned long long>((unsigned long long)u, k, b, h, qt);
  }
  template <typename I>
  __host__ __device__ void tile_as(I u, int k, int& b, int& h, int& qt) const {
    const I paired = (I)bh * (I)pairs;
    I bh_;
    if (u < paired) {
      bh_ = u / (I)pairs;
      const int p = (int)(u - bh_ * (I)pairs);
      qt = k == 0 ? n_qt - 1 - p : p;
    } else {
      const I v = u - paired;
      bh_ = v / (I)singles;
      qt = n_qt - 1 - pairs - (int)(v - bh_ * (I)singles);
    }
    b = (int)(bh_ / (I)H);
    h = (int)(bh_ - (I)b * (I)H);
  }
};

// KV tiles a work tile reads: up to its diagonal (causal) or all of S.
__device__ __forceinline__ int kv_tiles(long long q0, long long S, int causal) {
  const long long end = causal ? (q0 + kRowsCta < S ? q0 + kRowsCta : S) : S;
  return (int)((end + kBKV - 1) / kBKV);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q . K^T for one warpgroup.  Both operands are K-major (dh, the
// reduction axis, contiguous); k-step c takes 16 columns (32 bytes): in a
// 64-column region the start advances 32 bytes inside the 128-byte swizzle
// atom, SBO = 8 rows of 128 B; in the remainder region the start is the
// region (+ 32 B for the second step of a 64-byte span), SBO = 8 rows of it.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
  using Ly = Layout<D>;
  hopper::wgmma_fence();  // the first k-step ignores sc's old values (scale-d 0)
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    if (c < 4 * Ly::kMain) {
      const uint32_t off_q = (c / 4) * kBQ * 128 + (c % 4) * 32;
      const uint32_t off_k = (c / 4) * kBKV * 128 + (c % 4) * 32;
      hopper::wgmma_ss_m64n128<0, 0>(sc, hopper::desc<128>(q_addr + off_q, 16, 1024),
                                     hopper::desc<128>(k_addr + off_k, 16, 1024), c > 0);
    } else if constexpr (Ly::kRem > 0) {
      constexpr int span = Ly::kRem * 2;  // bytes per row of the remainder region
      const uint32_t cc = (c - 4 * Ly::kMain) * 32;
      const uint32_t q_rem = q_addr + Ly::kMain * kBQ * 128 + cc;
      const uint32_t k_rem = k_addr + Ly::kMain * kBKV * 128 + cc;
      hopper::wgmma_ss_m64n128<0, 0>(sc, hopper::desc<span>(q_rem, 16, 8 * span),
                                     hopper::desc<span>(k_rem, 16, 8 * span), c > 0);
    }
  }
  hopper::wgmma_commit();
}

// O += P . V: P from registers; V is MN-major (dh, wgmma's N, contiguous), so
// the transpose bit is set.  Each 64-column region is one n64 product (SBO =
// 8 keys of 128 B, a k-step of 16 keys advances 2 KB), the remainder one n16
// or n32 product (SBO = 8 keys of its span); O's registers follow dh in
// order, 32 for each region and kRem / 2 for the remainder.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[32],
                                         uint32_t v_addr) {
  using Ly = Layout<D>;
  constexpr int span = Ly::kRem * 2;
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    const uint32_t(&a)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]);
    if constexpr (Ly::kVChunked) {
      // 16-column regions of kBKV rows x 32 B: LBO = one region, SBO = 8 keys.
      const uint64_t b = hopper::desc<32>(v_addr + kk * 16 * 32, kBKV * 32, 256);
      hopper::wgmma_rs_m64n80<1>(acc, a, b);
      continue;
    }
#pragma unroll
    for (int j = 0; j < Ly::kMain; ++j)
      hopper::wgmma_rs_m64n64<1>(
          *reinterpret_cast<float(*)[32]>(&acc[32 * j]), a,
          hopper::desc<128>(v_addr + j * kBKV * 128 + kk * 16 * 128, kBKV * 128, 1024));
    if constexpr (Ly::kRem > 0) {
      const uint32_t v_rem = v_addr + Ly::kMain * kBKV * 128 + kk * 16 * span;
      float(&rem)[Ly::kRem / 2] =
          *reinterpret_cast<float(*)[Ly::kRem / 2]>(&acc[32 * Ly::kMain]);
      if constexpr (Ly::kRem == 16)
        hopper::wgmma_rs_m64n16<1>(rem, a, hopper::desc<32>(v_rem, kBKV * span, 8 * span));
      else
        hopper::wgmma_rs_m64n32<1>(rem, a, hopper::desc<64>(v_rem, kBKV * span, 8 * span));
    }
  }
  hopper::wgmma_commit();
}

// One tile's online softmax on the raw scores of rows row_a, row_b: 2N keys
// in the m16n8 accumulator layout, N / 4 columns of 8 (the scale folds into
// one FMA per exponent: scale > 0, so the max of s is the max of s * scale).
// sc becomes p, unrounded; returns the rescale factors.  Both kernels use
// it: 128 keys a tile in bf16, 64 in f32.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], bool masked, int kv0, int row_a,
                                             int row_b, int S, int causal, int t4,
                                             float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1, float& a0,
                                             float& a1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (masked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * j + 2 * t4 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        if (key >= S || (causal && key > row)) sc[4 * j + e] = kNegInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  a0 = hopper::ex2(m0 - mn0);
  a1 = hopper::ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], scale_log2, -mn0));
    sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
    sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
    sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
    rs0 += sc[4 * j] + sc[4 * j + 1];
    rs1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + rs0;  // l from the unrounded p, as the Pallas kernel
  l1 = l1 * a1 + rs1;
}

// The bf16 kernel's mask of KV tile kv0's raw scores (rows row_a, row_b;
// 2N keys in the accumulator layout): a key past S, or after its row where
// causal, becomes -1e30, as softmax_tile's own mask makes it, with one
// compare a score: its key less kv0 + 2 t4, a constant of the unrolled
// loop, against the row's last key less the same.
template <int N>
__device__ __forceinline__ void mask_tile(float (&sc)[N], int kv0, int row_a, int row_b, int S,
                                          int causal, int t4) {
  const int base = kv0 + 2 * t4;
  const int lim_a = (causal && row_a < S - 1 ? row_a : S - 1) - base;
  const int lim_b = (causal && row_b < S - 1 ? row_b : S - 1) - base;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + (e & 1) > (e < 2 ? lim_a : lim_b)) sc[4 * j + e] = kNegInf;
  }
}

// The accumulator of key columns 16kk..16kk+15, rounded to bf16, is the A
// fragment of P . V's k-step kk: pa[4kk..4kk+3].
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= a0;
    acc[4 * j + 1] *= a0;
    acc[4 * j + 2] *= a1;
    acc[4 * j + 3] *= a1;
  }
}

// Rows row_a and row_b of one (b, h)'s [S] logsumexp, from the running max
// m (log2 units of the scaled score) and the quad-summed l: ln of the sum of
// exp(s / sqrt(dh)) over the row's keys, m ln 2 + ln l (K6's backward, K6',
// reads it; the serving launch passes no pointer and skips this).  ln l on
// the special-function unit (within about 2^-22 of the exact logarithm, far
// inside the 2e-5 the logsumexp is held to): the f32 kernel's exact logf
// made the bf16 kernel's epilogue 1.7 us longer at the trainer's layer
// (tools/kernel_variants/k6_short.json).
__device__ __forceinline__ void store_lse(float* row0, int row_a, int row_b, int S, float m0,
                                          float m1, float l0, float l1, bool fast = false) {
  constexpr float kLn2 = 0.6931471805599453f;
  if (row_a < S) row0[row_a] = fmaf(m0, kLn2, fast ? __logf(l0) : logf(l0));
  if (row_b < S) row0[row_b] = fmaf(m1, kLn2, fast ? __logf(l1) : logf(l1));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_attention_bf16_kernel(const __grid_constant__ Maps maps,
                                __nv_bfloat16* __restrict__ o, long long S, int group,
                                int causal, float scale_log2, long long ob, long long os,
                                long long oh, float* __restrict__ lse, const Walk walk) {
  using Ly = Layout<D>;
  constexpr int ST = Ly::kStages;
  constexpr int QB = Ly::kQBufs;
  constexpr int NO = D / 2;  // O accumulator registers per thread
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Ly::kBar);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + QB;
  const long long n_units = walk.units();
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);  // the producer's arrive + the TMA bytes
      hopper::mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int j = 0; j < QB; ++j) {
      hopper::mbar_init(&qfull[j], 1);
      hopper::mbar_init(&qempty[j], 4 * kConsumers);  // the tile's output is out
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      // One box per region: kMain of 64 columns, then the remainder.
      auto load = [&](uint8_t* dst, const CUtensorMap* m, uint64_t* bar, int head, int row0,
                      int rows, int b) {
        for (int j = 0; j < Ly::kMain; ++j)
          hopper::tma_load_4d(dst + j * rows * 128, &m[0], bar, 64 * j, head, row0, b);
        if (Ly::kRem > 0)
          hopper::tma_load_4d(dst + Ly::kMain * rows * 128, &m[1], bar, 64 * Ly::kMain, head,
                              row0, b);
      };
      int it = 0, qi = 0;  // KV tiles and work tiles loaded so far
      for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int t = 0; t < walk.tiles(u); ++t, ++qi) {
          int b, h, qt;
          walk.tile(u, t, b, h, qt);
          const int hk = h / group;
          const long long q0 = (long long)qt * kRowsCta;
          const int n_kv = kv_tiles(q0, S, causal);
          // Q of this tile, once the tile QB before it has stored its output.
          const int qb = qi % QB;
          hopper::mbar_wait<true>(&qempty[qb], ((qi / QB) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&qfull[qb], Ly::kQTile);
          for (int w = 0; w < kConsumers; ++w)
            load(smem + qb * Ly::kQTile + w * Ly::kQBytes, maps.q, &qfull[qb], h,
                 (int)(q0 + w * kBQ), kBQ, b);
          for (int i = 0; i < n_kv; ++i, ++it) {
            const int s = it % ST;
            hopper::mbar_wait<true>(&empty[s], ((it / ST) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], 2 * Ly::kKVBytes);
            load(smem + Ly::kK + s * Ly::kKVBytes, maps.k, &full[s], hk, i * kBKV, kBKV, b);
            uint8_t* v_dst = smem + Ly::kV + s * Ly::kKVBytes;
            if (Ly::kVChunked) {
              for (int c = 0; c < D / 16; ++c)
                hopper::tma_load_4d(v_dst + c * kBKV * 32, &maps.v[1], &full[s], 16 * c, hk,
                                    i * kBKV, b);
            } else {
              load(v_dst, maps.v, &full[s], hk, i * kBKV, kBKV, b);
            }
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // accumulator row within the warp's 16
    const int t4 = lane & 3;  // accumulator column pair
    const int Sq = (int)S;  // positions fit in 32 bits (S <= kMaxSeq)

    float acc[NO];
    uint32_t pa[32];  // P in bf16, the A operand of P . V
    float sc[64];  // S of the current tile, then its p
    float a0, a1;
    float m0, m1, l0, l1;  // running max (log2 units) and this thread's sums, rows a and b
    auto k_addr = [&](int i) { return hopper::smem_u32(smem + Ly::kK + (i % ST) * Ly::kKVBytes); };
    auto v_addr = [&](int i) { return hopper::smem_u32(smem + Ly::kV + (i % ST) * Ly::kKVBytes); };
    auto release = [&](int i) {  // P . V of KV tile i has completed in this warp
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[i % ST]);
    };
    auto release_q = [&](int qb) {  // this warp is done with Q buffer qb
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&qempty[qb]);
    };
    // Ping-pong: a warpgroup issues after the other's last products.
    auto my_turn = [&] {
      if constexpr (kPingPong) hopper::named_barrier_sync(3 + wg, 2 * 128);
    };
    auto their_turn = [&] {
      if constexpr (kPingPong) hopper::named_barrier_arrive(4 - wg, 2 * 128);
    };
    if constexpr (kPingPong)
      if (wg == 1) hopper::named_barrier_arrive(3, 2 * 128);  // warpgroup 0 goes first

    // A work tile whose last P . V is still to come, its rows and its final
    // m and l: its output goes out once that product, issued behind the
    // next tile's first S, is in.
    struct Done {
      int b, h, qw0, kv;  // kv: its last KV tile, the P . V still to run
      float m0, m1, l0, l1;
    } prev = {};
    auto store_out = [&](const Done& d) {
      float l0_ = d.l0, l1_ = d.l1;
      l0_ += __shfl_xor_sync(0xffffffffu, l0_, 1);
      l0_ += __shfl_xor_sync(0xffffffffu, l0_, 2);
      l1_ += __shfl_xor_sync(0xffffffffu, l1_, 1);
      l1_ += __shfl_xor_sync(0xffffffffu, l1_, 2);
      const float inv0 = 1.f / fmaxf(l0_, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1_, 1e-30f);
      const int ra = d.qw0 + warp * 16 + g;
      if (lse != nullptr && t4 == 0)
        store_lse(lse + ((long long)d.b * walk.H + d.h) * S, ra, ra + 8, Sq, d.m0, d.m1, l0_,
                  l1_, true);
      __nv_bfloat16* oh_ = o + (long long)d.b * ob + (long long)d.h * oh;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        const int col = 8 * j + 2 * t4;
        if (ra < Sq)
          *reinterpret_cast<uint32_t*>(oh_ + (long long)ra * os + col) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (ra + 8 < Sq)
          *reinterpret_cast<uint32_t*>(oh_ + (long long)(ra + 8) * os + col) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    };

    // The tile in hand: its (b, h), KV tiles, rows and Q buffer.
    long long u = blockIdx.x;  // the walk's unit and its tile t, as the producer's loops
    int t = 0;
    int it = 0, qi = 0;  // KV tiles and work tiles consumed so far
    int b = 0, h = 0, n_kv = 0, qw0 = 0, row_a = 0, row_b = 0, qb = 0;
    uint32_t q_addr = 0;
    auto next_tile = [&]() -> bool {  // takes the CTA's next work tile, once its Q and K are in
      if (u >= n_units) return false;
      int qt;
      walk.tile(u, t, b, h, qt);
      if (++t == walk.tiles(u)) t = 0, u += gridDim.x;
      const long long q0 = (long long)qt * kRowsCta;
      n_kv = kv_tiles(q0, S, causal);
      qw0 = (int)q0 + wg * kBQ;  // this warpgroup's first query row
      row_a = qw0 + warp * 16 + g;
      row_b = row_a + 8;
      qb = qi % QB;
      q_addr = hopper::smem_u32(smem + qb * Ly::kQTile + wg * Ly::kQBytes);
      hopper::mbar_wait<true>(&qfull[qb], (qi / QB) & 1);
      hopper::mbar_wait<true>(&full[it % ST], (it / ST) & 1);
      return true;
    };
    auto softmax = [&](int i) {  // KV tile i's softmax: sc becomes p, a0 and a1 its factors
      const int kv0 = i * kBKV;
      if ((kv0 + kBKV > Sq) || (causal && kv0 + kBKV - 1 > qw0))
        mask_tile(sc, kv0, row_a, row_b, Sq, causal, t4);
      softmax_tile(sc, false, kv0, row_a, row_b, Sq, causal, t4, scale_log2, m0, m1, l0, l1, a0,
                   a1);
    };
    auto first_s_in = [&] {  // KV tile 0's S is in: its softmax, from a fresh m and l
      hopper::fence_regs(sc);
      if (n_kv == 1) release_q(qb);  // its only S product
      m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      softmax(0);
    };
    auto begin_o = [&] {  // O of the tile in hand from zero, P of its KV tile 0
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.f;
      pack_p(sc, pa);
    };
    // KV tiles 1.. of the tile in hand: S of tile i, then P . V of tile i - 1
    // behind it on the tensor cores while tile i's softmax runs; O is
    // rescaled by tile i's factors once that product is in: the same
    // operations on O, in the same order, as a product that follows its
    // own softmax.  Then the tile waits for its last P . V.
    auto rest = [&] {
      for (int i = 1; i < n_kv; ++i) {
        hopper::mbar_wait<true>(&full[(it + i) % ST], ((it + i) / ST) & 1);
        my_turn();
        issue_qk<D>(sc, q_addr, k_addr(it + i));
        issue_pv<D>(acc, pa, v_addr(it + i - 1));
        their_turn();
        hopper::wgmma_wait<1>();  // S of tile i is in
        hopper::fence_regs(sc);
        if (i == n_kv - 1) release_q(qb);  // the last S product is in
        softmax(i);
        hopper::wgmma_wait<0>();  // P . V of tile i - 1 is in
        release(it + i - 1);
        rescale(acc, a0, a1);
        pack_p(sc, pa);
      }
      prev = {b, h, qw0, it + n_kv - 1, 0.f, 0.f, 0.f, 0.f};
      it += n_kv;
      ++qi;
    };

    if (next_tile()) {
      // The CTA's first tile: S of its KV tile 0 alone.
      my_turn();
      issue_qk<D>(sc, q_addr, k_addr(it));
      their_turn();
      hopper::wgmma_wait<0>();
      first_s_in();
      begin_o();
      rest();
      // Each later tile: its first S, and behind it the previous tile's
      // last P . V, which runs under this tile's first softmax; then the
      // previous tile's output goes out.
      while (next_tile()) {
        my_turn();
        issue_qk<D>(sc, q_addr, k_addr(it));
        issue_pv<D>(acc, pa, v_addr(prev.kv));
        their_turn();
        hopper::wgmma_wait<1>();
        prev.m0 = m0, prev.m1 = m1, prev.l0 = l0, prev.l1 = l1;
        first_s_in();
        hopper::wgmma_wait<0>();
        release(prev.kv);
        store_out(prev);
        begin_o();
        rest();
      }
      // The last tile's last P . V, then its output.
      my_turn();
      hopper::wgmma_fence();
      issue_pv<D>(acc, pa, v_addr(prev.kv));
      their_turn();
      hopper::wgmma_wait<0>();
      release(prev.kv);
      prev.m0 = m0, prev.m1 = m1, prev.l0 = l0, prev.l1 = l1;
      store_out(prev);
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int kWarpsF32 = 8;  // each owns 16 query rows
constexpr int kThreadsF32 = 32 * kWarpsF32;
constexpr int kRowsF32 = 16 * kWarpsF32;  // query rows per CTA
constexpr int kStagesF32 = 2;  // cp.async ring of K and V tiles
constexpr int kBK = 64;  // keys per K and V tile

// Shared memory of the f32 kernel: kStagesF32 stages of a K tile [kBK][kLdK]
// and a V tile [kBK][kLdV] (floats; 147 KB at dh 128).  The row pitches keep
// the fragment loads free of bank conflicts: Q and K
// are read as 16-byte pieces, 8 lanes a phase over rows g, g + 1 and pieces
// t = 0..3 (kLdK = 16 mod 32 puts the two rows 16 banks apart); V as single
// floats at rows 2t, 2t + 1 and column g (kLdV = 4 mod 16 puts the four t 8
// banks apart).
template <int D>
struct LayoutF32 {
  static constexpr int kLdK = D % 32 == 16 ? D : D + 16;
  static constexpr int kLdV = D + 4;
  static constexpr int kStage = kBK * (kLdK + kLdV);  // floats
  static constexpr int kBytes = kStagesF32 * kStage * 4;
};

// The f32 kernel: 3xTF32 on mma.sync (the design note at the top).
template <int D>
__global__ void __launch_bounds__(kThreadsF32, 1)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, long long S, int group,
                               int causal, float scale_log2, Strides st,
                               float* __restrict__ lse) {
  using Ly = LayoutF32<D>;
  constexpr int ST = kStagesF32;
  constexpr int KP = D / 16;  // pairs of k-steps of S = Q . K^T
  constexpr int NV = D / 8;  // n-tiles of O
  constexpr int CH = D / 4;  // 16-byte pieces per row
  extern __shared__ uint4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * kRowsF32;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int Sq = (int)S;  // positions fit in 32 bits (S <= kMaxSeq)
  const int qw0 = (int)q0 + 16 * warp;  // this warp's first query row
  const int row_a = qw0 + g;
  const int row_b = row_a + 8;
  const float* kh = k + b * st.kb + (long long)hk * st.kh;
  const float* vh = v + b * st.vb + (long long)hk * st.vh;
  const long long kv_end = causal ? (q0 + kRowsF32 < S ? q0 + kRowsF32 : S) : S;
  const int n_tiles = (int)((kv_end + kBK - 1) / kBK);

  // K and V tile i into stage i % ST, 16 bytes a copy; keys past S are zeros.
  auto load_tile = [&](int i) {
    float* ks = smem + (i % ST) * Ly::kStage;
    float* vs = ks + kBK * Ly::kLdK;
    for (int e = threadIdx.x; e < kBK * CH; e += kThreadsF32) {
      const int r = e / CH;
      const int c = 4 * (e - r * CH);
      const long long key = (long long)i * kBK + r;
      const bool in = key < S;
      const long long kk = in ? key : 0;
      hopper::cp_async16(ks + r * Ly::kLdK + c, kh + kk * st.ks + c, in);
      hopper::cp_async16(vs + r * Ly::kLdV + c, vh + kk * st.vs + c, in);
    }
  };
  // Q in the A-fragment order of S's k-steps: k-step 2p takes head dims
  // 16p + 4t + {0, 1} as its columns t and t + 4, k-step 2p + 1 takes
  // 16p + 4t + {2, 3}.  (The order of the reduction is free as long as K's
  // fragments follow it: each lane then reads Q and K as 16-byte pieces.)
  // Each lane holds its pieces of rows row_a and row_b in registers.
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    hopper::cp_async_commit();
  }
  const float* qh = q + b * st.qb + (long long)h * st.qh;
  float4 qa[KP], qb[KP];  // rows row_a, row_b
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int c = 16 * p + 4 * t4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qa[p] = row_a < Sq ? *reinterpret_cast<const float4*>(qh + row_a * st.qs + c) : zero;
    qb[p] = row_b < Sq ? *reinterpret_cast<const float4*>(qh + row_b * st.qs + c) : zero;
  }

  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows row_a, row_b
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the running sums
  float acc[4 * NV];  // O: n-tile n holds head dims 8n + 2t + {0, 1}
#pragma unroll
  for (int i = 0; i < 4 * NV; ++i) acc[i] = 0.f;
  float sc[32];  // S of the tile (64 keys), then its p
  float a0, a1;

  for (int i = 0; i < n_tiles; ++i) {
    hopper::cp_async_wait<ST - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();  // every thread's copies, and tile i - 1's readers are done
    if (i + ST - 1 < n_tiles) load_tile(i + ST - 1);
    hopper::cp_async_commit();  // possibly empty: the wait above counts groups
    const int kv0 = i * kBK;
    if (qw0 >= Sq || (causal && kv0 > qw0 + 15)) continue;  // no key of the tile counts here
    const float* ks = smem + (i % ST) * Ly::kStage;
    const float* vs = ks + kBK * Ly::kLdK;

    // S = Q . K^T: 8 n-tiles of 8 keys, 2 KP k-steps of 8 head dims.
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const float4 xa = qa[p], xb = qb[p];  // Q's pieces of rows row_a and row_b
      uint32_t ab[2][4], as[2][4];  // A big / small of k-steps 2p, 2p + 1
      hopper::split_tf32(xa.x, ab[0][0], as[0][0]);
      hopper::split_tf32(xb.x, ab[0][1], as[0][1]);
      hopper::split_tf32(xa.y, ab[0][2], as[0][2]);
      hopper::split_tf32(xb.y, ab[0][3], as[0][3]);
      hopper::split_tf32(xa.z, ab[1][0], as[1][0]);
      hopper::split_tf32(xb.z, ab[1][1], as[1][1]);
      hopper::split_tf32(xa.w, ab[1][2], as[1][2]);
      hopper::split_tf32(xb.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (8 * j + g) * Ly::kLdK + 16 * p + 4 * t4);
        uint32_t bb[4], bs[4];
        hopper::split_tf32(kv.x, bb[0], bs[0]);
        hopper::split_tf32(kv.y, bb[1], bs[1]);
        hopper::split_tf32(kv.z, bb[2], bs[2]);
        hopper::split_tf32(kv.w, bb[3], bs[3]);
        float(&c)[4] = *reinterpret_cast<float(*)[4]>(&sc[4 * j]);
        hopper::mma_3xtf32(c, ab[0], as[0], bb[0], bb[1], bs[0], bs[1]);
        hopper::mma_3xtf32(c, ab[1], as[1], bb[2], bb[3], bs[2], bs[3]);
      }
    }
    const bool masked = (kv0 + kBK > Sq) || (causal && kv0 + kBK - 1 > qw0);
    softmax_tile(sc, masked, kv0, row_a, row_b, Sq, causal, t4, scale_log2, m0, m1, l0, l1,
                 a0, a1);
    rescale(acc, a0, a1);

    // O += P . V, p in f32 as two tf32 parts.  k-step j covers keys 8j..8j+7
    // in the order 2t -> column t, 2t + 1 -> column t + 4, so S's accumulator
    // registers of n-tile j are the A fragment as they stand (no shuffle):
    // a0 = p(g, 8j + 2t), a1 = p(g + 8, 8j + 2t), a2 = p(g, 8j + 2t + 1),
    // a3 = p(g + 8, 8j + 2t + 1).  V's B fragment follows: rows 8j + 2t and
    // 8j + 2t + 1, column 8n + g.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pb[4], ps[4];
      hopper::split_tf32(sc[4 * j], pb[0], ps[0]);
      hopper::split_tf32(sc[4 * j + 2], pb[1], ps[1]);
      hopper::split_tf32(sc[4 * j + 1], pb[2], ps[2]);
      hopper::split_tf32(sc[4 * j + 3], pb[3], ps[3]);
      const float* v0 = vs + (8 * j + 2 * t4) * Ly::kLdV + g;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        hopper::split_tf32(v0[8 * n], bb0, bs0);
        hopper::split_tf32(v0[Ly::kLdV + 8 * n], bb1, bs1);
        hopper::mma_3xtf32(*reinterpret_cast<float(*)[4]>(&acc[4 * n]), pb, ps, bb0, bb1, bs0,
                           bs1);
      }
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && t4 == 0)
    store_lse(lse + (b * gridDim.y + h) * S, row_a, row_b, Sq, m0, m1, l0, l1);
  float* oh_ = o + b * st.ob + (long long)h * st.oh + 2 * t4;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    if (row_a < Sq)
      *reinterpret_cast<float2*>(oh_ + row_a * st.os + 8 * n) =
          make_float2(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (row_b < Sq)
      *reinterpret_cast<float2*>(oh_ + row_b * st.os + 8 * n) =
          make_float2(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

// ---------------------------------------------------------------- launch

// Tensor maps: tensor_map.cuh (shared with K6', flash_attention_backward.cu).
using tensor_map::kEncodeError;
using tensor_map::make_map;

// The SMs of the current device, asked once a device.
inline int sm_count() {
  static std::atomic<int> known[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  int n = known[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 1;
    known[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The bf16 kernel's dynamic shared memory at head dim D, set once a device.
template <int D>
cudaError_t set_smem_once() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::kBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int D>
int make_maps_bf16(Maps& maps, const void* q, const void* k, const void* v, long long B,
                   long long S, int H, int Hkv, const Strides& st) {
  constexpr int kRem = Layout<D>::kRem;
  int err = 0;  // [0] stays empty at dh 16 and 32
  for (int j = Layout<D>::kMain ? 0 : 1; j < (kRem ? 2 : 1) && !err; ++j) {
    const int cols = j == 0 ? 64 : kRem;
    err = make_map(&maps.q[j], q, B, S, H, D, st.qb, st.qs, st.qh, cols, kBQ);
    if (!err) err = make_map(&maps.k[j], k, B, S, Hkv, D, st.kb, st.ks, st.kh, cols, kBKV);
    if (!err)
      err = make_map(&maps.v[j], v, B, S, Hkv, D, st.vb, st.vs, st.vh,
                     j == 1 && Layout<D>::kVChunked ? 16 : cols, kBKV);
  }
  return err;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, long long B, long long S,
                int H, int Hkv, int causal, const Strides& st, void* stream, float* lse) {
  if (S > kMaxSeq) return (int)cudaErrorInvalidValue;
  Maps maps = {};
  const int err = make_maps_bf16<D>(maps, q, k, v, B, S, H, Hkv, st);
  if (err) return err;
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t e = set_smem_once<D>();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const Walk walk(B, S, H, causal);
  const long long ctas = (long long)sm_count() * kCtasPerSm;
  const dim3 grid((unsigned)(walk.units() < ctas ? walk.units() : ctas));
  flash_attention_bf16_kernel<D><<<grid, kThreadsBf16, smem, (cudaStream_t)stream>>>(
      maps, (__nv_bfloat16*)o, S, H / Hkv, causal, scale_log2, st.ob, st.os, st.oh, lse, walk);
  return (int)cudaGetLastError();
}

// Host time of a bf16 call's parts, in ns a call over `reps` calls: [0] the
// maps encoded afresh (cuTensorMapEncodeTiled each), [1] the shared-memory
// attribute set (cudaFuncSetAttribute), as every call did both before the
// cache; [2] the maps as a call makes them now (copied from the cache, the
// address replaced), [3] the attribute as a call checks it now.  Launches
// nothing.
template <int D>
int host_parts_bf16(const void* q, const void* k, const void* v, long long B, long long S,
                    int H, int Hkv, const Strides& st, int reps, long long* ns) {
  using clock = std::chrono::steady_clock;
  constexpr int kRem = Layout<D>::kRem;
  Maps maps = {};
  int err = 0;
  auto per_call = [&](clock::time_point t0) {
    return (long long)(std::chrono::duration_cast<std::chrono::nanoseconds>(clock::now() - t0)
                           .count() / reps);
  };
  auto t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    for (int j = Layout<D>::kMain ? 0 : 1; j < (kRem ? 2 : 1) && !err; ++j) {
      const int cols = j == 0 ? 64 : kRem;
      err = tensor_map::encode_map(&maps.q[j], q, B, S, H, D, st.qb, st.qs, st.qh, cols, kBQ);
      if (!err)
        err = tensor_map::encode_map(&maps.k[j], k, B, S, Hkv, D, st.kb, st.ks, st.kh, cols,
                                     kBKV);
      if (!err)
        err = tensor_map::encode_map(&maps.v[j], v, B, S, Hkv, D, st.vb, st.vs, st.vh,
                                     j == 1 && Layout<D>::kVChunked ? 16 : cols, kBKV);
    }
  ns[0] = per_call(t0);
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    err = (int)cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Layout<D>::kBytes);
  ns[1] = per_call(t0);
  if (!err) err = make_maps_bf16<D>(maps, q, k, v, B, S, H, Hkv, st);  // fills the cache
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r) err = make_maps_bf16<D>(maps, q, k, v, B, S, H, Hkv, st);
  ns[2] = per_call(t0);
  t0 = clock::now();
  for (int r = 0; r < reps && !err; ++r)
    err = (int)set_smem_once<D>();
  ns[3] = per_call(t0);
  return err;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, long long B, long long S,
               int H, int Hkv, int causal, const Strides& st, void* stream, float* lse) {
  if (S > kMaxSeq) return (int)cudaErrorInvalidValue;
  constexpr int smem = LayoutF32<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const dim3 grid((unsigned)((S + kRowsF32 - 1) / kRowsF32), (unsigned)H, (unsigned)B);
  flash_attention_f32_kernel<D><<<grid, kThreadsF32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H / Hkv, causal,
      scale_log2, st, lse);
  return (int)cudaGetLastError();
}

template <bool kBf16, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long S,
           int H, int Hkv, int causal, const Strides& st, void* stream, float* lse) {
  if constexpr (kBf16) return launch_bf16<D>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
  else return launch_f32<D>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
}

bool read_strides(long long B, long long S, int H, int Hkv, const long long* strides,
                  Strides& st, int& code) {
  code = 0;
  if (B <= 0 || S <= 0 || H <= 0) return false;
  if (Hkv <= 0 || H % Hkv) {
    code = (int)cudaErrorInvalidValue;
    return false;
  }
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  return true;
}

template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, void* o, long long B,
             long long S, int H, int Hkv, int D, int causal,
             const long long* strides, void* stream, float* lse) {
  Strides st;
  int code;
  if (!read_strides(B, S, H, Hkv, strides, st, code)) return code;
  switch (D) {
    case 16: return launch<kBf16, 16>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    case 32: return launch<kBf16, 32>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    case 64: return launch<kBf16, 64>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    case 80: return launch<kBf16, 80>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    case 96: return launch<kBf16, 96>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    case 128: return launch<kBf16, 128>(q, k, v, o, B, S, H, Hkv, causal, st, stream, lse);
    default: return (int)cudaErrorInvalidValue;
  }
}

int host_parts(const void* q, const void* k, const void* v, long long B, long long S, int H,
               int Hkv, int D, const long long* strides, int reps, long long* ns) {
  Strides st;
  int code;
  if (!read_strides(B, S, H, Hkv, strides, st, code))
    return code ? code : (int)cudaErrorInvalidValue;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return host_parts_bf16<16>(q, k, v, B, S, H, Hkv, st, reps, ns);
    case 32: return host_parts_bf16<32>(q, k, v, B, S, H, Hkv, st, reps, ns);
    case 64: return host_parts_bf16<64>(q, k, v, B, S, H, Hkv, st, reps, ns);
    case 80: return host_parts_bf16<80>(q, k, v, B, S, H, Hkv, st, reps, ns);
    case 96: return host_parts_bf16<96>(q, k, v, B, S, H, Hkv, st, reps, ns);
    case 128: return host_parts_bf16<128>(q, k, v, B, S, H, Hkv, st, reps, ns);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, S, Hkv, D], o [B, S, H, D], one dtype; strides
// holds the 12 element strides (b, s, h) of q, k, v, o; the last dim is
// contiguous.  D in {16, 32, 64, 80, 96, 128}.  lse, when
// not null, is a [B, H, S] f32 output: each row's logsumexp of the scaled
// scores (null: the serving launch, unchanged).  Both need q, k and v on 16-byte
// boundaries with 16-byte multiples as strides (TMA in bf16, 16-byte copies
// and loads in f32), and S below 2^31 - 256.  Returns
// cudaGetLastError(), or 10000 + a CUresult when a tensor map is refused.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         long long B, long long S, int H, int Hkv, int D,
                         int causal, const long long* strides, void* stream, float* lse) {
  return dispatch<true>(q, k, v, o, B, S, H, Hkv, D, causal, strides, stream, lse);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        long long B, long long S, int H, int Hkv, int D,
                        int causal, const long long* strides, void* stream, float* lse) {
  return dispatch<false>(q, k, v, o, B, S, H, Hkv, D, causal, strides, stream, lse);
}

// The host time of flash_attention_bf16's parts (host_parts_bf16): ns[4],
// in ns a call over `reps` calls, at the arguments of a call (o, causal,
// the stream and lse are not needed: nothing is launched).
int flash_attention_bf16_host_ns(const void* q, const void* k, const void* v, long long B,
                                 long long S, int H, int Hkv, int D, const long long* strides,
                                 int reps, long long* ns) {
  return host_parts(q, k, v, B, S, H, Hkv, D, strides, reps, ns);
}

const char* flash_attention_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
