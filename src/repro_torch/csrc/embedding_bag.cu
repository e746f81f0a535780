// Kernel K1: fused embedding bag (gather + weighted pool) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::embedding_bag, the Pallas TPU
// kernel (pallas_call at :59) that streams one table row per grid step into
// VMEM by scalar prefetch and accumulates the bag there.
//
//   weighted (the Pallas kernel's contract):
//     out[b, :] = sum_j w[b*nnz + j] * float(table[idx[b*nnz + j], :])
//   masked (DisaggEmbedding.lookup, the reference's masked gather):
//     the same sum over the slots with w != 0 only; a slot whose weight is
//     0 adds nothing, its id is not used and its row is never loaded.
//
// Ids are clamped into [0, V) in both modes: a bad id never reads outside
// the table.
//
// What bounds it on the card: bytes.  Each slot reads one D-wide row of a
// table far larger than L2 (dlrm-flexemr: 150M x 64 f32, 38 GB) and does two
// flops per element, so the kernel is a random gather at HBM rate, and what
// keeps it from that rate is latency: a row's address is known only once
// its id has arrived.
//
// What the design does about it: a group of `lanes` threads (a power of two
// up to 32, the row's 16-byte vectors rounded up: 16 at D = 64 f32) owns one
// bag at a time and spans its rows with 16-byte vector loads (float4 for
// f32, 8 x bf16 for bf16).  Lane j loads slot j's id and weight, once per
// group and coalesced, and hands them to the group by __shfl_sync.  For
// the configs' nnz (1, 2, 4, 8) the slot loop is unrolled at compile time
// and every row load of the bag is issued before the first FMA; in the
// masked mode a zero-weight slot issues none.  Other nnz take a general
// loop with four row loads in flight.  The grid is at most one wave of
// resident blocks (the host computes it from the SM count and the kernel's
// occupancy, kernels/embedding_bag.py::launch_plan) and strides over the
// bags; each group loads its next bag's ids and weights before it waits on
// the current bag's rows.  Sums are f32 in slot order; the pooled bag is
// stored once, so the only traffic is the rows, the ids and weights, and
// the output.
//
// Kernel K1' (embedding_bag_backward): the gradient of K1 with respect to
// the table, which the Pallas kernel never needed (the reference trains
// through XLA's autodiff of its plain lookup, a scatter-add).
//
//   grad[clamp(idx[s]), :] += w[s] * grad_out[s / nnz, :]   (dense [V, D] f32)
//
// In the masked mode a slot with w == 0 adds nothing and its id is not used.
//
// What bounds it on the card: bytes, and the dense output most: V * D f32
// written once (326 MB for dlrm-100m's table, 3.3 GB for wide-deep's
// train step), against the slots and their gradient rows.  What keeps it
// from that on a real batch is the skew of the ids: a hot row is named by
// tens of thousands of slots spread over the whole batch, and its sum must
// still add them one after another in slot order.
//
// What the design does about it: one persistent kernel, one wave of
// resident blocks launched together (a cooperative launch, so every block
// is resident and the phases below may wait on each other), writes every
// row exactly once and groups the slots by row by itself, with no sort
// pass and no table of the rows:
//  * Marks.  Every thread marks its live slots' clamped rows in a bitmap of
//    V bits, and counts each new mark in its chunk of bitmap words (a
//    grouping warp's share of phase 0); one grid-wide barrier.
//  * Fill.  Warps 2-7 of every block sweep the output as a plain fill
//    does (grid-stride 16-byte streamed zero stores, each thread's bitmap
//    words loaded kFillAhead steps ahead), skipping the rows whose bit is
//    set, with no barrier and no word a block must own.
//  * Grouping (warps 0-1 of every block; grid-wide barriers between the
//    phases).  0: a touched row is known by its rank among the touched
//    rows, the marks below it: each warp writes its chunk's words' ranks
//    and each rank's row.  1: each live slot counts its row (one atomic a
//    row and a warp) and keeps the count it got: its place in the row's
//    run.  2: each warp takes a chunk of ranks and
//    allocates their runs in the slot list, and the long runs' (past
//    kSortCap slots) long indices and buckets, one atomic a count.  3: each
//    slot goes to its place, with no atomic; a long run's slot also counts
//    itself into its bucket.  From kHelpFirstSlots slots, phases 1 and 3
//    are tasks that the fill warps take too, before their stores (the last
//    task's warp releases the phase): there the grouping is the longer
//    path, and its loads would queue behind the fill's stores.
//  * Long runs, ordered once (3b-3d).  A run of L slots has a power of two
//    of buckets, about L / kBucketAim, that cut the slot numbers [0, 2^k)
//    into equal parts: the buckets' counts become starts (3b), each slot
//    moves into its bucket, in any order within it (3c), and each bucket is
//    ordered on its own (3d), by rank up to kSortCap slots, else through
//    bitmap windows of kWindow slots (a run whose slots crowd into one
//    bucket).  A run is ordered in time linear in its length, and 3c and 3d
//    are tasks of kBucketTask buckets for any warp.
//  * Sums (4).  Each row is w * grad_out rounded and then added, in slot
//    order from 0, as the reference's scatter-add does, with no atomics in
//    the sums: the same bits on every run.  The short runs are taken from a
//    grid-wide count once every slot is placed, by the fill warps as they
//    finish and by the grouping warps when they are done, ordered by rank:
//    up to kSumBatch slots a group of kSumBatch lanes where a row has at
//    most kSumBatch vectors (4 runs a warp at D 32), else a warp a run.  The
//    long runs are taken a column vector at a time, hot runs (kHotRun slots
//    and more) first, once they are ordered: the lanes load 32 * kLongBatch
//    consecutive slots' gradients a pass, the next pass's in flight while
//    this pass's products are added one after another (shuffles), so a hot
//    run is no single warp's serial walk.  A run may be any length, up to
//    every slot.
// The atomics only decide where a run and a slot lie in the list, never
// what is summed or in what order.  The scratch is kept by the wrapper per
// (device, stream); the kernel leaves its counters, chunk counts, counts
// and buckets at zero, and a flag holds the number of the launch that
// wrote it.  The bitmap has two halves: a launch marks one and clears the
// other, the last launch's marks, so no fill warp waits for the others to
// be done with a word before it is cleared.
//
// What it reaches on the card is in PERF.md (K1''s row), beside the time
// of index_add_ into a zeroed table at the same shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "row_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;  // row loads in flight per lane in the general loop
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_row(int32_t id, int64_t num_rows) {
  const int64_t r = id;
  return r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
}

// NNZ > 0: nnz == NNZ <= lanes, every row load of the bag in flight at once.
// NNZ == 0: any nnz, slots in chunks of `lanes`, kBatch row loads at a time.
template <typename T, int VEC, int NNZ, bool MASKED>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int64_t num_bags, int nnz_rt, int dim, int64_t num_rows,
                     int lanes) {
  using V = Vec<T, VEC>;
  const int nnz = NNZ > 0 ? NNZ : nnz_rt;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads / lanes;
  // Groups of one warp hold consecutive bags, so the loop bound is the
  // same for the whole warp and every __shfl_sync has all 32 lanes.
  const int64_t group = (int64_t)blockIdx.x * groups + threadIdx.x / lanes;
  const int64_t warp_group = group - (int64_t)((threadIdx.x & 31) / lanes);
  const int64_t stride = (int64_t)gridDim.x * groups;
  const int nvec = dim / VEC;

  // This lane's slot of the group's bag: its id and weight.
  auto meta = [&](int64_t bag, int slot, int32_t& id, float& wt) {
    id = 0;
    wt = 0.f;
    if (bag < num_bags && slot < nnz) {
      id = __ldg(idx + bag * nnz + slot);
      wt = __ldg(w + bag * nnz + slot);
    }
  };

  int32_t my_id;
  float my_w;
  meta(group, lane, my_id, my_w);
  for (int64_t wb = warp_group; wb < num_bags; wb += stride) {
    const int64_t bag = wb + (group - warp_group);
    const bool valid = bag < num_bags;
    int32_t next_id;
    float next_w;
    meta(bag + stride, lane, next_id, next_w);  // in flight under this bag's rows
    for (int c0 = 0; c0 < nvec; c0 += lanes) {
      const int c = c0 + lane;
      const bool col = valid && c < nvec;
      const T* base = table + (int64_t)c * VEC;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      if constexpr (NNZ > 0) {
        typename V::Raw raw[NNZ];
        float wj[NNZ];
        bool live[NNZ];
#pragma unroll
        for (int j = 0; j < NNZ; ++j) {
          const int32_t id = __shfl_sync(kFull, my_id, j, lanes);
          wj[j] = __shfl_sync(kFull, my_w, j, lanes);
          live[j] = col && (!MASKED || wj[j] != 0.f);
          raw[j] = typename V::Raw{};
          if (live[j]) raw[j] = V::load(base + clamp_row(id, num_rows) * dim);
        }
#pragma unroll
        for (int j = 0; j < NNZ; ++j)
          if (live[j]) V::fma(raw[j], wj[j], acc);
      } else {
        for (int s0 = 0; s0 < nnz; s0 += lanes) {
          int32_t sid = my_id;
          float sw = my_w;
          if (s0 > 0) meta(bag, s0 + lane, sid, sw);
          const int n = nnz - s0 < lanes ? nnz - s0 : lanes;
          for (int j0 = 0; j0 < n; j0 += kBatch) {
            typename V::Raw raw[kBatch];
            float wj[kBatch];
            bool live[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int j = j0 + u;
              const int32_t id = __shfl_sync(kFull, sid, j & (lanes - 1), lanes);
              wj[u] = __shfl_sync(kFull, sw, j & (lanes - 1), lanes);
              live[u] = col && j < n && (!MASKED || wj[u] != 0.f);
              raw[u] = typename V::Raw{};
              if (live[u]) raw[u] = V::load(base + clamp_row(id, num_rows) * dim);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (live[u]) V::fma(raw[u], wj[u], acc);
          }
        }
      }
      if (col) {
        float* o = out + bag * dim + (int64_t)c * VEC;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<float4*>(o + k) =
                make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) o[k] = acc[k];
        }
      }
    }
    my_id = next_id;
    my_w = next_w;
  }
}

template <typename T, int VEC, int NNZ, bool MASKED>
int launch_one(const void* table, const void* idx, const void* w, void* out,
               long long num_bags, int nnz, int dim, long long num_rows,
               int lanes, long long blocks, void* stream) {
  embedding_bag_kernel<T, VEC, NNZ, MASKED><<<(unsigned)blocks, kThreads, 0,
                                             (cudaStream_t)stream>>>(
      (const T*)table, (const int32_t*)idx, (const float*)w, (float*)out,
      num_bags, nnz, dim, num_rows, lanes);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int NNZ, bool MASKED>
int occupancy_one() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, embedding_bag_kernel<T, VEC, NNZ, MASKED>, kThreads, 0);
  return err ? -(int)err : blocks;
}

// F<instantiation of (vec, nnz_spec, masked)>::run(args...), or
// cudaErrorInvalidValue where there is none (VEC 1 has only the general loop).
template <typename T, int WIDE, template <typename, int, int, bool> class F,
          typename... Args>
int dispatch(int vec, int nnz_spec, int masked, Args... args) {
#define K1_CASE(V, N)                                                      \
  if (vec == V && nnz_spec == N)                                           \
    return masked ? F<T, V, N, true>::run(args...) : F<T, V, N, false>::run(args...);
  K1_CASE(WIDE, 1)
  K1_CASE(WIDE, 2)
  K1_CASE(WIDE, 4)
  K1_CASE(WIDE, 8)
  K1_CASE(WIDE, 0)
  K1_CASE(1, 0)
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC, int NNZ, bool MASKED>
struct Launch {
  static int run(const void* table, const void* idx, const void* w, void* out,
                 long long num_bags, int nnz, int dim, long long num_rows,
                 int lanes, long long blocks, void* stream) {
    return launch_one<T, VEC, NNZ, MASKED>(table, idx, w, out, num_bags, nnz, dim,
                                           num_rows, lanes, blocks, stream);
  }
};

template <typename T, int VEC, int NNZ, bool MASKED>
struct Occupancy {
  static int run() { return occupancy_one<T, VEC, NNZ, MASKED>(); }
};

// The host's plan is checked here, not trusted: a wrong one is refused.
bool plan_ok(const void* table, const void* out, long long num_bags, int nnz,
             int dim, int vec, int lanes, int nnz_spec, long long blocks) {
  const bool aligned = (((uintptr_t)table | (uintptr_t)out) & 15u) == 0;
  return num_bags > 0 && nnz > 0 && dim > 0 && blocks > 0 && blocks < (1ll << 31) &&
         lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
         dim % vec == 0 && (vec == 1 || aligned) &&
         (nnz_spec == 0 || (nnz_spec == nnz && nnz <= lanes));
}

// ---- K1': embedding_bag_backward

constexpr int kBwdThreads = 256;
constexpr int kGroupWarps = 2;  // warps 0-1 group and sum, the rest fill
constexpr int kFillThreads = kBwdThreads - 32 * kGroupWarps;
constexpr int kSortCap = 128;  // runs and buckets up to this long are ordered by rank
constexpr int kWindow = 32 * kSortCap;  // a longer bucket: slots a bitmap window spans
constexpr int kBucketAim = 32;  // a long run's buckets: its length over this, a power of two
constexpr int kTile = 128;  // a long run's slots a warp moves into buckets at a time
constexpr int kBucketTask = 16;  // buckets a task of 3c and 3d
// from this many slots, the fill warps take the tasks of phases 1 and 3
// before their stores: the grouping would outlast the fill, its loads
// queued behind the fill's stores
constexpr long long kHelpFirstSlots = 1ll << 20;
constexpr int kHotRun = 4096;  // long runs this long are summed first
constexpr int kSumBatch = 8;  // slots' loads in flight in a short run's sum
constexpr int kLongBatch = 4;  // a long run's slots a lane loads ahead of the in-order sum
constexpr int kGroupAhead = 4;  // slots a grouping lane takes a pass (loads in flight)
constexpr int kMarkAhead = 4;  // slots a thread marks a pass, and bitmap words a rank pass
constexpr int kBwdMinBlocks = 2;  // the blocks an SM runs: up to 128 registers a thread
constexpr int kFillAhead = 4;  // fill steps whose bitmap words are in flight
constexpr int kCounterStride = 32;  // one 128-byte line a counter
constexpr unsigned long long kSpinLimitNs = 2000000000ull;  // a wait past 2 s traps
// counters[i * kCounterStride]: grid-wide counts, all zero between launches
enum { kMarked, kRanked, kGrouped, kBased, kPlaced, kScanned, kScattered, kOrdered,
       kRows, kTake1, kTake3, kTake3c, kTake3d, kNextShort, kNextLong, kTotal, kHot, kCool,
       kBuckets, kTicket, kCounters };

struct BwdArgs {
  const float* grad_out;  // [n / nnz, dim]
  const int32_t* idx;     // [n]
  const float* w;         // [n]
  float* grad;            // [num_rows, dim]
  long long n;
  int nnz, dim;
  long long num_rows;
  int masked;
  unsigned* counters;  // [kCounters * kCounterStride], zeros
  unsigned* flags;     // [gridDim.x * kCounterStride]: block b's line, phase p's word
  unsigned epoch;      // this launch's number (never 0): a released phase's flag
  unsigned* bitmap;    // [ceil(num_rows / 32)], zeros: this launch's marks
  unsigned* stale;     // [stale_words]: the last launch's marks, cleared here
  long long stale_words;
  int* wchunk;         // [gridDim.x * kGroupWarps], zeros: the marks in a warp's chunk of words
  int* wprefix;        // [ceil(num_rows / 32)]: the marked rows below each word
  int* counts;         // [n], zeros: each touched row's live slots, by its rank
  int2* ebase;         // [n]: a run's start in list and its long index, or -1
  int4* runs;          // [n]: (start, length, row, long index or -1) of each run
  int* rowof;          // [n]: the row of each rank
  int* slot_entry;     // [n]: a slot's row's rank, -1 for a masked slot
  int* slot_rank;      // [n]: a live slot's place in its run
  int* list;           // [n]: the live slots, each row's run together
  int4* longs;         // [long_cap]: (start, length, row, first bucket) of each long run
  int* buckets;        // [bucket_cap], zeros: a long run's slots a bucket, then its starts
  int* brun;           // [bucket_cap]: the long index of each bucket
  int* order;          // [n]: the long runs' slots, bucket by bucket
  int long_cap;
  int slot_bits;  // log2 of n rounded up to a power of two
  long long chunk;  // slots a task of phases 1 and 3 (a multiple of 32 * kGroupAhead)
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A grid-wide barrier for phase `phase` of `arrivals` warps (or a phase's
// tasks, each counted in when done): each warp counts itself in; the last
// one writes this launch's number into every
// block's flag line, and each block polls its own line.  One line polled
// by every block would hold the L2 slice it lives on, and with it every
// store stream of the fill that crosses that slice.  A wait that outlives
// kSpinLimitNs traps instead of hanging the card.
__device__ void warp_arrive(const BwdArgs& a, int phase, unsigned arrivals, int lane) {
  __threadfence();
  __syncwarp();
  unsigned old = 0;
  if (lane == 0) old = atomicAdd(a.counters + phase * kCounterStride, 1u);
  if (__shfl_sync(kFull, old, 0) == arrivals - 1) {  // the last: release every block
    __threadfence();  // one fence, then relaxed stores (a release store fences each)
    for (unsigned b = lane; b < gridDim.x; b += 32)
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(a.flags + b * kCounterStride + phase),
                   "r"(a.epoch)
                   : "memory");
  }
}

__device__ __forceinline__ bool released(const BwdArgs& a, int phase) {
  return ld_acquire(a.flags + blockIdx.x * kCounterStride + phase) == a.epoch;
}

// Poll the block's own flag line, less often the longer it waits: polls
// are L2 requests beside the fill's stores.
__device__ void wait_released(const BwdArgs& a, int phase, unsigned sleep_ns) {
  const unsigned long long t0 = global_ns();
  while (!released(a, phase)) {
    __nanosleep(sleep_ns);
    sleep_ns = sleep_ns < 2048 ? 2 * sleep_ns : 2048;
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// The grouping warps' phase barrier across the grid: their writes are
// visible to every block's grouping warps once all have arrived.  One
// thread a block polls; the block's grouping warps meet at named barrier 1.
__device__ __forceinline__ void group_arrive_wait(const BwdArgs& a, int phase, int lane) {
  warp_arrive(a, phase, gridDim.x * kGroupWarps, lane);
  if (threadIdx.x == 0) wait_released(a, phase, 256);
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kGroupWarps) : "memory");
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __ldg(p + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// A zero vector, streamed: the line is first out of the L2 (st.global.cs).
template <int VEC>
__device__ __forceinline__ void store_zero(float* p) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(0.f, 0.f, 0.f, 0.f));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) __stcs(p + k, 0.f);
  }
}

// The fill warps sweep the output as a plain fill does: vector j of the
// [num_rows, dim] output is fill thread j's, then j + T, ... (T the grid's
// fill threads), 16-byte streamed zero stores into the rows whose bit is
// clear.  Each step's bitmap word is a new line, so a thread loads the
// words of its next kFillAhead steps ahead of their stores.
template <int VEC>
__device__ void fill_untouched(const BwdArgs& a) {
  const int nv = a.dim / VEC;
  const int shift = (nv & (nv - 1)) == 0 ? __ffs(nv) - 1 : -1;  // log2(nv), or -1
  const long long total = a.num_rows * nv;
  const long long T = (long long)gridDim.x * kFillThreads;
  auto row_of = [&](long long j) { return shift >= 0 ? j >> shift : j / nv; };
  auto word_of = [&](long long j) { return j < total ? a.bitmap[row_of(j) >> 5] : ~0u; };
  const long long j0 = (long long)blockIdx.x * kFillThreads + threadIdx.x - 32 * kGroupWarps;
  unsigned ahead[kFillAhead];
#pragma unroll
  for (int q = 0; q < kFillAhead; ++q) ahead[q] = word_of(j0 + q * T);
  for (long long j = j0; j < total; j += kFillAhead * T) {
#pragma unroll
    for (int q = 0; q < kFillAhead; ++q) {
      const long long jq = j + q * T;
      const long long r = row_of(jq);
      const unsigned word = ahead[q];
      ahead[q] = word_of(jq + kFillAhead * T);
      if (jq < total && !((word >> (r & 31)) & 1u))  // a touched row is the sums'
        store_zero<VEC>(a.grad + jq * VEC);
    }
  }
}

constexpr int kPer = kSortCap / 32;  // slots a lane holds of a run ordered by rank

// This lane's slots of src[0, len) (len <= kSortCap): src[q * 32 + lane],
// INT_MAX past the end.
__device__ __forceinline__ void load_slots(const int* src, int len, int (&mine)[kPer], int lane) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = q * 32 + lane;
    mine[q] = i < len ? __ldcg(src + i) : INT_MAX;
  }
}

// The warp's slots `mine` (len of them, distinct) into dst in ascending
// order, dst[rank] = slot, the rank of a slot being the slots below it.
__device__ __forceinline__ void rank_into(const int (&mine)[kPer], int len, int* dst, int lane) {
  int rank[kPer] = {};
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (q * 32 >= len) break;  // uniform: len is the warp's
    for (int l = 0; l < 32; ++l) {
      const int other = __shfl_sync(kFull, mine[q], l);
#pragma unroll
      for (int m = 0; m < kPer; ++m) rank[m] += other < mine[m];
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (q * 32 + lane < len) dst[rank[q]] = mine[q];
}

// A bucket past kSortCap slots (src[0, len)) into dst in ascending order
// through bitmap windows of kWindow slots in the warp's shared words `bm`,
// from the least slot not yet placed: each window rescans the bucket, so
// this is kept for buckets that a run's spread of slots leaves long.
__device__ void order_by_windows(const int* src, int len, int* dst, unsigned* bm, int lane) {
  int lo = INT_MAX;  // the least slot not yet placed
  for (int i = lane; i < len; i += 32) lo = min(lo, __ldcg(src + i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lo = min(lo, __shfl_xor_sync(kFull, lo, o));
  int out = 0;
  while (lo != INT_MAX) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) bm[q * 32 + lane] = 0u;
    __syncwarp();
    int next = INT_MAX;  // the least slot past this window
    for (int i = lane; i < len; i += 32) {
      const int s = __ldcg(src + i);
      const unsigned d = (unsigned)(s - lo);
      if (d < (unsigned)kWindow)
        atomicOr(bm + (d >> 5), 1u << (d & 31));
      else if (s > lo)
        next = min(next, s);
    }
    __syncwarp();
    // word q * 32 + lane is this lane's; its slots go after the words below it
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      unsigned bits = bm[q * 32 + lane];
      int incl = __popc(bits);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int at = out + incl - __popc(bits);
      while (bits) {
        dst[at++] = lo + ((q * 32 + lane) << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
      }
      out += __shfl_sync(kFull, incl, 31);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) next = min(next, __shfl_xor_sync(kFull, next, o));
    __syncwarp();  // every lane has read the window before it is cleared
    lo = next;
  }
}

// A grouping or fill warp: the sum of one short run (len <= kSortCap slots
// of row `row`, in slot order in `sorted`) into its row.  kSumBatch slots'
// loads are in flight at a time.
template <int VEC>
__device__ void sum_run(const BwdArgs& a, int len, long long row, int lane, const int* sorted) {
  const int nv = a.dim / VEC;
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < nv;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int k0 = 0; k0 < len; k0 += kSumBatch) {
      int ss[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) ss[u] = k0 + u < len ? sorted[k0 + u] : -1;
      float wv[kSumBatch], v[kSumBatch][VEC];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        wv[u] = 0.f;
        if (col && ss[u] >= 0) {
          wv[u] = __ldg(a.w + ss[u]);
          load_vec<VEC>(a.grad_out + (long long)(ss[u] / a.nnz) * a.dim + (long long)c * VEC,
                        v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (col && ss[u] >= 0)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wv[u], v[u][k]));
    }
    if (col) store_vec<VEC>(a.grad + row * a.dim + (long long)c * VEC, acc);
  }
}

// A warp: column vector c of a long run (list[start, start + len), in slot
// order since phase 3d) summed in slot order into its row.  The lanes take
// consecutive slots, kLongBatch of them each: while one pass's products,
// each rounded, are added one slot after another from lane 0 up
// (shuffles, every lane keeping the same sum), the next pass's weights and
// gradients are in flight, and the slots of the pass after it.
template <int VEC>
__device__ void sum_long_column(const BwdArgs& a, int4 r, int c, int lane) {
  const int* run = a.list + r.x;
  const int len = r.y;
  auto slot = [&](int i) { return i < len ? __ldcg(run + i) : -1; };
  auto fetch = [&](int s, float& wv, float (&v)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = 0.f;
    wv = 0.f;
    if (s >= 0) {
      wv = __ldg(a.w + s);
      load_vec<VEC>(a.grad_out + (long long)(s / a.nnz) * a.dim + (long long)c * VEC, v);
    }
  };
  float acc[VEC], wv[kLongBatch], v[kLongBatch][VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  int next[kLongBatch];
#pragma unroll
  for (int u = 0; u < kLongBatch; ++u) fetch(slot(u * 32 + lane), wv[u], v[u]);
#pragma unroll
  for (int u = 0; u < kLongBatch; ++u) next[u] = slot((kLongBatch + u) * 32 + lane);
  for (int i0 = 0; i0 < len; i0 += 32 * kLongBatch) {
    float p[kLongBatch][VEC];
#pragma unroll
    for (int u = 0; u < kLongBatch; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) p[u][k] = __fmul_rn(wv[u], v[u][k]);
      fetch(next[u], wv[u], v[u]);  // the next pass's, in flight under this pass's sum
      next[u] = slot(i0 + (2 * kLongBatch + u) * 32 + lane);
    }
#pragma unroll
    for (int u = 0; u < kLongBatch; ++u) {
      const int n = min(32, len - (i0 + u * 32));  // uniform
      for (int l = 0; l < n; ++l)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = __fadd_rn(acc[k], __shfl_sync(kFull, p[u][k], l));
    }
  }
  if (lane == 0) store_vec<VEC>(a.grad + (long long)r.z * a.dim + (long long)c * VEC, acc);
}

// The long index of the x-th long run: the hot ones (at least kHotRun
// slots) from 0 up, the others from long_cap - 1 down.
__device__ __forceinline__ int long_index(const BwdArgs& a, int x, int hot) {
  return x < hot ? x : a.long_cap - 1 - (x - hot);
}

// A long run's buckets, a power of two: its length over kBucketAim
// rounded up; bucket b holds its slots s with s >> bucket_shift == b.
__device__ __forceinline__ int bucket_bits(int len) {
  const int want = (len + kBucketAim - 1) / kBucketAim;
  return 32 - __clz(want - 1);  // ceil(log2(want)); len > kSortCap, so want > 1
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned take(const BwdArgs& a, int counter, int lane) {
  unsigned k = 0;
  if (lane == 0) k = atomicAdd(a.counters + counter * kCounterStride, 1u);
  return __shfl_sync(kFull, k, 0);
}

__device__ __forceinline__ int long_runs(const BwdArgs& a) {
  return (int)(__ldcg(a.counters + kHot * kCounterStride) +
               __ldcg(a.counters + kCool * kCounterStride));
}

// 4 (any warp): tasks taken from two grid-wide counts, each summed in slot
// order.  The short runs once every slot is placed, each by rank; the long
// runs' column vectors once every long run is ordered, the hot runs'
// before the rest.  The grouping warps take the long runs' first, the fill
// warps (as they finish their stores) the short runs'.
template <int VEC>
__device__ void sum_short_runs(const BwdArgs& a, int lane, int* sorted) {
  const unsigned rows = __ldcg(a.counters + kRows * kCounterStride);
  const int nv = a.dim / VEC;
  // a group of kSumBatch lanes takes a small run (up to kSumBatch slots, one
  // a lane) where a row has at most kSumBatch vectors (4 groups a warp up to
  // D 32 at vec 4); at wider rows the warp takes a run at a time
  const int gsz = nv <= kSumBatch ? kSumBatch : 32;
  const int ng = 32 / gsz, grp = lane / gsz, gl = lane % gsz;
  int* gs = sorted + grp * gsz;
  for (;;) {
    unsigned k0 = 0;
    if (lane == 0) k0 = atomicAdd(a.counters + kNextShort * kCounterStride, (unsigned)ng);
    k0 = __shfl_sync(kFull, k0, 0);
    if (k0 >= rows) break;
    const unsigned k = k0 + grp;
    const int4 r = k < rows ? __ldcg(a.runs + k) : make_int4(0, 0, 0, 0);
    const bool small = k < rows && r.w < 0 && r.y <= kSumBatch;  // else the whole warp's, below
    const int slot = small && gl < r.y ? __ldcg(a.list + r.x + gl) : INT_MAX;
    int rank = 0;
#pragma unroll
    for (int l = 0; l < kSumBatch; ++l) rank += __shfl_sync(kFull, slot, l, gsz) < slot;
    if (small && gl < r.y) gs[rank] = slot;
    __syncwarp();
    if (small) {
      for (int c = gl; c < nv; c += gsz) {  // lane gl's column vectors, in slot order
        float wv[kSumBatch], v[kSumBatch][VEC], acc[VEC];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (u < r.y) {
            const int s = gs[u];
            wv[u] = __ldg(a.w + s);
            load_vec<VEC>(a.grad_out + (long long)(s / a.nnz) * a.dim + (long long)c * VEC, v[u]);
          }
#pragma unroll
        for (int k2 = 0; k2 < VEC; ++k2) acc[k2] = 0.f;
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (u < r.y)
#pragma unroll
            for (int k2 = 0; k2 < VEC; ++k2)
              acc[k2] = __fadd_rn(acc[k2], __fmul_rn(wv[u], v[u][k2]));
        store_vec<VEC>(a.grad + (long long)r.z * a.dim + (long long)c * VEC, acc);
      }
    }
    __syncwarp();  // every lane has read `sorted` before it is reused
    // the groups' short runs past kSumBatch slots, one after another by
    // the whole warp, ordered by rank
    for (unsigned big = __ballot_sync(kFull, gl == 0 && k < rows && r.w < 0 && !small); big;
         big &= big - 1) {
      const int from = __ffs(big) - 1;
      const int start = __shfl_sync(kFull, r.x, from), len = __shfl_sync(kFull, r.y, from);
      const int row = __shfl_sync(kFull, r.z, from);
      int mine[kPer];
      load_slots(a.list + start, len, mine, lane);
      rank_into(mine, len, sorted, lane);
      __syncwarp();
      sum_run<VEC>(a, len, row, lane, sorted);
      __syncwarp();
    }
  }
}

template <int VEC>
__device__ void sum_long_runs(const BwdArgs& a, int lane) {
  const int hot = (int)__ldcg(a.counters + kHot * kCounterStride);
  const unsigned nv = a.dim / VEC;
  const unsigned tasks = (unsigned)long_runs(a) * nv;
  for (unsigned k = take(a, kNextLong, lane); k < tasks; k = take(a, kNextLong, lane))
    sum_long_column<VEC>(a, __ldcg(a.longs + long_index(a, (int)(k / nv), hot)), (int)(k % nv),
                         lane);
}

// 3b-3d, when there are long runs: each long run's slots into buckets by
// their high bits, each bucket ordered on its own, so a run is ordered once,
// in time linear in its length.  3b (the grouping warps): a warp a long
// run, its buckets' counts into starts (from the run's) and each bucket's
// long index.
__device__ void scan_buckets(const BwdArgs& a, int gw, int lane) {
  const long long G = (long long)gridDim.x * kGroupWarps;
  const int hot = (int)__ldcg(a.counters + kHot * kCounterStride);
  const int longs = long_runs(a);
  for (int x = gw; x < longs; x += G) {
    const int j = long_index(a, x, hot);
    const int4 r = __ldcg(a.longs + j);
    const int nb = 1 << bucket_bits(r.y);
    int running = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int c = b < nb ? __ldcg(a.buckets + r.w + b) : 0;
      const int incl = warp_incl(c, lane);
      if (b < nb) {
        a.buckets[r.w + b] = running + incl - c;
        a.brun[r.w + b] = j;
      }
      running += __shfl_sync(kFull, incl, 31);
    }
  }
}

// 3c, buckets [g_lo, g_hi): a run's tile t of kTile slots is its bucket t's
// task (a run has more buckets than tiles): the tile's slots from list
// into `order`, bucket by bucket, in any order within a bucket.
__device__ void scatter_buckets(const BwdArgs& a, long long g_lo, long long g_hi, int lane) {
  for (long long g = g_lo; g < g_hi; ++g) {
    const int4 r = __ldcg(a.longs + __ldcg(a.brun + g));
    const int t = (int)(g - r.w);
    if (t * kTile >= r.y) continue;
    const int shift = a.slot_bits - bucket_bits(r.y);
    int s[kTile / 32];
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int i = t * kTile + u * 32 + lane;
      s[u] = i < r.y ? __ldcg(a.list + r.x + i) : -1;
    }
    int at[kTile / 32];
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u)
      if (s[u] >= 0) at[u] = atomicAdd(a.buckets + r.w + (s[u] >> shift), 1);
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u)
      if (s[u] >= 0) a.order[r.x + at[u]] = s[u];
  }
}

// 3d, buckets [g_lo, g_hi): each bucket's slots from `order` back into list
// in slot order, by rank up to kSortCap slots, else through windows (the
// next bucket's bounds in flight).
__device__ void order_buckets(const BwdArgs& a, long long g_lo, long long g_hi, int lane,
                              int* sorted) {
  int j = -1, begin = 0, j_next = 0, end_next = 0;
  int4 r = make_int4(0, 0, 0, 0);
  if (g_lo < g_hi) {
    j_next = __ldcg(a.brun + g_lo);
    end_next = __ldcg(a.buckets + g_lo);
    begin = g_lo > 0 ? __ldcg(a.buckets + g_lo - 1) : 0;
  }
  for (long long g = g_lo; g < g_hi; ++g) {
    const int jg = j_next, end = end_next;
    if (g + 1 < g_hi) {
      j_next = __ldcg(a.brun + g + 1);
      end_next = __ldcg(a.buckets + g + 1);
    }
    if (jg != j) {
      j = jg;
      r = __ldcg(a.longs + j);
    }
    if (g == r.w) begin = 0;  // a run's first bucket
    const int len = end - begin;
    if (len > 0) {
      const int* src = a.order + r.x + begin;
      int* dst = a.list + r.x + begin;
      if (len <= kSortCap) {
        int mine[kPer];
        load_slots(src, len, mine, lane);
        rank_into(mine, len, dst, lane);
      } else {
        order_by_windows(src, len, dst, reinterpret_cast<unsigned*>(sorted), lane);
      }
      __syncwarp();
    }
    begin = end;
  }
}

// 3c or 3d in tasks of kBucketTask buckets, taken from a grid-wide count by
// any warp; the warp that finishes the last task releases the phase.
template <int PHASE>
__device__ void share_buckets(const BwdArgs& a, int lane, int* sorted) {
  const long long nbuckets = __ldcg(a.counters + kBuckets * kCounterStride);
  const unsigned tasks = (unsigned)((nbuckets + kBucketTask - 1) / kBucketTask);
  const int take_from = PHASE == kScattered ? kTake3c : kTake3d;
  for (unsigned t = take(a, take_from, lane); t < tasks; t = take(a, take_from, lane)) {
    const long long g_lo = (long long)t * kBucketTask;
    const long long g_hi = min(nbuckets, g_lo + kBucketTask);
    if constexpr (PHASE == kScattered)
      scatter_buckets(a, g_lo, g_hi, lane);
    else
      order_buckets(a, g_lo, g_hi, lane, sorted);
    warp_arrive(a, PHASE, tasks, lane);
  }
}

// 1: slots [s0, end) (at most 32 * kGroupAhead), a lane kGroupAhead of
// them, their loads issued together: each live slot's row's rank, and the
// slot's place in the row's run, from one atomic count a row and a warp.
__device__ void rank_slots(const BwdArgs& a, long long s0, long long end, int lane) {
  constexpr int K = kGroupAhead;
  long long s[K];
  bool live[K];
  int32_t id[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    s[q] = s0 + q * 32 + lane;
    live[q] = s[q] < end && !(a.masked && __ldg(a.w + s[q]) == 0.f);
    id[q] = s[q] < end ? __ldg(a.idx + s[q]) : 0;
  }
  int d[K];
  unsigned bits[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int64_t row = clamp_row(id[q], a.num_rows);
    bits[q] = live[q] ? __ldcg(a.bitmap + (row >> 5)) & lanes_below((int)(row & 31)) : 0u;
    d[q] = live[q] ? __ldcg(a.wprefix + (row >> 5)) : -1;
  }
  int old[K];
  unsigned peers[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (live[q]) d[q] += __popc(bits[q]);
    peers[q] = __match_any_sync(kFull, d[q]);
    old[q] = 0;
    if (live[q] && lane == __ffs(peers[q]) - 1)
      old[q] = atomicAdd(a.counts + d[q], __popc(peers[q]));
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    old[q] = __shfl_sync(kFull, old[q], __ffs(peers[q]) - 1);
    if (s[q] >= end) continue;
    a.slot_entry[s[q]] = d[q];
    if (!live[q]) continue;
    a.slot_rank[s[q]] = old[q] + __popc(peers[q] & lanes_below(lane));
  }
}

// 3: slots [s0, end) into their runs at their places, with no atomic, and
// a long run's into its bucket's count.
__device__ void place_slots(const BwdArgs& a, long long s0, long long end, int lane) {
  constexpr int K = kGroupAhead;
  long long s[K];
  int e[K], rank[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    s[q] = s0 + q * 32 + lane;
    e[q] = s[q] < end ? __ldcg(a.slot_entry + s[q]) : -1;
    rank[q] = s[q] < end ? __ldcg(a.slot_rank + s[q]) : 0;  // a masked slot's is not used
  }
  int2 eb[K];
#pragma unroll
  for (int q = 0; q < K; ++q) eb[q] = e[q] >= 0 ? __ldcg(a.ebase + e[q]) : make_int2(0, -1);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (e[q] < 0) continue;
    a.list[eb[q].x + rank[q]] = (int)s[q];
    if (eb[q].y >= 0) {
      const int4 r = __ldcg(a.longs + eb[q].y);
      atomicAdd(a.buckets + r.w + (int)(s[q] >> (a.slot_bits - bucket_bits(r.y))), 1);
    }
  }
}

// Phase 1 or 3 in tasks of a.chunk slots, taken from a grid-wide count by
// any warp (the grouping warps, and the fill warps that finish their
// stores first); the warp that finishes the last task releases the phase.
template <int PHASE>
__device__ void share_slots(const BwdArgs& a, int lane) {
  const long long need = (a.n + a.chunk - 1) / a.chunk;
  const unsigned tasks = need > 0 ? (unsigned)need : 1u;
  for (unsigned t = take(a, PHASE == 1 ? kTake1 : kTake3, lane); t < tasks;
       t = take(a, PHASE == 1 ? kTake1 : kTake3, lane)) {
    const long long end = min(a.n, (t + 1) * a.chunk);
    for (long long s0 = t * a.chunk; s0 < end; s0 += 32 * kGroupAhead) {
      if constexpr (PHASE == 1)
        rank_slots(a, s0, end, lane);
      else
        place_slots(a, s0, end, lane);
    }
    warp_arrive(a, PHASE == 1 ? kGrouped : kPlaced, tasks, lane);
  }
}

// The grouping warps of a block wait for a phase another warp releases.
__device__ __forceinline__ void group_wait(const BwdArgs& a, int phase) {
  if (threadIdx.x == 0) wait_released(a, phase, 256);
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kGroupWarps) : "memory");
}

// The grouping warps (warps 0 to kGroupWarps - 1 of every block): phases
// 0-3, each after the one before it is done across the grid (phases 1 and
// 3 shared with the fill warps that finish first), the long runs' order
// (3b-3d), then phase 4 with the rest.  A touched row is known by its rank
// among the touched rows (the marks below it), so the grouping needs no
// table; a warp allocates its runs with one atomic.
template <int VEC>
__device__ void group_and_sum(const BwdArgs& a, int gw, int lane, int* sorted) {
  const long long G = (long long)gridDim.x * kGroupWarps;
  unsigned* cnt = a.counters;
  const long long words = (a.num_rows + 31) / 32;
  // 0: each word's rank (the marks below it: the marks of the chunks of
  // words below this warp's, counted as they were made, and a running sum
  // within) and each rank's row
  const long long cw = (words + G - 1) / G, w_lo = gw * cw, w_hi = min(words, w_lo + cw);
  unsigned first[kMarkAhead];  // the chunk's first words, in flight under the sums
#pragma unroll
  for (int q = 0; q < kMarkAhead; ++q) {
    const long long i = w_lo + q * 32 + lane;
    first[q] = i < w_hi ? __ldcg(a.bitmap + i) : 0u;
  }
  int base = 0, all = 0;
  for (long long v = lane; v < G; v += 32) {
    const int t = __ldcg(a.wchunk + v);
    all += t;
    base += v < gw ? t : 0;
  }
  base = warp_sum(base);
  all = warp_sum(all);
  if (gw == 0 && lane == 0) cnt[kRows * kCounterStride] = (unsigned)all;
  for (long long i0 = w_lo; i0 < w_hi; i0 += 32 * kMarkAhead) {
    unsigned words_q[kMarkAhead];
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q) {
      const long long i = i0 + q * 32 + lane;
      words_q[q] = i0 == w_lo ? first[q] : i < w_hi ? __ldcg(a.bitmap + i) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q) {
      const long long i = i0 + q * 32 + lane;
      unsigned word = words_q[q];
      const int incl = warp_incl(__popc(word), lane);
      int d = base + incl - __popc(word);
      if (i < w_hi) a.wprefix[i] = d;
      for (; word; word &= word - 1) a.rowof[d++] = (int)(i * 32 + __ffs(word) - 1);
      base += __shfl_sync(kFull, incl, 31);
    }
  }
  group_arrive_wait(a, kRanked, lane);
  // 1 (from kHelpFirstSlots slots shared with the fill warps)
  if (a.n >= kHelpFirstSlots) {
    share_slots<1>(a, lane);
    group_wait(a, kGrouped);
  } else {
    for (long long s0 = gw * a.chunk; s0 < a.n; s0 += G * a.chunk)
      for (long long s = s0; s < min(a.n, s0 + a.chunk); s += 32 * kGroupAhead)
        rank_slots(a, s, min(a.n, s0 + a.chunk), lane);
    group_arrive_wait(a, kGrouped, lane);
  }
  // 2: each run's start, and a long index and buckets for each run past
  // kSortCap: a warp a chunk of ranks, one atomic a warp for each count
  // (the counts and the chunks' marks are left at zero)
  if (lane == 0) a.wchunk[gw] = 0;
  const long long rows = all, cr = (rows + G - 1) / G, r_lo = gw * cr, r_hi = min(rows, r_lo + cr);
  int total = 0, hot = 0, cool = 0, nbk = 0;
  for (long long k = r_lo + lane; k < r_hi; k += 32) {
    const int len = __ldcg(a.counts + k);
    total += len;
    hot += len >= kHotRun;
    cool += len > kSortCap && len < kHotRun;
    nbk += len > kSortCap ? 1 << bucket_bits(len) : 0;
  }
  total = warp_sum(total);
  hot = warp_sum(hot);
  cool = warp_sum(cool);
  nbk = warp_sum(nbk);
  int at[4] = {0, 0, 0, 0};
  if (lane == 0) {
    if (total) at[0] = (int)atomicAdd(cnt + kTotal * kCounterStride, (unsigned)total);
    if (hot) at[1] = (int)atomicAdd(cnt + kHot * kCounterStride, (unsigned)hot);
    if (cool) at[2] = (int)atomicAdd(cnt + kCool * kCounterStride, (unsigned)cool);
    if (nbk) at[3] = (int)atomicAdd(cnt + kBuckets * kCounterStride, (unsigned)nbk);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) at[t] = __shfl_sync(kFull, at[t], 0);
  for (long long k0 = r_lo; k0 < r_hi; k0 += 32) {
    const long long k = k0 + lane;
    const int len = k < r_hi ? __ldcg(a.counts + k) : 0;
    const bool is_hot = len >= kHotRun, is_cool = len > kSortCap && !is_hot;
    const int nb = len > kSortCap ? 1 << bucket_bits(len) : 0;
    const int i_len = warp_incl(len, lane), i_hot = warp_incl(is_hot, lane);
    const int i_cool = warp_incl(is_cool, lane), i_nb = warp_incl(nb, lane);
    if (k < r_hi) {
      const int start = at[0] + i_len - len, row = __ldcg(a.rowof + k);
      const int j = is_hot ? at[1] + i_hot - 1 : is_cool ? a.long_cap - at[2] - i_cool : -1;
      if (j >= 0) a.longs[j] = make_int4(start, len, row, at[3] + i_nb - nb);
      a.ebase[k] = make_int2(start, j);
      a.runs[k] = make_int4(start, len, row, j);
      a.counts[k] = 0;
    }
    at[0] += __shfl_sync(kFull, i_len, 31);
    at[1] += __shfl_sync(kFull, i_hot, 31);
    at[2] += __shfl_sync(kFull, i_cool, 31);
    at[3] += __shfl_sync(kFull, i_nb, 31);
  }
  group_arrive_wait(a, kBased, lane);
  // 3 (likewise)
  if (a.n >= kHelpFirstSlots) {
    share_slots<3>(a, lane);
    group_wait(a, kPlaced);
  } else {
    for (long long s0 = gw * a.chunk; s0 < a.n; s0 += G * a.chunk)
      for (long long s = s0; s < min(a.n, s0 + a.chunk); s += 32 * kGroupAhead)
        place_slots(a, s, min(a.n, s0 + a.chunk), lane);
    group_arrive_wait(a, kPlaced, lane);
  }
  // the last launch's marks cleared: the next launch marks that half
  for (long long u = gw * 32ll + lane; u < a.stale_words; u += G * 32) a.stale[u] = 0u;
  if (long_runs(a)) {  // 3b-3d (3c and 3d shared with the fill warps)
    scan_buckets(a, gw, lane);
    group_arrive_wait(a, kScanned, lane);
    share_buckets<kScattered>(a, lane, sorted);
    group_wait(a, kScattered);
    share_buckets<kOrdered>(a, lane, sorted);
    group_wait(a, kOrdered);
    const long long nbuckets = __ldcg(cnt + kBuckets * kCounterStride);
    for (long long g = gw * 32ll + lane; g < nbuckets; g += G * 32) a.buckets[g] = 0;
    sum_long_runs<VEC>(a, lane);
  }
  sum_short_runs<VEC>(a, lane, sorted);
}

// A fill warp done with its stores: the tasks left of phase 1 once the
// ranks are out, of phase 3 once the runs are based, and, if there are long
// runs, of 3c once the buckets are scanned and of 3d once they are filled;
// then back to the sums.
__device__ void help_group(const BwdArgs& a, int lane, int* sorted) {
  // stage k's tasks are out once phase `out` is released, done at `done`
  auto out = [](int k) {
    return k == 0 ? kRanked : k == 1 ? kBased : k == 2 ? kScanned : kScattered;
  };
  auto done = [](int k) {
    return k == 0 ? kGrouped : k == 1 ? kPlaced : k == 2 ? kScattered : kOrdered;
  };
  // below kHelpFirstSlots the grouping warps take phases 1 and 3 alone
  for (int stage = a.n >= kHelpFirstSlots ? 0 : 2; stage < 4; ++stage) {
    if (stage == 2) {  // every slot placed: the long runs, if any, are next
      if (lane == 0) wait_released(a, kPlaced, 256);
      __syncwarp();
      if (!long_runs(a)) return;
    }
    int state = 0;  // 2: the stage's phase is done, 1: its tasks are out, 0: not yet
    unsigned sleep_ns = 256;
    const unsigned long long t0 = global_ns();
    for (;;) {
      if (lane == 0)
        state = released(a, done(stage)) ? 2 : released(a, out(stage)) ? 1 : 0;
      state = __shfl_sync(kFull, state, 0);
      if (state) break;
      __nanosleep(sleep_ns);
      sleep_ns = sleep_ns < 2048 ? 2 * sleep_ns : 2048;
      if (global_ns() - t0 > kSpinLimitNs) __trap();
    }
    if (state == 2) continue;
    if (stage == 0)
      share_slots<1>(a, lane);
    else if (stage == 1)
      share_slots<3>(a, lane);
    else if (stage == 2)
      share_buckets<kScattered>(a, lane, sorted);
    else
      share_buckets<kOrdered>(a, lane, sorted);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks) bag_backward_kernel(BwdArgs a) {
  __shared__ int sorted[kBwdThreads / 32][kSortCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* cnt = a.counters;
  // every thread: each live slot's row marked in the bitmap (its id and
  // weight read together; a masked slot's id is read and not used),
  // kMarkAhead slots' loads in flight
  const long long stride = (long long)gridDim.x * kBwdThreads;
  const long long chunk_words =  // a grouping warp's chunk of bitmap words in phase 0
      ((a.num_rows + 31) / 32 + gridDim.x * kGroupWarps - 1) / (gridDim.x * kGroupWarps);
  for (long long s0 = (long long)blockIdx.x * kBwdThreads + threadIdx.x; s0 < a.n;
       s0 += kMarkAhead * stride) {
    int32_t id[kMarkAhead];
    bool live[kMarkAhead];
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q) {
      const long long s = s0 + q * stride;
      id[q] = s < a.n ? __ldg(a.idx + s) : 0;
      live[q] = s < a.n && !(a.masked && __ldg(a.w + s) == 0.f);
    }
    // in a large batch a word holds a table's hottest rows: a bit already
    // set is read, not marked again
    unsigned seen[kMarkAhead];
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q)
      seen[q] = live[q] && a.n >= kHelpFirstSlots
                    ? __ldcg(a.bitmap + (clamp_row(id[q], a.num_rows) >> 5)) : 0u;
    unsigned was[kMarkAhead];  // the word before this slot's mark, all bits set if none
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q) {
      const int64_t row = clamp_row(id[q], a.num_rows);
      was[q] = ~0u;
      if (live[q] && !((seen[q] >> (row & 31)) & 1u))
        was[q] = atomicOr(a.bitmap + (row >> 5), 1u << (row & 31));
    }
#pragma unroll
    for (int q = 0; q < kMarkAhead; ++q) {  // a new mark counts in its chunk of words
      const int64_t row = clamp_row(id[q], a.num_rows);
      if (!((was[q] >> (row & 31)) & 1u)) atomicAdd(a.wchunk + (row >> 5) / chunk_words, 1);
    }
  }
  __threadfence();
  __syncthreads();
  if (warp == 0) {  // the bitmap is whole once every block has marked
    warp_arrive(a, kMarked, gridDim.x, lane);
    if (lane == 0) wait_released(a, kMarked, 32);
  }
  __syncthreads();
  if (warp < kGroupWarps) {
    group_and_sum<VEC>(a, blockIdx.x * kGroupWarps + warp, lane, sorted[warp]);
  } else {
    if (a.n >= kHelpFirstSlots) {  // phases 1 and 3 on every warp first, the fill after
      if (lane == 0) wait_released(a, kRanked, 256);
      __syncwarp();
      share_slots<1>(a, lane);
      if (lane == 0) wait_released(a, kBased, 256);
      __syncwarp();
      share_slots<3>(a, lane);
    }
    fill_untouched<VEC>(a);
    // then the grouping's tasks of phases 1 and 3 left, if any, then the
    // sums: the short runs once every slot is placed, the long runs' once
    // each is ordered (a fill warp that gets there first waits)
    help_group(a, lane, sorted[warp]);
    sum_short_runs<VEC>(a, lane, sorted[warp]);
    if (long_runs(a)) {
      if (lane == 0) wait_released(a, kOrdered, 256);
      __syncwarp();
      sum_long_runs<VEC>(a, lane);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the last block out leaves the counters at zero
    __threadfence();
    if (atomicAdd(cnt + kTicket * kCounterStride, 1u) == gridDim.x - 1)
      for (int i = 0; i < kCounters; ++i) cnt[i * kCounterStride] = 0u;
  }
}

template <int VEC>
int launch_backward(const BwdArgs& a, long long blocks, void* stream) {
  void* args[] = {const_cast<BwdArgs*>(&a)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)bag_backward_kernel<VEC>, dim3((unsigned)blocks), dim3(kBwdThreads), args,
      0, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int VEC>
int backward_occupancy() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bag_backward_kernel<VEC>, kBwdThreads, 0);
  return err ? -(int)err : blocks;
}

}  // namespace

extern "C" {

// table [num_rows, dim], idx [num_bags * nnz] int32, w [num_bags * nnz] f32,
// out [num_bags, dim] f32.  vec (elements a lane loads at once: 4 or 1 for
// f32, 8 or 1 for bf16), lanes, nnz_spec (nnz, or 0 for the general loop)
// and blocks are the host's launch plan; masked is 0 or 1.  Returns
// cudaGetLastError() after the launch.
int embedding_bag_f32(const void* table, const void* idx, const void* w, void* out,
                      long long num_bags, int nnz, int dim, long long num_rows,
                      int vec, int lanes, int nnz_spec, int masked, long long blocks,
                      void* stream) {
  if (!plan_ok(table, out, num_bags, nnz, dim, vec, lanes, nnz_spec, blocks))
    return (int)cudaErrorInvalidValue;
  return dispatch<float, 4, Launch>(vec, nnz_spec, masked, table, idx, w, out,
                                    num_bags, nnz, dim, num_rows, lanes, blocks, stream);
}

int embedding_bag_bf16(const void* table, const void* idx, const void* w, void* out,
                       long long num_bags, int nnz, int dim, long long num_rows,
                       int vec, int lanes, int nnz_spec, int masked, long long blocks,
                       void* stream) {
  if (!plan_ok(table, out, num_bags, nnz, dim, vec, lanes, nnz_spec, blocks))
    return (int)cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16, 8, Launch>(vec, nnz_spec, masked, table, idx, w, out,
                                            num_bags, nnz, dim, num_rows, lanes, blocks,
                                            stream);
}

// Resident blocks per SM of the kernel of (vec, nnz_spec, masked), or minus
// a CUDA error code.
int embedding_bag_occupancy_f32(int vec, int nnz_spec, int masked) {
  return dispatch<float, 4, Occupancy>(vec, nnz_spec, masked);
}

int embedding_bag_occupancy_bf16(int vec, int nnz_spec, int masked) {
  return dispatch<__nv_bfloat16, 8, Occupancy>(vec, nnz_spec, masked);
}

// K1': grad [num_rows, dim] f32 (every row written: no fill needed) from
// grad_out [n / nnz, dim] f32, idx [n] int32 and w [n] f32; masked is 0 or
// 1.  vec is 4 (dim % 4 == 0, grad_out and grad on 16-byte boundaries) or
// 1; blocks at most the card's resident blocks of the kernel (a
// cooperative launch refuses more).  The scratch is the wrapper's, kept
// between calls: counters, wchunk, counts and buckets zero (the kernel
// leaves them so), flags a 128-byte line a block, which hold earlier
// launches' numbers or 0, epoch this launch's number (never 0 and none of
// theirs), wchunk kGroupWarps words a block, wprefix a word a bitmap word,
// longs long_cap int4 (at least n / (kSortCap + 1)), buckets and brun
// bucket_cap words (see kernels/embedding_bag.py), the rest n entries each
// (ebase n int2, runs n int4); bitmap is the zeroed half of the bitmap this
// launch marks, stale the other half, whose first stale_words words the
// last launch marked and this one clears.  Returns the launch's CUDA error
// code.
int embedding_bag_backward_f32(const void* grad_out, const void* idx, const void* w, void* grad,
                               long long n, int nnz, int dim, long long num_rows, int masked,
                               int vec, long long blocks, void* counters, void* flags,
                               unsigned epoch, void* bitmap, void* stale,
                               long long stale_words, void* wchunk, void* wprefix, void* counts,
                               void* ebase, void* runs, void* rowof, void* slot_entry,
                               void* slot_rank, void* list, void* longs, void* buckets,
                               void* brun, void* order, long long long_cap,
                               long long bucket_cap, void* stream) {
  const bool aligned = (((uintptr_t)grad_out | (uintptr_t)grad) & 15u) == 0;
  int slot_bits = 0;
  while ((1ll << slot_bits) < n) ++slot_bits;
  if (n < 0 || n >= 0x7fffffffll || (n > 0 && (nnz <= 0 || n % nnz)) || dim <= 0 ||
      num_rows <= 0 || num_rows >= 0x7fffffffll || blocks <= 0 || blocks >= (1ll << 31) ||
      stale_words < 0 || epoch == 0 || long_cap < 1 || long_cap < n / (kSortCap + 1) ||
      long_cap >= (1ll << 31) || bucket_cap < n / 16 + 2 * (n / (kSortCap + 1)) + 1 ||
      (((uintptr_t)runs | (uintptr_t)longs) & 15u) || ((uintptr_t)ebase & 7u) || dim % vec ||
      (vec == 4 && !aligned))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.grad_out = (const float*)grad_out;
  a.idx = (const int32_t*)idx;
  a.w = (const float*)w;
  a.grad = (float*)grad;
  a.n = n;
  a.nnz = nnz;
  a.dim = dim;
  a.num_rows = num_rows;
  a.masked = masked;
  a.counters = (unsigned*)counters;
  a.flags = (unsigned*)flags;
  a.epoch = epoch;
  a.bitmap = (unsigned*)bitmap;
  a.stale = (unsigned*)stale;
  a.stale_words = stale_words;
  a.wchunk = (int*)wchunk;
  a.wprefix = (int*)wprefix;
  a.counts = (int*)counts;
  a.ebase = (int2*)ebase;
  a.runs = (int4*)runs;
  a.rowof = (int*)rowof;
  a.slot_entry = (int*)slot_entry;
  a.slot_rank = (int*)slot_rank;
  a.list = (int*)list;
  a.longs = (int4*)longs;
  a.buckets = (int*)buckets;
  a.brun = (int*)brun;
  a.order = (int*)order;
  a.long_cap = (int)long_cap;
  a.slot_bits = slot_bits;
  // two tasks a grouping warp at least, at most 16 passes a task
  const long long pass = 32 * kGroupAhead, warps = blocks * kGroupWarps;
  const long long per = n / (2 * warps) / pass * pass;
  a.chunk = per < pass ? pass : per > 16 * pass ? 16 * pass : per;
  if (vec == 4) return launch_backward<4>(a, blocks, stream);
  if (vec == 1) return launch_backward<1>(a, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// K1''s resident blocks per SM at vec (4 or 1), or minus a CUDA error code.
int embedding_bag_backward_occupancy(int vec) {
  if (vec == 4) return backward_occupancy<4>();
  if (vec == 1) return backward_occupancy<1>();
  return -(int)cudaErrorInvalidValue;
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
