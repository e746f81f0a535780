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
// written once (326 MB for dlrm-100m's table), against a few MB of slots.
// A kernel that zeroes the output and then writes the touched rows again,
// or that runs a library sort between the two, pays for the sort's
// launches and passes on top of the fill.
//
// What the design does about it: one persistent kernel, one wave of
// resident blocks launched together (a cooperative launch, so every block
// is resident and the phases below may wait on each other), writes every
// row exactly once and groups the slots by row by itself, with no sort:
//  * Marks.  Every thread marks its live slots' clamped rows in a bitmap of
//    V bits; one grid-wide barrier, then the bitmap is whole.  That is all
//    that runs ahead of the fill.
//  * Fill.  Warps 2-7 of every block sweep the output as a plain fill
//    does (grid-stride 16-byte streamed zero stores, each thread's bitmap
//    words loaded kFillAhead steps ahead), skipping the rows whose bit is
//    set, with no barrier and no word a block must own: both ran slower
//    (PERF.md), and so did 3 or 4 blocks an SM against 2.
//  * Grouping (warps 0-1 of every block, beside the fill; grid-wide
//    barriers between the phases): each live slot inserts its row into an
//    open-addressed table of at least 2N entries and counts the entry's
//    slots (1); each entry takes a start in a slot list from an atomic
//    running total, in any order (2); each slot is placed in its entry's
//    run, in any order (3).  A barrier's last arrival writes a flag line
//    for each block and each block polls its own, rarely: many pollers of
//    one line hold its L2 slice, and with it the fill's stores.
//  * Sums (4).  Runs go out one at a time from a grid-wide count, to the
//    grouping warps once every slot is placed and to the fill warps that
//    finish their stores after that (they never wait for it).  A warp
//    visits a run's slots in slot order: up to kSortCap slots by their
//    ranks among the run's (shuffles), longer runs through shared bitmap
//    windows of kWindow slots from the least slot not yet summed.  Each
//    row is w * grad_out rounded and then added, in slot order from 0, as
//    the reference's scatter-add does, with no atomics in the sums: the
//    same bits on every run.  A run may be any length, up to every slot.
// The atomics only decide where a run lies in the list and its order
// there, never what is summed or in what order.  The scratch (counters,
// flags, bitmap, table, list) is kept by the wrapper per (device, stream);
// the kernel leaves the counters, table and counts at zero as it reads
// them, and a flag holds the number of the launch that wrote it.  The
// bitmap has two halves: a launch marks one and clears the other, the last
// launch's marks, so no fill warp waits for the others to be done with a
// word before it is cleared.
//
// What it reaches (PERF.md): the fill alone runs 10-15% slower than
// a plain fill, and the grouping's atomics and loads beside it cost the
// rest; at dlrm-100m's batch it takes 1.11x the time of index_add_ into a
// zeroed table, against the 1.62x of the sort-based design before it.

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
constexpr int kSortCap = 128;  // runs up to this long are ordered by rank
constexpr int kWindow = 32 * kSortCap;  // longer runs: slots a bitmap window spans
constexpr int kSumBatch = 8;  // slots' loads in flight in a run's sum
constexpr int kBwdMinBlocks = 4;  // ptxas keeps 64 registers a thread (2 blocks an SM run)
constexpr int kFillAhead = 4;  // fill steps whose bitmap words are in flight
constexpr int kCounterStride = 32;  // one 128-byte line a counter
constexpr unsigned long long kSpinLimitNs = 2000000000ull;  // a wait past 2 s traps
// counters[i * kCounterStride]: grid-wide counts, all zero between launches
enum { kMarked, kGrouped, kBased, kPlaced, kNextRun, kEntries, kTotal, kTicket, kCounters };

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
  unsigned* keys;      // [table]: row + 1 of an entry, zeros
  int* counts;         // [table]: the entry's slots, zeros
  int* ebase;          // [table]: the entry's run's start in list
  int* elist;          // [n]: the entries in use
  int4* runs;          // [n]: (start, length, row, 0) of each entry in use
  int* slot_entry;     // [n]: a slot's entry, -1 for a masked slot
  int* list;           // [n]: the live slots, each entry's run together
  unsigned table_mask;
  int table_shift;  // 32 - log2(table)
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

// A grid-wide barrier for phase `phase` of `arrivals` warps: each warp
// counts itself in; the last one writes this launch's number into every
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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

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

// A grouping warp: the sum of one run (list[start, start + len), the slots
// of row `row`) in slot order into its row.  Runs up to kSortCap long are
// ordered by rank in `sorted`; longer ones are walked through bitmap
// windows of kWindow slots (the same shared words), from the least slot not
// yet summed.  kSumBatch slots' loads are in flight at a time.
template <int VEC>
__device__ void sum_run(const BwdArgs& a, int start, int len, long long row, int lane,
                        int* sorted) {
  constexpr int kPer = kSortCap / 32;
  const int nv = a.dim / VEC;
  const int* run = a.list + start;
  unsigned* bm = reinterpret_cast<unsigned*>(sorted);
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < nv;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    // visit(ss): the next kSumBatch slots in order (-1 past the end) summed
    auto visit = [&](const int (&ss)[kSumBatch]) {
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
    };
    if (len <= kSortCap) {
      int mine[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = q * 32 + lane;
        mine[q] = i < len ? __ldcg(run + i) : INT_MAX;
      }
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
        if (q * 32 + lane < len) sorted[rank[q]] = mine[q];
      __syncwarp();
      for (int k0 = 0; k0 < len; k0 += kSumBatch) {
        int ss[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) ss[u] = k0 + u < len ? sorted[k0 + u] : -1;
        visit(ss);
      }
      __syncwarp();  // every lane has read `sorted` before it is reused
    } else {
      int lo = INT_MAX;  // the least slot not yet summed
      for (int i = lane; i < len; i += 32) lo = min(lo, __ldcg(run + i));
      lo = warp_min(lo);
      while (lo != INT_MAX) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) bm[q * 32 + lane] = 0u;
        __syncwarp();
        int next = INT_MAX;  // the least slot past this window
        for (int i = lane; i < len; i += 32) {
          const int s = __ldcg(run + i);
          const unsigned d = (unsigned)(s - lo);
          if (d < (unsigned)kWindow)
            atomicOr(bm + (d >> 5), 1u << (d & 31));
          else if (s > lo)
            next = min(next, s);
        }
        __syncwarp();
        int wi = 0;  // every lane walks the same bits
        unsigned bits = bm[0];
        for (;;) {
          int ss[kSumBatch];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            while (bits == 0u && wi + 1 < kSortCap) bits = bm[++wi];
            ss[u] = -1;
            if (bits) {
              ss[u] = lo + (wi << 5) + __ffs(bits) - 1;
              bits &= bits - 1;
            }
          }
          visit(ss);
          if (ss[kSumBatch - 1] < 0) break;
        }
        next = warp_min(next);
        __syncwarp();  // every lane has read the window before it is cleared
        lo = next;
      }
    }
    if (col) store_vec<VEC>(a.grad + row * a.dim + (long long)c * VEC, acc);
  }
}

// 4 (any warp, once every slot is placed): runs taken from a grid-wide
// count, each summed in slot order into its row.  The grouping warps start
// on them at once; fill warps join as they finish their stores, so no run
// waits behind a busy warp.
template <int VEC>
__device__ void sum_runs(const BwdArgs& a, int lane, int* sorted) {
  unsigned* cnt = a.counters;
  const unsigned entries = __ldcg(cnt + kEntries * kCounterStride);
  for (;;) {
    unsigned k = 0;
    if (lane == 0) k = atomicAdd(cnt + kNextRun * kCounterStride, 1u);
    k = __shfl_sync(kFull, k, 0);
    if (k >= entries) break;
    const int4 r = __ldcg(a.runs + k);
    sum_run<VEC>(a, r.x, r.y, r.z, lane, sorted);
  }
}

// The grouping warps (warps 0 to kGroupWarps - 1 of every block): phases
// 1-3, each after every grouping warp has finished the one before it, then
// phase 4 with the rest.
template <int VEC>
__device__ void group_and_sum(const BwdArgs& a, int gw, int lane, int* sorted) {
  const long long G = (long long)gridDim.x * kGroupWarps;
  unsigned* cnt = a.counters;
  // 1: insert each live slot's row, count the entry's slots, list the entries
  for (long long s0 = gw * 32ll; s0 < a.n; s0 += G * 32) {
    const long long s = s0 + lane;
    int e = -1;
    bool first = false;
    if (s < a.n) {
      if (!(a.masked && __ldg(a.w + s) == 0.f)) {
        const int64_t row = clamp_row(__ldg(a.idx + s), a.num_rows);
        const unsigned key = (unsigned)row + 1u;
        unsigned h = ((unsigned)row * 2654435769u) >> a.table_shift;
        for (;;) {
          const unsigned prev = atomicCAS(a.keys + h, 0u, key);
          if (prev == 0u || prev == key) break;
          h = (h + 1u) & a.table_mask;
        }
        e = (int)h;
        first = atomicAdd(a.counts + e, 1) == 0;
        // the slot's gradient row, for phase 4: into L2 while the fill runs
        const char* g = reinterpret_cast<const char*>(a.grad_out + (s / a.nnz) * a.dim);
        for (int off = 0; off < a.dim * 4; off += 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(g + off));
      }
      a.slot_entry[s] = e;
    }
    const unsigned firsts = __ballot_sync(kFull, first);
    if (firsts) {
      unsigned at = 0;
      if (lane == 0) at = atomicAdd(cnt + kEntries * kCounterStride, (unsigned)__popc(firsts));
      at = __shfl_sync(kFull, at, 0);
      if (first) a.elist[at + __popc(firsts & ((1u << lane) - 1u))] = e;
    }
  }
  group_arrive_wait(a, kGrouped, lane);
  // 2: a run's start for each entry; the table's keys are left at zero
  const unsigned entries = __ldcg(cnt + kEntries * kCounterStride);
  for (long long k0 = gw * 32ll; k0 < entries; k0 += G * 32) {
    const long long k = k0 + lane;
    int e = 0, len = 0, row = 0;
    if (k < entries) {
      e = __ldcg(a.elist + k);
      len = __ldcg(a.counts + e);
      row = (int)(__ldcg(a.keys + e) - 1u);
      a.keys[e] = 0u;
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    unsigned at = 0;
    if (lane == 31) at = atomicAdd(cnt + kTotal * kCounterStride, (unsigned)incl);
    at = __shfl_sync(kFull, at, 31);
    if (k < entries) {
      const int start = (int)at + incl - len;
      a.ebase[e] = start;
      a.runs[k] = make_int4(start, len, row, 0);
    }
  }
  group_arrive_wait(a, kBased, lane);
  // 3: each live slot into its run; the counts are left at zero
  for (long long s = gw * 32ll + lane; s < a.n; s += G * 32) {
    const int e = __ldcg(a.slot_entry + s);
    if (e >= 0) a.list[__ldcg(a.ebase + e) + atomicSub(a.counts + e, 1) - 1] = (int)s;
  }
  group_arrive_wait(a, kPlaced, lane);
  // the last launch's marks cleared: the next launch marks that half
  for (long long u = gw * 32ll + lane; u < a.stale_words; u += G * 32) a.stale[u] = 0u;
  sum_runs<VEC>(a, lane, sorted);
}

template <int VEC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks) bag_backward_kernel(BwdArgs a) {
  __shared__ int sorted[kBwdThreads / 32][kSortCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* cnt = a.counters;
  // every thread: each live slot's row marked in the bitmap (its id and
  // weight read together; a masked slot's id is read and not used)
  for (long long s = (long long)blockIdx.x * kBwdThreads + threadIdx.x; s < a.n;
       s += (long long)gridDim.x * kBwdThreads) {
    const int32_t id = __ldg(a.idx + s);
    if (!(a.masked && __ldg(a.w + s) == 0.f)) {
      const int64_t row = clamp_row(id, a.num_rows);
      atomicOr(a.bitmap + (row >> 5), 1u << (row & 31));
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
    fill_untouched<VEC>(a);
    // runs left to sum, if every slot is placed: a fill warp never waits,
    // and reads the count before it takes a run from it
    if (__shfl_sync(kFull, lane == 0 && released(a, kPlaced) &&
                               __ldcg(cnt + kNextRun * kCounterStride) <
                                   __ldcg(cnt + kEntries * kCounterStride), 0))
      sum_runs<VEC>(a, lane, sorted[warp]);
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
// between calls: counters, keys and counts zero (the kernel leaves them
// so), flags a 128-byte line a block, which hold earlier launches' numbers
// or 0, epoch this launch's number (never 0 and none of theirs), the table 2^table_bits entries (at least 2n), the rest n entries
// each (runs n int4); bitmap is the zeroed half of the bitmap this launch
// marks, stale the other half, whose first stale_words words the last
// launch marked and this one clears.  Returns the launch's CUDA error code.
int embedding_bag_backward_f32(const void* grad_out, const void* idx, const void* w, void* grad,
                               long long n, int nnz, int dim, long long num_rows, int masked,
                               int vec, long long blocks, void* counters, void* flags,
                               unsigned epoch, void* bitmap, void* stale,
                               long long stale_words, void* keys, void* counts,
                               void* ebase, void* elist, void* runs, void* slot_entry,
                               void* list, int table_bits, void* stream) {
  const bool aligned = (((uintptr_t)grad_out | (uintptr_t)grad) & 15u) == 0;
  if (n < 0 || n >= 0x7fffffffll || (n > 0 && (nnz <= 0 || n % nnz)) || dim <= 0 ||
      num_rows <= 0 || num_rows >= 0x7fffffffll || blocks <= 0 || blocks >= (1ll << 31) ||
      table_bits < 1 || table_bits > 31 || (1ll << table_bits) < 2 * n || stale_words < 0 ||
      epoch == 0 ||
      ((uintptr_t)runs & 15u) || dim % vec || (vec == 4 && !aligned))
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
  a.keys = (unsigned*)keys;
  a.counts = (int*)counts;
  a.ebase = (int*)ebase;
  a.elist = (int*)elist;
  a.runs = (int4*)runs;
  a.slot_entry = (int*)slot_entry;
  a.list = (int*)list;
  a.table_mask = (unsigned)((1ll << table_bits) - 1);
  a.table_shift = 32 - table_bits;
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
