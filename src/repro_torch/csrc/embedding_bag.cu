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
// The wrapper zeroes the output (torch.zeros), so every row that no slot
// names is right before the kernel runs.
//
// What the design does about it: it is deterministic, so a training run
// replays bit for bit.  A first kernel writes each slot's key (its clamped
// row, or V for a masked slot); the wrapper sorts the keys (torch.sort,
// stable, so the slots of one row stay in slot order); then one group of
// lanes owns each run of equal keys and sums its slots in slot order,
// w * grad_out rounded and then added, as the reference's scatter-add does,
// with no atomics.  The group spans the row with 16-byte vectors and keeps
// four slots' loads in flight.  Only the touched rows are written by it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// keys[s] = clamp(idx[s], 0, V - 1), or V for a masked slot (masked && w == 0).
__global__ void bag_backward_keys_kernel(const int32_t* __restrict__ idx,
                                         const float* __restrict__ w,
                                         int32_t* __restrict__ keys, long long n,
                                         long long num_rows, int masked) {
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x)
    keys[s] = masked && w[s] == 0.f ? (int32_t)num_rows
                                    : (int32_t)clamp_row(idx[s], num_rows);
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

// keys: sorted ascending; perm[j]: the slot of sorted position j.  A group
// of `lanes` threads takes one sorted position at a time; the first position
// of each run of a row below V sums the run and writes the row.  No
// shuffles, so groups of one warp may leave their loops at different times.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_backward_kernel(const float* __restrict__ grad_out, const int32_t* __restrict__ keys,
                    const int64_t* __restrict__ perm, const float* __restrict__ w,
                    float* __restrict__ grad, long long n, int nnz, int dim,
                    long long num_rows, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads / lanes;
  const long long stride = (long long)gridDim.x * groups;
  const int nvec = dim / VEC;
  for (long long pos = (long long)blockIdx.x * groups + threadIdx.x / lanes; pos < n;
       pos += stride) {
    const int32_t key = __ldg(keys + pos);
    if (key >= num_rows || (pos > 0 && __ldg(keys + pos - 1) == key)) continue;
    for (int c = lane; c < nvec; c += lanes) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      for (long long j0 = pos;; j0 += kBatch) {
        float v[kBatch][VEC];
        float wj[kBatch];
        bool live[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const long long j = j0 + u;
          live[u] = j < n && __ldg(keys + j) == key;
          wj[u] = 0.f;
          if (live[u]) {
            const long long s = __ldg(reinterpret_cast<const long long*>(perm) + j);
            wj[u] = __ldg(w + s);
            load_vec<VEC>(grad_out + (s / nnz) * dim + (long long)c * VEC, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (live[u])
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wj[u], v[u][k]));
        if (!live[kBatch - 1]) break;  // sorted: the run ended in this batch
      }
      float* o = grad + (long long)key * dim + (long long)c * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = acc[k];
      }
    }
  }
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

// K1' step 1: keys [n] int32 from idx [n] int32 and w [n] f32 (num_rows <
// 2^31 - 1, so the masked key V fits).  Returns cudaGetLastError().
int embedding_bag_backward_keys(const void* idx, const void* w, void* keys, long long n,
                                long long num_rows, int masked, long long blocks,
                                void* stream) {
  if (n <= 0 || num_rows <= 0 || num_rows >= 0x7fffffffll || blocks <= 0 ||
      blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  bag_backward_keys_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)w, (int32_t*)keys, n, num_rows, masked);
  return (int)cudaGetLastError();
}

// K1' step 2: grad [num_rows, dim] f32 (zeroed by the caller) from
// grad_out [n / nnz, dim] f32, the sorted keys [n] int32, perm [n] int64 (the
// slot of each sorted key) and w [n] f32.  vec is 4 (dim % 4 == 0, grad_out
// and grad on 16-byte boundaries) or 1; lanes a power of two <= 32.
int embedding_bag_backward_f32(const void* grad_out, const void* keys, const void* perm,
                               const void* w, void* grad, long long n, int nnz, int dim,
                               long long num_rows, int vec, int lanes, long long blocks,
                               void* stream) {
  const bool aligned = (((uintptr_t)grad_out | (uintptr_t)grad) & 15u) == 0;
  if (n <= 0 || nnz <= 0 || n % nnz || dim <= 0 || num_rows <= 0 ||
      num_rows >= 0x7fffffffll || blocks <= 0 || blocks >= (1ll << 31) || lanes <= 0 ||
      lanes > 32 || (lanes & (lanes - 1)) || dim % vec || (vec == 4 && !aligned))
    return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    bag_backward_kernel<4><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)grad_out, (const int32_t*)keys, (const int64_t*)perm,
        (const float*)w, (float*)grad, n, nnz, dim, num_rows, lanes);
  } else if (vec == 1) {
    bag_backward_kernel<1><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)grad_out, (const int32_t*)keys, (const int64_t*)perm,
        (const float*)w, (float*)grad, n, nnz, dim, num_rows, lanes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
