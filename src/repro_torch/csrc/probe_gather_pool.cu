// Kernel K3: fused hot-cache probe + gather + pool + miss mask for Hopper,
// sm_90a.
//
// Replaces: src/repro/hotcache/kernels.py::probe_gather_pool, the Pallas TPU
// kernel (pallas_call at :99) whose grid walks (bag, slot, probe step) and
// DMAs each probed key and row block into VMEM through scalar-prefetched ids.
//
//   slot(id)     = first s in (home(id) + p) & (C-1), p < max_probes, with
//                  keys[s] == id; none for EMPTY_KEY or when no probe matches
//   home(id)     = (uint32(id) * 2654435761) >> shift & (C-1),
//                  shift = max(1, 33 - bit_length(C))  (0 when C == 1)
//   out[b, :]    = sum_j w[b*nnz+j] * float(values[slot(ids[b*nnz+j]), :])
//                  over the slots that hit
//   miss[i]      = no slot for ids[i]
//
// The hash is the reference's wrapping int32 multiply followed by a logical
// shift (repro/hotcache/table.py::hash_slots), computed on uint32; a shift
// of 32 (C == 1) is undefined in C++, so that case takes slot 0.  The probe
// stops at the first match, so a hit is pooled once even when C < max_probes
// makes the window repeat slots (the Pallas kernel pools such a hit once per
// repeat; the port follows the reference oracle, hotcache/ref.py).
//
// What bounds it on the card: bytes.  Each live id reads up to max_probes
// keys (4 bytes each, usually one or two) and, on a hit, one D-wide row of a
// table of C rows (dlrm-flexemr's cache: 2^18 x 64 f32, 67 MB, larger than
// L2), two flops per element: a random gather at memory rate, held back by
// its chain of dependent loads (id, then keys, then row).
//
// What the design does about it: K1's lanes and one-wave grid
// (csrc/embedding_bag.cu, kernels/embedding_bag.py::launch_plan), and more
// bags a pass.  A group of `lanes` threads spans a row with 16-byte vector
// loads and, for the configs' nnz, takes several consecutive bags a pass
// (4 of nnz 4 at D = 64 f32: 16 slots, 16 f32 sums a lane), lane s loading
// slot s's id and weight and probing it, so all slots of a pass probe at
// once and the registers hold only the rows of hits.  Where the window
// home .. home + max_probes - 1 does not wrap (and C >= 4, max_probes <= 8)
// the lane reads it as the aligned 16-byte key vectors that cover it, all
// issued together, and takes the first match; otherwise it steps through
// the window one key at a time.  The probing lanes write the miss bytes; a
// ballot lists the hits, whose rows load four at a time, slots handed out
// by __shfl_sync, into the f32 sums of their bags, in slot order.  The
// grid is at most one wave and strides over the bags, each group loading
// its next pass's ids and weights before it waits on the current loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_vec.cuh"

namespace {

constexpr int32_t kEmptyKey = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kBatch = 4;  // row loads in flight per lane
constexpr int kWideProbes = 8;  // largest window read as key vectors
constexpr unsigned kFull = 0xffffffffu;

// Slot holding `id`, or -1 when it is absent (EMPTY_KEY is always absent).
// `wide`: keys is 16-byte aligned and C >= 4, so an aligned 4-key vector
// that starts inside [0, C) ends inside it.
__device__ __forceinline__ int32_t probe(const int32_t* __restrict__ keys, int32_t id,
                                         uint32_t mask, int shift, int max_probes,
                                         bool wide) {
  if (id == kEmptyKey) return -1;
  const uint32_t h = (uint32_t)id * 2654435761u;
  const uint32_t home = shift >= 32 ? 0u : ((h >> shift) & mask);
  const uint32_t last = home + (uint32_t)max_probes - 1u;
  if (wide && max_probes <= kWideProbes && last <= mask) {
    // The window lies in at most three aligned 4-key vectors from base.
    const uint32_t base = home & ~3u;
    int4 q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      q[k] = make_int4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
      if (base + 4u * k <= last) q[k] = __ldg(reinterpret_cast<const int4*>(keys + base) + k);
    }
    int32_t found = -1;
#pragma unroll
    for (int k = 2; k >= 0; --k) {  // backwards: the first match is written last
      const int32_t v[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const uint32_t pos = base + 4u * k + e;
        if (pos >= home && pos <= last && v[e] == id) found = (int32_t)pos;
      }
    }
    return found;
  }
  for (int p = 0; p < max_probes; ++p) {
    const uint32_t s = (home + (uint32_t)p) & mask;
    if (__ldg(keys + s) == id) return (int32_t)s;
  }
  return -1;
}

// Bags a group takes a pass in the unrolled path: 16 f32 accumulators a lane.
template <int VEC>
constexpr int kMaxBags = VEC >= 4 ? 16 / VEC : 1;

// NNZ > 0 (nnz == NNZ, pass_bags * NNZ <= lanes): a pass takes pass_bags
// consecutive bags, lane s probing slot s % NNZ of bag s / NNZ; a ballot
// lists the hits, whose rows load kBatch at a time into per-bag sums.
// NNZ == 0 (pass_bags == 1): any nnz, slots in chunks of `lanes`.
template <typename T, int VEC, int NNZ>
__global__ void __launch_bounds__(kThreads)
probe_gather_pool_kernel(const int32_t* __restrict__ keys, const T* __restrict__ values,
                         const int32_t* __restrict__ ids, const float* __restrict__ w,
                         float* __restrict__ out, uint8_t* __restrict__ miss,
                         int64_t num_bags, int nnz_rt, int dim, uint32_t mask, int shift,
                         int max_probes, int lanes, int pass_bags, bool wide) {
  using V = Vec<T, VEC>;
  const int nnz = NNZ > 0 ? NNZ : nnz_rt;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads / lanes;
  // Groups of one warp hold consecutive bags: the loop bound is warp-wide.
  const int in_warp = (threadIdx.x & 31) / lanes;
  const int64_t group = (int64_t)blockIdx.x * groups + threadIdx.x / lanes;
  const int64_t stride = (int64_t)gridDim.x * groups * pass_bags;
  const unsigned seg = lanes == 32 ? kFull : ((1u << lanes) - 1u) << (in_warp * lanes);
  const int nvec = dim / VEC;
  const int64_t total = num_bags * nnz;

  auto meta = [&](int64_t first, int s, int32_t& id, float& wt) {
    id = kEmptyKey;
    wt = 0.f;
    const int64_t i = first * nnz + s;
    if (s < pass_bags * nnz && i < total) {
      id = __ldg(ids + i);
      wt = __ldg(w + i);
    }
  };
  // Probe slot s of the pass at `first`, writing its miss byte.
  auto probe_slot = [&](int64_t first, int s, int32_t id) {
    const int32_t found = probe(keys, id, mask, shift, max_probes, wide);
    const int64_t i = first * nnz + s;
    if (s < pass_bags * nnz && i < total) miss[i] = found < 0 ? 1 : 0;
    return found;
  };
  auto store = [&](int64_t bag, int c, const float (&acc)[VEC]) {
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
  };

  int32_t my_id;
  float my_w;
  meta(group * pass_bags, lane, my_id, my_w);
  for (int64_t wb = (group - in_warp) * pass_bags; wb < num_bags; wb += stride) {
    const int64_t first = wb + (int64_t)in_warp * pass_bags;
    int32_t next_id;
    float next_w;
    meta(first + stride, lane, next_id, next_w);  // in flight under this pass's loads
    if constexpr (NNZ > 0) {
      const int32_t my_slot = probe_slot(first, lane, my_id);
      const unsigned hits = (__ballot_sync(kFull, my_slot >= 0) & seg) >> (in_warp * lanes);
      for (int c0 = 0; c0 < nvec; c0 += lanes) {
        const int c = c0 + lane;
        const T* base = values + (int64_t)c * VEC;
        float acc[kMaxBags<VEC>][VEC];
#pragma unroll
        for (int b = 0; b < kMaxBags<VEC>; ++b)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[b][k] = 0.f;
        unsigned todo = hits;  // the same in every lane of the group
        while (todo) {
          int src[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            src[u] = todo ? __ffs(todo) - 1 : -1;
            todo &= todo - 1u;
          }
          typename V::Raw raw[kBatch];
          float wj[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int32_t sl = __shfl_sync(seg, my_slot, src[u] < 0 ? 0 : src[u], lanes);
            wj[u] = __shfl_sync(seg, my_w, src[u] < 0 ? 0 : src[u], lanes);
            raw[u] = typename V::Raw{};
            if (src[u] >= 0 && c < nvec) raw[u] = V::load(base + (int64_t)sl * dim);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (src[u] < 0 || c >= nvec) continue;
#pragma unroll
            for (int b = 0; b < kMaxBags<VEC>; ++b)
              if (b == src[u] / NNZ) V::fma(raw[u], wj[u], acc[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kMaxBags<VEC>; ++b)
          if (c < nvec && b < pass_bags && first + b < num_bags) store(first + b, c, acc[b]);
      }
    } else {
      const bool valid = first < num_bags;
      for (int c0 = 0; c0 < nvec; c0 += lanes) {
        const int c = c0 + lane;
        const bool col = valid && c < nvec;
        const T* base = values + (int64_t)c * VEC;
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
        for (int s0 = 0; s0 < nnz; s0 += lanes) {
          int32_t sid = my_id;
          float sw = my_w;
          if (s0 > 0) meta(first, s0 + lane, sid, sw);
          // The first column chunk writes the miss bytes; later ones probe again.
          const int32_t my_slot = c0 == 0 ? probe_slot(first, s0 + lane, sid)
                                          : probe(keys, sid, mask, shift, max_probes, wide);
          const int n = nnz - s0 < lanes ? nnz - s0 : lanes;
          for (int j0 = 0; j0 < n; j0 += kBatch) {
            typename V::Raw raw[kBatch];
            float wj[kBatch];
            bool hit[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int j = j0 + u;
              const int32_t sl = __shfl_sync(kFull, my_slot, j & (lanes - 1), lanes);
              wj[u] = __shfl_sync(kFull, sw, j & (lanes - 1), lanes);
              hit[u] = col && j < n && sl >= 0;
              raw[u] = typename V::Raw{};
              if (hit[u]) raw[u] = V::load(base + (int64_t)sl * dim);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (hit[u]) V::fma(raw[u], wj[u], acc);
          }
        }
        if (col) store(first, c, acc);
      }
    }
    my_id = next_id;
    my_w = next_w;
  }
}

template <typename T, int VEC, int NNZ>
struct Launch {
  static int run(const void* keys, const void* values, const void* ids, const void* w,
                 void* out, void* miss, long long num_bags, int nnz, int dim,
                 long long num_slots, int shift, int max_probes, int lanes, int pass_bags,
                 bool wide, long long blocks, void* stream) {
    probe_gather_pool_kernel<T, VEC, NNZ><<<(unsigned)blocks, kThreads, 0,
                                            (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const T*)values, (const int32_t*)ids, (const float*)w,
        (float*)out, (uint8_t*)miss, num_bags, nnz, dim, (uint32_t)(num_slots - 1),
        shift, max_probes, lanes, pass_bags, wide);
    return (int)cudaGetLastError();
  }
};

template <typename T, int VEC, int NNZ>
struct Occupancy {
  static int run() {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, probe_gather_pool_kernel<T, VEC, NNZ>, kThreads, 0);
    return err ? -(int)err : blocks;
  }
};

// F<instantiation of (vec, nnz_spec)>::run(args...), or cudaErrorInvalidValue
// where there is none (VEC 1 has only the general loop).
template <typename T, int WIDE, template <typename, int, int> class F, typename... Args>
int dispatch(int vec, int nnz_spec, Args... args) {
#define K3_CASE(V, N) \
  if (vec == V && nnz_spec == N) return F<T, V, N>::run(args...);
  K3_CASE(WIDE, 1)
  K3_CASE(WIDE, 2)
  K3_CASE(WIDE, 4)
  K3_CASE(WIDE, 8)
  K3_CASE(WIDE, 0)
  K3_CASE(1, 0)
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}

// The host's plan is checked here, not trusted: a wrong one is refused.
bool plan_ok(const void* keys, const void* values, const void* out, long long num_bags,
             int nnz, int dim, long long num_slots, int max_probes, int vec, int lanes,
             int nnz_spec, int pass_bags, long long blocks) {
  const bool aligned = (((uintptr_t)values | (uintptr_t)out) & 15u) == 0;
  const int max_bags = vec == 4 ? kMaxBags<4> : (vec == 8 ? kMaxBags<8> : 1);
  return num_bags > 0 && nnz > 0 && dim > 0 && max_probes > 0 && blocks > 0 &&
         blocks < (1ll << 31) && num_slots > 0 && num_slots <= (1ll << 31) &&
         (num_slots & (num_slots - 1)) == 0 && lanes > 0 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0 && dim % vec == 0 && (vec == 1 || aligned) &&
         pass_bags >= 1 &&
         (nnz_spec == 0 ? pass_bags == 1
                        : nnz_spec == nnz && pass_bags <= max_bags && pass_bags * nnz <= lanes) &&
         keys != nullptr;
}

template <typename T, int WIDE>
int run(const void* keys, const void* values, const void* ids, const void* w, void* out,
        void* miss, long long num_bags, int nnz, int dim, long long num_slots, int shift,
        int max_probes, int vec, int lanes, int nnz_spec, int pass_bags, long long blocks,
        void* stream) {
  if (!plan_ok(keys, values, out, num_bags, nnz, dim, num_slots, max_probes, vec, lanes,
               nnz_spec, pass_bags, blocks))
    return (int)cudaErrorInvalidValue;
  const bool wide = num_slots >= 4 && ((uintptr_t)keys & 15u) == 0;
  return dispatch<T, WIDE, Launch>(vec, nnz_spec, keys, values, ids, w, out, miss,
                                   num_bags, nnz, dim, num_slots, shift, max_probes,
                                   lanes, pass_bags, wide, blocks, stream);
}

}  // namespace

extern "C" {

// keys [num_slots] int32 (a power of two), values [num_slots, dim],
// ids [num_bags * nnz] int32, w [num_bags * nnz] f32, out [num_bags, dim]
// f32, miss [num_bags * nnz] bytes (0/1).  shift as in the header note;
// vec, lanes, nnz_spec, pass_bags and blocks are the host's launch plan
// (kernels/embedding_bag.py::launch_plan).  Returns cudaGetLastError()
// after the launch.
int probe_gather_pool_f32(const void* keys, const void* values, const void* ids,
                          const void* w, void* out, void* miss, long long num_bags,
                          int nnz, int dim, long long num_slots, int shift,
                          int max_probes, int vec, int lanes, int nnz_spec,
                          int pass_bags, long long blocks, void* stream) {
  return run<float, 4>(keys, values, ids, w, out, miss, num_bags, nnz, dim, num_slots,
                       shift, max_probes, vec, lanes, nnz_spec, pass_bags, blocks, stream);
}

int probe_gather_pool_bf16(const void* keys, const void* values, const void* ids,
                           const void* w, void* out, void* miss, long long num_bags,
                           int nnz, int dim, long long num_slots, int shift,
                           int max_probes, int vec, int lanes, int nnz_spec,
                           int pass_bags, long long blocks, void* stream) {
  return run<__nv_bfloat16, 8>(keys, values, ids, w, out, miss, num_bags, nnz, dim,
                               num_slots, shift, max_probes, vec, lanes, nnz_spec,
                               pass_bags, blocks, stream);
}

// Resident blocks per SM of the kernel of (vec, nnz_spec), or minus a CUDA
// error code.
int probe_gather_pool_occupancy_f32(int vec, int nnz_spec) {
  return dispatch<float, 4, Occupancy>(vec, nnz_spec);
}

int probe_gather_pool_occupancy_bf16(int vec, int nnz_spec) {
  return dispatch<__nv_bfloat16, 8, Occupancy>(vec, nnz_spec);
}

const char* probe_gather_pool_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
