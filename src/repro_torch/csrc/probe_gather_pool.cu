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
// L2), two flops per element: a random gather at memory rate.
//
// What the design does about it: K1's layout.  A group of D/VEC threads owns
// one bag and spans each hit row with 16-byte vector loads (float4 for f32,
// 8 x bf16 for bf16); blockDim.y bags share a block of about 256 threads so
// each SM keeps many independent row reads in flight.  Every thread of the
// group walks the probe window itself (the key loads coalesce into one
// broadcast per group), so no shared memory or synchronisation is needed.
// The bag sum stays in f32 registers and is stored once; thread 0 of the
// group writes the miss byte of each slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmptyKey = 0x7fffffff;

template <typename T, int VEC>
struct RowLoad;

template <>
struct RowLoad<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct RowLoad<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct RowLoad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

// Slot holding `id`, or -1 when it is absent (EMPTY_KEY is always absent).
__device__ __forceinline__ int64_t probe(const int32_t* __restrict__ keys,
                                         int32_t id, uint32_t mask, int shift,
                                         int max_probes) {
  if (id == kEmptyKey) return -1;
  const uint32_t h = (uint32_t)id * 2654435761u;
  const uint32_t home = shift >= 32 ? 0u : ((h >> shift) & mask);
  for (int p = 0; p < max_probes; ++p) {
    const uint32_t s = (home + (uint32_t)p) & mask;
    if (__ldg(keys + s) == id) return (int64_t)s;
  }
  return -1;
}

template <typename T, int VEC>
__global__ void probe_gather_pool_kernel(const int32_t* __restrict__ keys,
                                         const T* __restrict__ values,
                                         const int32_t* __restrict__ ids,
                                         const float* __restrict__ w,
                                         float* __restrict__ out,
                                         uint8_t* __restrict__ miss,
                                         int64_t num_bags, int nnz, int dim,
                                         uint32_t mask, int shift,
                                         int max_probes) {
  const int64_t bag = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (bag >= num_bags) return;
  const int nvec = dim / VEC;
  const int32_t* bag_ids = ids + bag * nnz;
  const float* bag_w = w + bag * nnz;
  for (int c0 = 0; c0 < nvec; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int j = 0; j < nnz; ++j) {
      const int64_t slot = probe(keys, __ldg(bag_ids + j), mask, shift, max_probes);
      if (c0 == 0 && threadIdx.x == 0) miss[bag * nnz + j] = slot < 0 ? 1 : 0;
      if (slot < 0 || c >= nvec) continue;
      const float wj = __ldg(bag_w + j);
      float v[VEC];
      RowLoad<T, VEC>::load(values + slot * dim + (int64_t)c * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(v[k], wj, acc[k]);
    }
    if (c >= nvec) continue;
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

template <typename T, int VEC>
int launch(const void* keys, const void* values, const void* ids,
           const void* w, void* out, void* miss, long long num_bags, int nnz,
           int dim, long long num_slots, int shift, int max_probes,
           void* stream) {
  if (num_bags <= 0) return 0;
  const int nvec = dim / VEC;
  const int tx = nvec < 256 ? nvec : 256;  // threads along one row
  const int ty = 256 / tx > 0 ? 256 / tx : 1;  // bags per block
  const long long blocks = (num_bags + ty - 1) / ty;
  probe_gather_pool_kernel<T, VEC><<<(unsigned)blocks, dim3(tx, ty), 0,
                                     (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const T*)values, (const int32_t*)ids,
      (const float*)w, (float*)out, (uint8_t*)miss, num_bags, nnz, dim,
      (uint32_t)(num_slots - 1), shift, max_probes);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// keys [num_slots] int32 (a power of two), values [num_slots, dim],
// ids [num_bags * nnz] int32, w [num_bags * nnz] f32, out [num_bags, dim]
// f32, miss [num_bags * nnz] bytes (0/1).  shift as in the header note.
// Returns cudaGetLastError() after the launch.
int probe_gather_pool_f32(const void* keys, const void* values, const void* ids,
                          const void* w, void* out, void* miss,
                          long long num_bags, int nnz, int dim,
                          long long num_slots, int shift, int max_probes,
                          void* stream) {
  if (dim % 4 == 0 && aligned16(values) && aligned16(out))
    return launch<float, 4>(keys, values, ids, w, out, miss, num_bags, nnz, dim,
                            num_slots, shift, max_probes, stream);
  return launch<float, 1>(keys, values, ids, w, out, miss, num_bags, nnz, dim,
                          num_slots, shift, max_probes, stream);
}

int probe_gather_pool_bf16(const void* keys, const void* values, const void* ids,
                           const void* w, void* out, void* miss,
                           long long num_bags, int nnz, int dim,
                           long long num_slots, int shift, int max_probes,
                           void* stream) {
  if (dim % 8 == 0 && aligned16(values) && aligned16(out))
    return launch<__nv_bfloat16, 8>(keys, values, ids, w, out, miss, num_bags,
                                    nnz, dim, num_slots, shift, max_probes, stream);
  return launch<__nv_bfloat16, 1>(keys, values, ids, w, out, miss, num_bags, nnz,
                                  dim, num_slots, shift, max_probes, stream);
}

const char* probe_gather_pool_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
