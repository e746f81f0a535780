// Kernel K1: fused embedding bag (gather + weighted pool) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::embedding_bag, the Pallas TPU
// kernel (pallas_call at :59) that streams one table row per grid step into
// VMEM by scalar prefetch and accumulates the bag there.
//
//   out[b, :] = sum_j w[b*nnz + j] * float(table[idx[b*nnz + j], :])
//
// What bounds it on the card: bytes.  Each slot reads one D-wide row of a
// table far larger than L2 (dlrm-flexemr: 150M x 64 f32, 38 GB) and does two
// flops per element, so the kernel is a random gather at HBM rate.
//
// What the design does about it: a group of D/VEC threads owns one bag and
// spans its rows with 16-byte vector loads (float4 for f32, 8 x bf16 for
// bf16); at D = 64 f32 a row is one coalesced 256-byte run read by 16
// threads.  blockDim.y bags share a block of about 256 threads, so each SM
// keeps many independent row reads in flight.  The nnz slots run in order in
// registers with f32 accumulation (every row is multiplied by its weight, as
// the TPU kernel does; w = 0 masks a slot) and the pooled bag is stored once,
// so the only traffic is the rows, the ids and weights, and the output.
// Ids are clamped into [0, V): a bad id can never read outside the table.
// Callers clamp masked ids themselves, as the reference lookup does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out,
                                     int64_t num_bags, int nnz, int dim,
                                     int64_t num_rows) {
  const int64_t bag = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (bag >= num_bags) return;
  const int nvec = dim / VEC;
  const int32_t* bag_idx = idx + bag * nnz;
  const float* bag_w = w + bag * nnz;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int j = 0; j < nnz; ++j) {
      int64_t row = __ldg(bag_idx + j);
      row = row < 0 ? 0 : (row >= num_rows ? num_rows - 1 : row);
      const float wj = __ldg(bag_w + j);
      float v[VEC];
      RowLoad<T, VEC>::load(table + row * dim + (int64_t)c * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(v[k], wj, acc[k]);
    }
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
int launch(const void* table, const void* idx, const void* w, void* out,
           long long num_bags, int nnz, int dim, long long num_rows,
           void* stream) {
  if (num_bags <= 0) return 0;
  const int nvec = dim / VEC;
  const int tx = nvec < 256 ? nvec : 256;  // threads along one row
  const int ty = 256 / tx > 0 ? 256 / tx : 1;  // bags per block
  const long long blocks = (num_bags + ty - 1) / ty;
  embedding_bag_kernel<T, VEC><<<(unsigned)blocks, dim3(tx, ty), 0,
                                 (cudaStream_t)stream>>>(
      (const T*)table, (const int32_t*)idx, (const float*)w, (float*)out,
      num_bags, nnz, dim, num_rows);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// table [num_rows, dim], idx [num_bags * nnz] int32, w [num_bags * nnz] f32,
// out [num_bags, dim] f32.  Returns cudaGetLastError() after the launch.
int embedding_bag_f32(const void* table, const void* idx, const void* w,
                      void* out, long long num_bags, int nnz, int dim,
                      long long num_rows, void* stream) {
  if (dim % 4 == 0 && aligned16(table) && aligned16(out))
    return launch<float, 4>(table, idx, w, out, num_bags, nnz, dim, num_rows, stream);
  return launch<float, 1>(table, idx, w, out, num_bags, nnz, dim, num_rows, stream);
}

int embedding_bag_bf16(const void* table, const void* idx, const void* w,
                       void* out, long long num_bags, int nnz, int dim,
                       long long num_rows, void* stream) {
  if (dim % 8 == 0 && aligned16(table) && aligned16(out))
    return launch<__nv_bfloat16, 8>(table, idx, w, out, num_bags, nnz, dim, num_rows, stream);
  return launch<__nv_bfloat16, 1>(table, idx, w, out, num_bags, nnz, dim, num_rows, stream);
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
