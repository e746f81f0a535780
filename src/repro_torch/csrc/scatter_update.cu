// Kernel K4: hot-cache swap-in, an in-place row scatter where the last write
// to a slot wins, for Hopper, sm_90a.
//
// Replaces: src/repro/hotcache/kernels.py::scatter_update, the Pallas TPU
// kernel (pallas_call at :141) that streams rows[i] into values[slots[i]],
// one row DMA per grid step, with the value table aliased to the output.
// Its grid runs in order on one core, so a repeated slot ends up holding the
// last of its rows.
//
//   values[slots[i], :] = cast(rows[i, :])   for the last i of each slot
//
// Blocks run in no order here, so the order is restored explicitly in two
// passes over the K writes: a winner pass takes atomicMax(winner[slot], i)
// into a [C] int32 scratch the wrapper fills with -1, and a copy pass writes
// row i only where winner[slots[i]] == i.  Only one write per slot survives,
// so the copies never race and the result equals the sequential scatter.
// Slots outside [0, C) are skipped.  The cast f32 -> bf16 rounds to nearest
// even (__float2bfloat16_rn), as torch's and numpy's casts do.
//
// What bounds it on the card: bytes.  Each surviving row is read once and
// written once (2 x D elements), plus the K slots; no arithmetic.
//
// What the design does about it: one warp copies one row, lanes on
// consecutive elements, so each row moves as coalesced 128-byte runs; the
// winner pass touches only the slots and the scratch (4 bytes a write).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename To, typename From>
__device__ __forceinline__ To cast(From v);
template <>
__device__ __forceinline__ float cast<float, float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float cast<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 v) {
  return v;
}

__global__ void winner_kernel(const int32_t* __restrict__ slots, int64_t k,
                              int64_t num_slots, int32_t* __restrict__ winner) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int32_t s = __ldg(slots + i);
  if (s < 0 || s >= num_slots) return;
  atomicMax(winner + s, (int32_t)i);
}

template <typename Tv, typename Tr>
__global__ void copy_kernel(Tv* __restrict__ values,
                            const int32_t* __restrict__ slots,
                            const Tr* __restrict__ rows,
                            const int32_t* __restrict__ winner, int64_t k,
                            int64_t num_slots, int dim) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= k) return;
  const int32_t s = __ldg(slots + i);
  if (s < 0 || s >= num_slots || __ldg(winner + s) != (int32_t)i) return;
  Tv* dst = values + (int64_t)s * dim;
  const Tr* src = rows + i * dim;
  for (int d = lane; d < dim; d += 32) dst[d] = cast<Tv, Tr>(src[d]);
}

template <typename Tv, typename Tr>
int launch(void* values, const void* slots, const void* rows, void* winner,
           long long k, long long num_slots, int dim, void* stream) {
  if (k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  winner_kernel<<<(unsigned)((k + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const int32_t*)slots, k, num_slots, (int32_t*)winner);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long warps_per_block = kThreads / 32;
  copy_kernel<Tv, Tr><<<(unsigned)((k + warps_per_block - 1) / warps_per_block),
                        kThreads, 0, st>>>(
      (Tv*)values, (const int32_t*)slots, (const Tr*)rows,
      (const int32_t*)winner, k, num_slots, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// values [num_slots, dim] (updated in place), slots [k] int32, rows [k, dim],
// winner [num_slots] int32 scratch filled with -1 by the caller.  The suffix
// names the value type, then the row type.  Returns cudaGetLastError().
int scatter_update_f32_f32(void* values, const void* slots, const void* rows,
                           void* winner, long long k, long long num_slots,
                           int dim, void* stream) {
  return launch<float, float>(values, slots, rows, winner, k, num_slots, dim, stream);
}

int scatter_update_bf16_f32(void* values, const void* slots, const void* rows,
                            void* winner, long long k, long long num_slots,
                            int dim, void* stream) {
  return launch<__nv_bfloat16, float>(values, slots, rows, winner, k, num_slots,
                                      dim, stream);
}

int scatter_update_f32_bf16(void* values, const void* slots, const void* rows,
                            void* winner, long long k, long long num_slots,
                            int dim, void* stream) {
  return launch<float, __nv_bfloat16>(values, slots, rows, winner, k, num_slots,
                                      dim, stream);
}

int scatter_update_bf16_bf16(void* values, const void* slots, const void* rows,
                             void* winner, long long k, long long num_slots,
                             int dim, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(values, slots, rows, winner, k,
                                              num_slots, dim, stream);
}

const char* scatter_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
