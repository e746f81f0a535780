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
// passes over the K writes: a winner pass takes a 32-bit atomicMax of
// base + i into winner[slot], and a copy pass writes row i only where
// winner[slots[i]] == base + i.  Only one write per slot survives, so the
// copies never race and the result equals the sequential scatter.  The [C]
// scratch is never cleared: the wrapper keeps one per (device, stream, C)
// and moves base past the words of every earlier call on it (base rises by
// K a call, from 1 over a scratch of zeros), so a word left by an earlier
// call is below base and loses to any write of this one; the wrapper zeroes
// the scratch and starts again at 1 where base + K - 1 would pass 2^32 - 1.
// Slots outside [0, C) are skipped.  The cast f32 -> bf16 rounds to nearest even
// (__float2bfloat16_rn), as torch's and numpy's casts do.
//
// What bounds it on the card: bytes.  Each surviving row is read once and
// written once (2 x D elements), plus the K slots; no arithmetic.
//
// What the design does about it:
//  * No fill launch: the moving base replaces clearing the scratch.
//  * The copy pass works on (row, 16-byte chunk) items laid end to end over
//    the threads, so a row of 64 f32 takes 16 lanes and no lane idles; each
//    thread carries 2 items (4 and 8 ran slower).  It issues their slot and
//    row loads together, then their winner loads, then the stores: two
//    dependent round trips to device memory per thread, with the row bytes
//    already in flight during the first (a row is read before its winner
//    check is known; a losing row costs bytes only where slots repeat).
//  * Rows whose width is not a whole number of chunks, or tables not on
//    16-byte boundaries, take the same pass one element an item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;  // (row, chunk) items a thread of the copy pass carries

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

// N elements from p: 16-byte loads where N elements fill whole 16-byte words
// (each row is read once: streamed past L1 and evicted first from L2).
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, T (&x)[N]) {
  if constexpr (sizeof(T) * N % 16 == 0) {
#pragma unroll
    for (int w = 0; w < (int)(sizeof(T) * N / 16); ++w) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + w);
      memcpy(&x[w * 16 / sizeof(T)], &v, 16);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = p[e];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const T (&x)[N]) {
  if constexpr (sizeof(T) * N % 16 == 0) {
#pragma unroll
    for (int w = 0; w < (int)(sizeof(T) * N / 16); ++w) {
      uint4 v;
      memcpy(&v, &x[w * 16 / sizeof(T)], 16);
      reinterpret_cast<uint4*>(p)[w] = v;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = x[e];
  }
}

__global__ void winner_kernel(const int32_t* __restrict__ slots, int64_t k,
                              int64_t num_slots, unsigned int* __restrict__ winner,
                              unsigned int base) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int32_t s = __ldg(slots + i);
  if (s < 0 || s >= num_slots) return;
  atomicMax(winner + s, base + (unsigned int)i);
}

// VEC elements an item: a row is `chunks` items of VEC elements.
template <typename Tv, typename Tr, int VEC>
__global__ void __launch_bounds__(kThreads)
    copy_kernel(Tv* __restrict__ values, const int32_t* __restrict__ slots,
                const Tr* __restrict__ rows, const unsigned int* __restrict__ winner,
                int64_t k, int64_t num_slots, int chunks, unsigned int base) {
  const int64_t n_items = k * chunks;
  const int64_t dim = (int64_t)chunks * VEC;
  const int64_t first = (int64_t)blockIdx.x * (kThreads * kItems) + threadIdx.x;
  int64_t row[kItems];
  int32_t slot[kItems];
  int chunk[kItems];
  bool live[kItems];
  Tr data[kItems][VEC];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int64_t item = first + (int64_t)u * kThreads;
    live[u] = item < n_items;
    row[u] = !live[u] ? 0 : n_items >> 32 ? item / chunks : (uint32_t)item / (uint32_t)chunks;
    chunk[u] = (int)(item - row[u] * chunks);
    slot[u] = -1;
    if (live[u]) {
      slot[u] = __ldg(slots + row[u]);
      load(rows + row[u] * dim + (int64_t)chunk[u] * VEC, data[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    live[u] = live[u] && slot[u] >= 0 && slot[u] < num_slots &&
              __ldg(winner + slot[u]) == base + (unsigned int)row[u];
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (!live[u]) continue;
    Tv x[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = cast<Tv, Tr>(data[u][e]);
    store(values + (int64_t)slot[u] * dim + (int64_t)chunk[u] * VEC, x);
  }
}

template <typename Tv, typename Tr, int VEC>
int copy(void* values, const void* slots, const void* rows, const void* winner,
         long long k, long long num_slots, int chunks, unsigned int base, cudaStream_t st) {
  const long long per_block = (long long)kThreads * kItems;
  const long long blocks = (k * chunks + per_block - 1) / per_block;
  copy_kernel<Tv, Tr, VEC><<<(unsigned)blocks, kThreads, 0, st>>>(
      (Tv*)values, (const int32_t*)slots, (const Tr*)rows,
      (const unsigned int*)winner, k, num_slots, chunks, base);
  return (int)cudaGetLastError();
}

template <typename Tv, typename Tr>
int launch(void* values, const void* slots, const void* rows, void* winner,
           long long k, long long num_slots, int dim, unsigned int base, void* stream) {
  if (k <= 0) return 0;
  if (base == 0 || base - 1 + (unsigned long long)k > 0xffffffffull)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  winner_kernel<<<(unsigned)((k + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const int32_t*)slots, k, num_slots, (unsigned int*)winner, base);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  // 16 bytes of the narrower type an item, where rows and table allow it.
  constexpr int VEC = 16 / (int)(sizeof(Tv) < sizeof(Tr) ? sizeof(Tv) : sizeof(Tr));
  if (dim % VEC == 0 && (uintptr_t)values % 16 == 0 && (uintptr_t)rows % 16 == 0)
    return copy<Tv, Tr, VEC>(values, slots, rows, winner, k, num_slots, dim / VEC, base, st);
  return copy<Tv, Tr, 1>(values, slots, rows, winner, k, num_slots, dim, base, st);
}

}  // namespace

extern "C" {

// values [num_slots, dim] (updated in place), slots [k] int32, rows [k, dim],
// winner [num_slots] 32-bit scratch whose words all lie below `base` (zeros
// at first), 1 <= base and base + k - 1 < 2^32.  The suffix names the value
// type, then the row type.  Returns cudaGetLastError().
int scatter_update_f32_f32(void* values, const void* slots, const void* rows,
                           void* winner, long long k, long long num_slots,
                           int dim, unsigned int base, void* stream) {
  return launch<float, float>(values, slots, rows, winner, k, num_slots, dim, base, stream);
}

int scatter_update_bf16_f32(void* values, const void* slots, const void* rows,
                            void* winner, long long k, long long num_slots,
                            int dim, unsigned int base, void* stream) {
  return launch<__nv_bfloat16, float>(values, slots, rows, winner, k, num_slots, dim, base,
                                      stream);
}

int scatter_update_f32_bf16(void* values, const void* slots, const void* rows,
                            void* winner, long long k, long long num_slots,
                            int dim, unsigned int base, void* stream) {
  return launch<float, __nv_bfloat16>(values, slots, rows, winner, k, num_slots, dim, base,
                                      stream);
}

int scatter_update_bf16_bf16(void* values, const void* slots, const void* rows,
                             void* winner, long long k, long long num_slots,
                             int dim, unsigned int base, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(values, slots, rows, winner, k, num_slots,
                                              dim, base, stream);
}

const char* scatter_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
