// One lane's 16-byte (or one-element) part of an embedding row, shared by
// the gather kernels K1 (embedding_bag.cu) and K3 (probe_gather_pool.cu):
// the raw bytes, loaded once through the read-only path, and the FMA of
// them into f32 accumulators (bf16 widened exactly).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fma(const Raw& r, float w, float (&acc)[4]) {
    acc[0] = fmaf(r.x, w, acc[0]);
    acc[1] = fmaf(r.y, w, acc[1]);
    acc[2] = fmaf(r.z, w, acc[2]);
    acc[3] = fmaf(r.w, w, acc[3]);
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void fma(const Raw& r, float w, float (&acc)[1]) {
    acc[0] = fmaf(r, w, acc[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void fma(const Raw& r, float w, float (&acc)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] = fmaf(f.x, w, acc[2 * k]);
      acc[2 * k + 1] = fmaf(f.y, w, acc[2 * k + 1]);
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return p[0]; }
  static __device__ __forceinline__ void fma(const Raw& r, float w, float (&acc)[1]) {
    acc[0] = fmaf(__bfloat162float(r), w, acc[0]);
  }
};
