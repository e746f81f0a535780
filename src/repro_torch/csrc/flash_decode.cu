// Kernel K7: flash decoding, one query token per head against a KV cache,
// for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode, the Pallas TPU
// kernel (pallas_call at :100) that streams the cache HBM -> VMEM in block_k
// rows per grid step, carries (m, l, acc) in VMEM scratch along the
// sequential grid axis, and takes the valid length by scalar prefetch.
//
//   s[j, p] = (q[j] . k[p]) / sqrt(dh) in f32 for p < cache_len, else
//   masked; p rounded to v's dtype before p . v; out = acc / max(l, 1e-30)
//   in q's dtype.  The g = H / Hkv query heads of one KV head share its rows.
//
// What bounds it on the card: bytes.  Each K and V row up to cache_len is
// read once and used for g dot products: at g = 1 that is about one FLOP per
// byte, two orders of magnitude under the ridge.  At the decode path's shape
// (B = 4, 32 heads, dh = 80, 4,097 positions) the rows are 168 MB: 50 us at
// 3.35 TB/s.
//
// What the design does about it:
//  * Rows are read with 16-byte loads: a segment of W lanes (W the power of
//    two at or above dh * size / 16) reads one row, lane c its c-th 16 bytes;
//    the segment's partial dots meet in a butterfly of shuffles.  A block of
//    8 warps serves one (KV head, batch) and up to G of its query heads
//    (grid z splits larger groups); its segments stride over positions, each
//    with its own (m, l, acc) in registers, and each segment starts the K and
//    V loads of 8 positions (2 for a group of 8 heads) before it uses any,
//    so many rows are in flight.
//    The segments' states meet at the end: a shuffle butterfly inside each
//    warp, then shared memory across warps.
//  * cache_len is read on the card from an int32 tensor: one build serves
//    any fill level, and the decode loop never waits on the host.
//  * Nothing at or past cache_len is read: those rows may hold anything,
//    NaN included, and NaN * 0 is NaN.  A segment with no valid row yet keeps
//    m = -inf and leaves l and acc at 0.
//  * Any S and cache_len = 1 work (the Pallas kernel asserts S % bk == 0);
//    offsets are 64-bit, since a whole [L, B, S, Hkv, dh] cache passes 2^31
//    elements and the per-layer slice starts far into it.
//  * Later work: a split over S with a second combine pass, so that B * Hkv
//    blocks below the card's 132 SMs still fill it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void to_f32(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_f32(const uint4& raw, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}

__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// One block per (KV head, batch, chunk of G query heads).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ len_ptr,
                        T* __restrict__ out, long long S, int H, int Hkv,
                        int group, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int C = D / VEC;  // chunks per row
  constexpr int W = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : C <= 8 ? 8 : C <= 16 ? 16 : 32;
  constexpr int R = 32 / W;  // segments (rows in flight) per warp
  constexpr int NSEG = kWarps * R;
  // Positions a segment loads before it computes: more rows in flight where
  // one query head leaves registers free.
  constexpr int kUnroll = G == 1 ? 8 : 2;
  static_assert(C <= 32, "a row must fit one warp");
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const int j0 = blockIdx.z * G;
  const int gc = min(G, group - j0);  // query heads in this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg_in_warp = lane / W;
  const int c = lane % W;  // this lane's 16-byte chunk of a row
  const bool active = c < C;

  long long len = *len_ptr;
  len = len < 0 ? 0 : (len > S ? S : len);

  float qv[G][VEC];
  const long long h0 = (long long)hk * group + j0;  // first query head
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float tmp[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    if (j < gc && active) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + (b * H + h0 + j) * D + c * VEC);
      to_f32(raw, tmp);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[j][e] = tmp[e];
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  }

  const long long row_stride = (long long)Hkv * D;  // elements between positions
  const T* kb = kc + (b * S * Hkv + hk) * D + c * VEC;
  const T* vb = vc + (b * S * Hkv + hk) * D + c * VEC;
  const long long seg = warp * R + seg_in_warp;
  // The loop bound is the warp's first position, the same for all its
  // lanes, so every shuffle below has the whole warp.
  for (long long base = (long long)warp * R; base < len; base += (long long)NSEG * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + (seg - warp * R) + (long long)u * NSEG;
      valid[u] = p < len;
      kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (valid[u] && active) {
        kraw[u] = *reinterpret_cast<const uint4*>(kb + p * row_stride);
        vraw[u] = *reinterpret_cast<const uint4*>(vb + p * row_stride);
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[VEC];
      to_f32(kraw[u], kx);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[j][e], kx[e], d);
#pragma unroll
        for (int off = W / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][j] = valid[u] ? d * scale : -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mn = m[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mn = fmaxf(mn, s[u][j]);
      if (mn == -INFINITY) continue;  // no valid row seen by this segment yet
      const float alpha = __expf(m[j] - mn);  // 0 when m[j] is -inf
      m[j] = mn;
      l[j] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = valid[u] ? __expf(s[u][j] - mn) : 0.f;
        l[j] += p;  // l from the unrounded p, as the Pallas kernel
        const float pr = round_to(p, q);
        float vx[VEC];
        to_f32(vraw[u], vx);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(pr, vx[e], acc[j][e]);
      }
    }
  }

  // Combine the R segments of this warp (lanes W, 2W, ... apart).
#pragma unroll
  for (int off = W; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mn = fmaxf(m[j], mo);
      const float fa = mn == -INFINITY ? 0.f : __expf(m[j] - mn);
      const float fb = mn == -INFINITY ? 0.f : __expf(mo - mn);
      l[j] = l[j] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * fa + ao * fb;
      }
      m[j] = mn;
    }
  }
  if (lane < W) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (lane == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = l[j];
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm_acc[warp][j][c * VEC + e] = acc[j][e];
      }
    }
  }
  __syncthreads();

  // Combine the warps: one thread per (query head, head dim).
  for (int t = threadIdx.x; t < gc * D; t += kThreads) {
    const int j = t / D;
    const int d = t - j * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = __expf(sm_m[w][j] - mx);  // 0 for a warp with no row
        lsum = fmaf(sm_l[w][j], f, lsum);
        o = fmaf(sm_acc[w][j][d], f, o);
      }
    }
    store(out + (b * H + h0 + j) * D + d, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* kc, const void* vc, const int* len,
           void* out, long long B, long long S, int H, int Hkv, void* stream) {
  const int group = H / Hkv;
  const dim3 grid((unsigned)Hkv, (unsigned)B, (unsigned)((group + G - 1) / G));
  const float scale = 1.f / sqrtf((float)D);
  flash_decode_kernel<T, D, G><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, len, (T*)out, S, H, Hkv, group, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(const void* q, const void* kc, const void* vc, const int* len,
             void* out, long long B, long long S, int H, int Hkv, void* stream) {
  if (H / Hkv == 1) return launch<T, D, 1>(q, kc, vc, len, out, B, S, H, Hkv, stream);
  return launch<T, D, 8>(q, kc, vc, len, out, B, S, H, Hkv, stream);
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* len,
             void* out, long long B, long long S, int H, int Hkv, int D,
             void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || S <= 0) return (int)cudaErrorInvalidValue;
  const int* n = (const int*)len;
  switch (D) {
    case 64: return by_group<T, 64>(q, kc, vc, n, out, B, S, H, Hkv, stream);
    case 80: return by_group<T, 80>(q, kc, vc, n, out, B, S, H, Hkv, stream);
    case 96: return by_group<T, 96>(q, kc, vc, n, out, B, S, H, Hkv, stream);
    case 128: return by_group<T, 128>(q, kc, vc, n, out, B, S, H, Hkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, D], k_cache and v_cache [B, S, Hkv, D], out [B, H, D], all
// contiguous and of one dtype; cache_len a device int32 scalar.
// D in {64, 80, 96, 128}.  Returns cudaGetLastError().
int flash_decode_bf16(const void* q, const void* kc, const void* vc,
                      const void* cache_len, void* out, long long B, long long S,
                      int H, int Hkv, int D, void* stream) {
  return dispatch<__nv_bfloat16>(q, kc, vc, cache_len, out, B, S, H, Hkv, D, stream);
}

int flash_decode_f32(const void* q, const void* kc, const void* vc,
                     const void* cache_len, void* out, long long B, long long S,
                     int H, int Hkv, int D, void* stream) {
  return dispatch<float>(q, kc, vc, cache_len, out, B, S, H, Hkv, D, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
