// Kernel K6: causal or full GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel (pallas_call at :99) whose grid (B, H, S/bq, S/bk) runs its KV
// axis in order on one core and carries the online-softmax state (m, l, acc)
// in VMEM scratch from one grid step to the next.
//
//   s = (q . k) / sqrt(dh) in f32, masked to -1e30 where a key lies in the
//   future (causal) or past the sequence; m, l, acc updated online;
//   p rounded to v's dtype before p . v; out = acc / max(l, 1e-30) in q's dtype.
//   Query head h reads KV head h / (H / Hkv): GQA by index, KV never repeated.
//
// What bounds it on the card: operations.  Every valid (q, k) pair costs
// 4 * dh FLOP (q . k and p . v) against 2 * dh bytes of K and V that a
// 64-row query tile shares, so at S = 4096, dh = 80 in bf16 the kernel does
// about 1,000 FLOP per byte of device memory, far above the card's ridge of
// about 295 (989 TFLOP/s bf16 over 3.35 TB/s): the tensor cores set the floor.
//
// What the design does about it:
//  * bf16: the two products run on the tensor cores with mma.sync m16n8k16
//    (bf16 in, f32 accumulate).  dh = 80 is five 16-deep steps of q . k and
//    ten 8-wide tiles of p . v, so nothing is padded to a power of two.  One
//    block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//    warp; Q stays in registers as A fragments for the whole block.  A loop
//    inside the block walks KV tiles of 64 rows (the TPU grid's sequential
//    axis), staged in shared memory with 16-byte loads, rows padded by 8
//    elements so the fragment reads and ldmatrix hit distinct banks.  The
//    f32 (m, l, acc) state stays in registers; the score tile's accumulator
//    layout is reused as the A fragment of p . v, and V's B fragments come
//    from ldmatrix.trans.  The causal loop stops at the diagonal (the Pallas
//    kernel's skip of future blocks) and masks only the tiles that need it.
//    Query tiles run last-first, so the longest causal rows start
//    first and the short ones fill the tail.
//  * f32: no TF32 (it keeps about three decimal digits, and the reference
//    holds f32 to 2e-5): scalar FMAs, 256 threads, each owning one query row
//    and every fourth key / head dim; the four threads of a row reduce its
//    max and sum with shuffles.
//  * Any S: the ragged last query and KV tiles are masked (the Pallas kernel
//    asserts S % bq == 0).  The [B, S, H, dh] layout is read and written
//    through strides (no transposes); offsets are 64-bit.
//  * Later work: wgmma, TMA and a producer warp that keeps the next KV tile
//    in flight while the current one is consumed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per KV tile

struct Strides {  // element strides of the [B, S, H, dh] tensors
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b, a 16x16 row-major, b 16x8 column-major, bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy rows [row0, row0 + 64) of one head into a [64][LD] tile in shared
// memory, 16 bytes a thread at a time; rows at or past S are zero.
template <int D, int LD, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row0,
                                          long long S, long long row_stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int e = threadIdx.x; e < kBK * CH; e += THREADS) {
    const int r = e / CH;
    const int c = e - r * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, long long S,
                                int group, int causal, float scale_log2,
                                Strides st) {
  constexpr int LD = D + 8;  // padded smem row (bf16 elements)
  constexpr int KSTEPS = D / 16;  // depth steps of q . k
  constexpr int NT = D / 8;  // 8-wide output tiles of p . v
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the warp's 16
  const int t4 = lane & 3;  // fragment column pair

  const __nv_bfloat16* qh = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kh = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vh = v + b * st.vb + hk * st.vh;

  load_tile<D, LD, 128>(Qs, qh, q0, S, st.qs);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p0 = Qs + r0 * LD + kk * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }

  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows r0, r0+8
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the running sums
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const long long row_a = q0 + r0;
  const long long row_b = row_a + 8;
  const long long kv_end = causal ? (q0 + kBQ < S ? q0 + kBQ : S) : S;
  for (long long kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile<D, LD, 128>(Ks, kh, kv0, S, st.ks);
    load_tile<D, LD, 128>(Vs, vh, kv0, S, st.vs);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    const bool masked = (kv0 + kBK > S) || (causal && kv0 + kBK - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const long long key = kv0 + n * 8 + t4 * 2 + (e & 1);
          const long long row = (e < 2) ? row_a : row_b;
          if (key >= S || (causal && key > row)) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;  // l from the unrounded p, as the Pallas kernel
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // p . v: the score accumulators of key tiles 2kk and 2kk+1 are, once
    // rounded to bf16, the A fragment of the 16-key step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mat = lane >> 3;
      const __nv_bfloat16* vp =
          Vs + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vp + np * 16);
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + t4 * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(oh + row_a * st.os + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(oh + row_b * st.os + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ------------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, long long S, int group,
                               int causal, float scale_log2, Strides st) {
  constexpr int LDQ = D + 1;  // Q and K rows padded: distinct banks per row
  constexpr int LDP = kBK + 1;
  constexpr int DV = D / 4;  // head dims per thread
  extern __shared__ uint4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [64][D + 1]
  float* Ks = Qs + kBQ * LDQ;  // [64][D + 1]
  float* Vs = Ks + kBK * LDQ;  // [64][D]
  float* Ps = Vs + kBK * D;  // [64][65]

  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / group;
  const int r = threadIdx.x >> 2;  // query row in the tile
  const int cl = threadIdx.x & 3;  // keys cl + 4i, head dims cl + 4i

  const float* qh = q + b * st.qb + h * st.qh;
  const float* kh = k + b * st.kb + hk * st.kh;
  const float* vh = v + b * st.vb + hk * st.vh;

  for (int e = threadIdx.x; e < kBQ * D; e += 256) {
    const int rr = e / D;
    const int d = e - rr * D;
    Qs[rr * LDQ + d] = (q0 + rr < S) ? qh[(q0 + rr) * st.qs + d] : 0.f;
  }
  float m = kNegInf, l = 0.f;
  float acc[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = 0.f;

  const long long row = q0 + r;
  const long long kv_end = causal ? (q0 + kBQ < S ? q0 + kBQ : S) : S;
  for (long long kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * D; e += 256) {
      const int rr = e / D;
      const int d = e - rr * D;
      const bool in = kv0 + rr < S;
      Ks[rr * LDQ + d] = in ? kh[(kv0 + rr) * st.ks + d] : 0.f;
      Vs[rr * D + d] = in ? vh[(kv0 + rr) * st.vs + d] : 0.f;
    }
    __syncthreads();

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    const float* qr = Qs + r * LDQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = fmaf(qv, Ks[(4 * i + cl) * LDQ + d], s[i]);
    }
    const bool masked = (kv0 + kBK > S) || (causal && kv0 + kBK - 1 > q0);
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const long long key = kv0 + 4 * i + cl;
        if (key >= S || (causal && key > row)) x = kNegInf;
      }
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
    float* pr = Ps + r * LDP;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = exp2f(s[i] - mn);
      rs += p;
      pr[4 * i + cl] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    __syncwarp();  // a warp reads back only the P rows it wrote
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * D + cl;
#pragma unroll
      for (int i = 0; i < DV; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }
  if (row < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + b * st.ob + h * st.oh + row * st.os;
#pragma unroll
    for (int i = 0; i < DV; ++i) orow[4 * i + cl] = acc[i] * inv;
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long S, int H, int Hkv, int causal, const Strides& st,
           void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int threads = kBf16 ? 128 : 256;
  constexpr size_t smem =
      kBf16 ? (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(__nv_bfloat16)
            : (size_t)((kBQ + kBK) * (D + 1) + kBK * D + kBQ * (kBK + 1)) * sizeof(float);
  void (*kernel)(const T*, const T*, const T*, T*, long long, int, int, float, Strides);
  if constexpr (kBf16) {
    kernel = flash_attention_bf16_kernel<D>;
  } else {
    kernel = flash_attention_f32_kernel<D>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H / Hkv, causal,
      scale_log2, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long B,
             long long S, int H, int Hkv, int D, int causal,
             const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  Strides st;
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 96: return launch<T, 96>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, H, D], k and v [B, S, Hkv, D], o [B, S, H, D], one dtype; strides
// holds the 12 element strides (b, s, h) of q, k, v, o; the last dim is
// contiguous.  D in {64, 80, 96, 128}.  Returns cudaGetLastError().
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         long long B, long long S, int H, int Hkv, int D,
                         int causal, const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, causal, strides, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        long long B, long long S, int H, int Hkv, int D,
                        int causal, const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, Hkv, D, causal, strides, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
