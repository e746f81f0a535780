// Kernel K2: DLRM dot interaction (batched gram matrix) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/dot_interaction.py::dot_interaction, the Pallas
// TPU kernel (pallas_call at :36) that loads [block_b, F, D] into VMEM and
// contracts each sample's [F, D] x [D, F] on the MXU.
//
//   out[b, i, j] = sum_d float(x[b, i, d]) * float(x[b, j, d])   (f32)
//
// What bounds it on the card: bytes.  Per sample it reads F*D inputs and
// writes F*F f32 outputs for 2*F*F*D flops: at F = 27, D = 64 f32 that is
// about 9.5 flops per byte, under the card's f32 ridge of about 20
// (67 TFLOP/s over 3.35 TB/s), so device-memory traffic sets the floor.
// No TF32: the plain version holds f32 to 1e-4, and TF32 would miss that by
// an order of magnitude at D = 64.
//
// What the design does about it:
//  * Only the upper triangle.  F is padded to Fp, a multiple of 4, with zero
//    rows in shared memory and cut into 4-row tiles; a thread owns one tile
//    pair (ti <= tj) of one sample and keeps its 4 x 4 sums in registers, so
//    every value it loads from shared memory feeds 4 FMAs and the mirrored
//    half is never computed.  Sums run over d in order, in f32 FMAs.
//  * 16-byte loads.  Rows are read along D in 16-byte vectors (4 f32 or 8
//    bf16; bf16 converts to f32 exactly as it is read).  Row r of a sample
//    sits in slot (r % 4) * (Fp / 4) + r / 4, so the j rows that neighbouring
//    threads read (tiles tj, tj + 1, ...) lie in neighbouring slots, and the
//    slot pitch is an odd number of 16-byte units: the threads of a quarter
//    warp hit distinct banks, and those sharing ti read one broadcast address.
//  * Mirrored, coalesced stores.  Each result goes into the group's [F, F]
//    tiles in shared memory at (i, j) and (j, i); the group then leaves as
//    one contiguous stretch of G*F*F floats, consecutive threads on
//    consecutive addresses.  The full gram matrix is written, as the TPU
//    kernel does; dot_interaction_triu takes the triangle outside.
//  * Keep the card fed.  Blocks of 128 threads walk groups of G samples
//    (a grid-stride loop over at most as many blocks as fit on the card).
//    The next group's rows are copied in with cp.async into a second buffer
//    while the current group is computed.  G is the largest that keeps a
//    group's tiles within the block's threads and its shared memory within
//    48 KB, so 4 or more blocks stay resident per SM at F = 17-41, D = 64 (G =
//    2 at [2048, 27, 64] f32); it shrinks for small batches so more SMs share
//    them.  On the card a 74 KB budget (3 blocks a SM) ran slower at
//    [2048, 27, 64], and so did fewer, longer-lived blocks with 2 or 4
//    groups each, there and most at [3, 40, 512]
//    (tools/kernel_variants/k2_groups.json; the figures are in PERF.md):
//    a group's compute is a chain that one block runs alone, and resident
//    blocks overlap better than a block's own double buffer.  A sample
//    larger than 48 KB ([3, 40, 512]) takes the dynamic shared-memory
//    opt-in; the wrapper
//    refuses one past the 227 KB a block can hold.  Any batch size: the last
//    group may be short.
//
// Kernel K2' (dot_interaction_backward): the gradient of K2's upper
// triangle, which the Pallas kernel never needed (the reference trains
// through XLA's autodiff of its einsum and triangle gather).
//
//   dx[b] = (G[b] + G[b]^T) x[b],   G[b] = the triangle's gradient laid into
//   [F, F] (zero below the diagonal), so it counts twice on the diagonal.
//
// What bounds it on the card: bytes on paper.  Per sample it reads F*D
// inputs and F(F+1)/2 gradients and writes F*D outputs for 2*F*F*D flops,
// about 6.5 flops a byte at F = 27, D = 64, under the card's f32 ridge; at
// the trainer's [256, 27, 64] the bytes take 1.2 us.  In practice latency
// decides it: a block's chain of loading its sample, computing and storing,
// and how many such chains are in flight.
//
// What the design does about it:
//  * More work in flight.  A block takes one sample and a block of rows i
//    (the host's plan, kernels/dot_interaction.py::backward_plan): at
//    [256, 27, 64] 4 blocks of 8 rows a sample, 1,024 blocks of 64 threads,
//    all resident at once, against one 128-thread block a sample before.
//  * 16-byte cp.async of the sample's rows into shared memory (4-byte
//    pieces for the triangle's gradient, whose rows are not 16-byte
//    aligned, and for rows that are not whole 16-byte vectors).
//  * No unpack of S = G + G^T.  A thread reads S[i][j] straight from the
//    triangle: below the diagonal at off(j) + i - j, on and above it at
//    off(i) + j - i, off(r) = r F - r (r - 1) / 2 kept as j runs, the
//    diagonal doubled; no division, no [F, F] copy, no second barrier.
//  * Registers hold the sums.  A thread owns one 16-byte column vector of
//    RT rows i, so each x[j] vector it reads feeds 4 RT FMAs, and stores
//    dx as float4.  Each output is fmaf over j ascending from 0, as in the
//    one-block-a-sample design before it, so the bits are unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 4;  // rows per register tile
constexpr int kBlockSmemTarget = 48 * 1024;  // 4 or more blocks a SM
constexpr int kMaxSmem = 232448;  // 227 KB, a Hopper block's dynamic maximum

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 16-byte vector of the row as f32 values.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32: exact
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Plan {
  int Fp, T, ntiles, units, pitch, G;
  long long groups;
  int buf_units;  // one buffer, in 16-byte units
  size_t smem;
};

// units: 16-byte vectors per row; pitch: units rounded up to an odd count.
Plan make_plan(long long batch, int F, int D, int elem, int sms) {
  Plan p;
  p.Fp = (F + kTile - 1) / kTile * kTile;
  p.T = p.Fp / kTile;
  p.ntiles = p.T * (p.T + 1) / 2;
  p.units = D * elem / 16;
  p.pitch = p.units | 1;
  const long long sample = (long long)p.Fp * p.pitch * 16;
  auto bytes = [&](long long g) { return 2 * g * sample + g * (long long)F * F * 4; };
  long long G = kThreads / p.ntiles;
  const long long spread = (batch + 2LL * sms - 1) / (2LL * sms);  // 2 groups a SM
  if (G > spread) G = spread;
  while (G > 1 && bytes(G) > kBlockSmemTarget) --G;
  if (G < 1) G = 1;
  p.G = (int)G;
  p.groups = (batch + G - 1) / G;
  p.buf_units = (int)(G * p.Fp * p.pitch);
  p.smem = (size_t)bytes(G);
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_interaction_kernel(const T* __restrict__ x, float* __restrict__ out,
                           long long batch, int F, int D, Plan p) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ uint4 smem[];
  float* outs = reinterpret_cast<float*>(smem + 2 * p.buf_units);
  const int FF = F * F;
  const int row_units = F * p.units;  // a sample's 16-byte vectors in x

  // Zero both buffers once: the padding rows F..Fp-1 are never copied over.
  for (int e = threadIdx.x; e < 2 * p.buf_units; e += kThreads)
    smem[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load = [&](long long grp, uint4* dst) {
    const long long b0 = grp * p.G;
    const int ns = (int)(batch - b0 < p.G ? batch - b0 : p.G);
    const uint4* src = reinterpret_cast<const uint4*>(x + b0 * F * D);
    for (int e = threadIdx.x; e < ns * row_units; e += kThreads) {
      const int row = e / p.units;  // s * F + f
      const int c = e - row * p.units;
      const int s = row / F;
      const int f = row - s * F;
      const int slot = s * p.Fp + (f % kTile) * p.T + f / kTile;
      cp_async16(dst + slot * p.pitch + c, src + e);
    }
  };

  long long grp = blockIdx.x;
  if (grp < p.groups) load(grp, smem);
  cp_async_commit();
  for (int cur = 0; grp < p.groups; grp += gridDim.x, cur ^= 1) {
    if (grp + gridDim.x < p.groups) load(grp + gridDim.x, cur ? smem : smem + p.buf_units);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait<1>();
    __syncthreads();

    const uint4* in = cur ? smem + p.buf_units : smem;
    const long long b0 = grp * p.G;
    const int ns = (int)(batch - b0 < p.G ? batch - b0 : p.G);
    for (int item = threadIdx.x; item < ns * p.ntiles; item += kThreads) {
      const int s = item / p.ntiles;
      int rem = item - s * p.ntiles;
      int ti = 0;
      while (rem >= p.T - ti) {
        rem -= p.T - ti;
        ++ti;
      }
      const int tj = ti + rem;
      const uint4* base = in + (long long)s * p.Fp * p.pitch;
      float acc[kTile][kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;
      for (int u = 0; u < p.units; ++u) {
        float xi[kTile][V], xj[kTile][V];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          unpack(base[(a * p.T + ti) * p.pitch + u], xi[a]);
          unpack(base[(a * p.T + tj) * p.pitch + u], xj[a]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[a][c] = fmaf(xi[a][v], xj[c][v], acc[a][c]);
      }
      float* o = outs + s * FF;
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        const int i = ti * kTile + a;
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          const int j = tj * kTile + c;
          if (i < F && j < F) {
            o[i * F + j] = acc[a][c];
            o[j * F + i] = acc[a][c];
          }
        }
      }
    }
    __syncthreads();
    float* ob = out + b0 * FF;
    for (int e = threadIdx.x; e < ns * FF; e += kThreads) ob[e] = outs[e];
    __syncthreads();  // outs and this buffer are free for the next group
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

template <typename T>
int launch(const void* x, void* out, long long batch, int F, int D, void* stream) {
  if (batch <= 0) return 0;
  if (F <= 0 || D <= 0 || (D * (int)sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  const Plan p = make_plan(batch, F, D, (int)sizeof(T), sms);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = dot_interaction_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > p.groups) blocks = p.groups;
  kernel<<<(unsigned)blocks, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const T*)x, (float*)out, batch, F, D, p);
  return (int)cudaGetLastError();
}

// ---- K2': dot_interaction_backward

constexpr int kBwdMaxThreads = 128;  // the plan's threads a block, at most

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

size_t backward_smem(int F, int D) {
  return (size_t)((long long)F * D + (long long)F * (F + 1) / 2) * sizeof(float);
}

// Block: sample blockIdx.x / row_blocks, rows [rb RB, rb RB + RB) with
// RB = row_threads RT.  Thread (ct, rt): column vectors ct, ct +
// col_threads, ... of rows rb RB + rt + k row_threads, k < RT.
template <int VEC, int RT>
__global__ void __launch_bounds__(kBwdMaxThreads)
    dot_interaction_backward_kernel(const float* __restrict__ x,
                                    const float* __restrict__ grad_tri,
                                    float* __restrict__ dx, int F, int D, int col_threads,
                                    int row_threads, int row_blocks) {
  extern __shared__ float4 bwd_smem[];
  float* xs = reinterpret_cast<float*>(bwd_smem);  // [F, D]: the sample's rows
  float* tri = xs + F * D;                         // [F(F+1)/2]: its triangle's gradient
  const int FD = F * D;
  const int T = F * (F + 1) / 2;
  const long long b = blockIdx.x / row_blocks;
  const int rb = (int)(blockIdx.x - b * row_blocks);
  const int threads = col_threads * row_threads;
  const int t = threadIdx.x;
  const float* xb = x + b * FD;
  const float* gb = grad_tri + b * T;
  if constexpr (VEC == 4) {
    for (int e = t; e < FD / 4; e += threads) cp_async16(xs + 4 * e, xb + 4 * e);
  } else {
    for (int e = t; e < FD; e += threads) cp_async4(xs + e, xb + e);
  }
  for (int e = t; e < T; e += threads) cp_async4(tri + e, gb + e);
  cp_async_commit();

  const int ct = t % col_threads, rt = t / col_threads;
  int rows[RT], off[RT];
  bool ok[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int i = (rb * RT + k) * row_threads + rt;
    ok[k] = i < F;
    rows[k] = ok[k] ? i : F - 1;
    off[k] = rows[k] * F - rows[k] * (rows[k] - 1) / 2;  // where row i starts in the triangle
  }
  cp_async_wait<0>();
  __syncthreads();

  float* ob = dx + b * FD;
  const int nv = D / VEC;
  for (int c = ct; c < nv; c += col_threads) {
    float acc[RT][VEC];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;
    int offj = 0;  // off(j)
#pragma unroll 4
    for (int j = 0; j < F; ++j) {
      float xv[VEC];
      if constexpr (VEC == 4) {
        const float4 f = *reinterpret_cast<const float4*>(xs + j * D + 4 * c);
        xv[0] = f.x;
        xv[1] = f.y;
        xv[2] = f.z;
        xv[3] = f.w;
      } else {
        xv[0] = xs[j * D + c];
      }
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const int i = rows[k];
        float s = j < i ? tri[offj + i - j] : tri[off[k] + j - i];  // np.triu_indices order
        if (j == i) s = s + s;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(s, xv[v], acc[k][v]);
      }
      offj += F - j;
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (!ok[k]) continue;
      float* o = ob + rows[k] * D + c * VEC;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(o) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      else
        o[0] = acc[k][0];
    }
  }
}

template <int VEC, int RT>
int launch_backward_one(const void* x, const void* grad_tri, void* dx, long long batch, int F,
                        int D, int col_threads, int row_threads, int row_blocks, size_t smem,
                        void* stream) {
  auto kernel = dot_interaction_backward_kernel<VEC, RT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)(batch * row_blocks), col_threads * row_threads, smem,
           (cudaStream_t)stream>>>((const float*)x, (const float*)grad_tri, (float*)dx, F, D,
                                   col_threads, row_threads, row_blocks);
  return (int)cudaGetLastError();
}

// The host's plan is checked here, not trusted: a wrong one is refused.
int launch_backward(const void* x, const void* grad_tri, void* dx, long long batch, int F,
                    int D, int vec, int rows_per_thread, int col_threads, int row_threads,
                    int row_blocks, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = backward_smem(F, D);
  const bool aligned = (((uintptr_t)x | (uintptr_t)dx) & 15u) == 0;
  const int threads = col_threads * row_threads;
  if (F <= 0 || D <= 0 || smem > (size_t)kMaxSmem || (vec != 1 && vec != 4) || D % vec ||
      (vec == 4 && !aligned) || col_threads <= 0 || row_threads <= 0 || threads > kBwdMaxThreads ||
      row_blocks <= 0 || (long long)row_blocks * row_threads * rows_per_thread < F ||
      batch * row_blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
#define K2B_CASE(V, R)                                                                      \
  if (vec == V && rows_per_thread == R)                                                     \
    return launch_backward_one<V, R>(x, grad_tri, dx, batch, F, D, col_threads, row_threads, \
                                     row_blocks, smem, stream);
  K2B_CASE(4, 1)
  K2B_CASE(4, 2)
  K2B_CASE(4, 3)
  K2B_CASE(4, 4)
  K2B_CASE(1, 1)
  K2B_CASE(1, 2)
  K2B_CASE(1, 3)
  K2B_CASE(1, 4)
#undef K2B_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [batch, F, D] on a 16-byte boundary with D * sizeof(element) a multiple
// of 16, out [batch, F, F] f32.  Returns cudaGetLastError().
int dot_interaction_f32(const void* x, void* out, long long batch, int F,
                        int D, void* stream) {
  return launch<float>(x, out, batch, F, D, stream);
}

int dot_interaction_bf16(const void* x, void* out, long long batch, int F,
                         int D, void* stream) {
  return launch<__nv_bfloat16>(x, out, batch, F, D, stream);
}

// K2': x [batch, F, D] f32, grad_tri [batch, F(F+1)/2] f32 (np.triu_indices
// order), dx [batch, F, D] f32.  vec (4: D % 4 == 0 and x, dx on 16-byte
// boundaries; or 1), rows_per_thread (1-4), col_threads, row_threads and
// row_blocks are the host's plan.  Returns cudaGetLastError().
int dot_interaction_backward_f32(const void* x, const void* grad_tri, void* dx,
                                 long long batch, int F, int D, int vec, int rows_per_thread,
                                 int col_threads, int row_threads, int row_blocks,
                                 void* stream) {
  return launch_backward(x, grad_tri, dx, batch, F, D, vec, rows_per_thread, col_threads,
                         row_threads, row_blocks, stream);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
