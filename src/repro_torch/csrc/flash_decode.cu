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
// What the design does about it (flash-decoding, as the reference's
// sequence-sharded decode combines its shards, src/repro/models/layers.py):
//  * The positions split into n_split chunks, balanced (chunk i is
//    [i S / n, (i + 1) S / n)), chosen by the wrapper (plan_split) so that
//    the grid (Hkv, B, n_split x head chunks) puts several blocks on every
//    SM even where B x Hkv is far below the card's 132 SMs.  A block serves
//    one (KV head, batch, chunk) and up to G of the KV head's query heads.
//  * Each block writes a partial (m, l, acc[dh]) per query head to an f32
//    workspace.  The last block of a (batch, KV head, head chunk) to finish,
//    found by an atomic ticket that it resets to 0, combines them: every
//    (m, l) into shared memory at once, then the accumulators rescaled and
//    summed in chunk order (deterministic, whichever block ends last), over
//    max(l, 1e-30).  One chunk writes out directly.  (A second launch for the
//    combine ran slower.)
//  * Each of the 4 warps of a block streams its own tiles of rows through a
//    4-stage cp.async ring in shared memory: the loads of three tiles are in
//    flight while it computes one, and no register holds a row in flight.
//    A copy is 16 bytes a lane over the tile's rows laid end to end, so no
//    lane idles at dh 80 (10 chunks a row).  (cp.async.bulk copies of whole
//    rows on mbarriers, and one KV head a warp, ran slower at the path shape.)
//  * Compute reads the tile from shared memory: a segment of W lanes (the
//    power of two at or above the row's 16-byte chunks) takes one row, lane
//    c its c-th chunk; the segment's partial dots meet in a butterfly of
//    shuffles, and each segment keeps its own (m, l, acc) in registers.  The
//    segments of a warp, then the warps, meet at the end.
//  * Grouped heads take G = 4 a block (q and acc of 4 heads in registers,
//    about 125 registers at dh 128, so that several blocks fit an SM; G = 8
//    took 195 and ran slower); more heads take more head chunks over the
//    same rows, read through L2.  At bf16 dh 16 a tile is 40 rows, 10 a
//    segment, whose scores and values stay in registers: 246 at G = 4, no
//    spill (PERF.md).
//  * cache_len is read on the card from an int32 tensor: one build serves
//    any fill level, and the decode loop never waits on the host.  A chunk
//    that starts at or past it writes an empty partial (m = -inf, l = 0,
//    acc = 0), which the combine weighs by 0.
//  * Nothing at or past cache_len is read: those rows may hold anything,
//    NaN included.  A tile's rows past it are zero-filled by the copy
//    (cp.async with source size 0 reads nothing) and scored -inf.
//  * Offsets are 64-bit, since a whole [L, B, S, Hkv, dh] cache passes 2^31
//    elements and the per-layer slice starts far into it.
//
// Shard mode (kPartial), for the sequence-sharded decode (the reference's
// layers.flash_decode_shard, src/repro/models/layers.py:168-220): the cache
// is one shard of the positions, starting at shard_start, a device int32
// that the kernel reads beside cache_len, so its valid length
// clamp(cache_len - shard_start, 0, S) never reaches the host.  The kernel
// then stops short of the division: it writes the shard's f32 sum
// acc = sum_p round(exp(s_p - m)) v_p, un-normalised, and beside it the
// row max m and l = sum_p exp(s_p - m) of each (b, h), for the caller's
// combine across shards (a max, then sums scaled by exp(m - max)).  acc
// stays f32 for bf16 caches too: the reference combines in f32.  A shard
// with no valid row writes m = -inf, l = 0, acc = 0, never NaN.  The same
// kernel, one template flag: the split over positions, the ring and the
// chunk combine are shared, only the length and the last stores differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;  // cp.async ring depth of each warp
constexpr int kStageBytes = 2560;  // K + V bytes of one warp's tile, at most
constexpr int kGroupHeads = 4;  // query heads a block serves when g > 1
constexpr int kMaxSplit = 512;  // chunks at most (the combine's shared memory)

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The layout of one (dtype, head dim): 16-byte chunks of a row, the lanes
// of a segment, the rows a warp computes at once, and the rows of a tile.
template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int kChunks = D / kVec;
  static constexpr int kLanes = kChunks <= 8 ? 8 : kChunks <= 16 ? 16 : 32;
  static constexpr int kSegs = 32 / kLanes;  // rows a warp computes at once
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kFit = kStageBytes / (2 * kRowBytes) / kSegs * kSegs;
  static constexpr int kRows = kFit > kSegs ? kFit : kSegs;  // rows a tile
  static constexpr int kPasses = kRows / kSegs;  // rows a segment takes a tile
  static constexpr int kRingBytes = kWarps * kStages * 2 * kRows * kRowBytes;
  static_assert(kChunks * kVec == D && kChunks <= 32, "a row must fit one warp");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  // Source size 0 reads nothing and zero-fills the 16 bytes.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// The output's element type: the caches' in the normal mode, f32 in shard mode.
template <typename T, bool kPartial>
struct Out {
  using type = T;
};
template <typename T>
struct Out<T, true> {
  using type = float;
};

// Partials of query head h, chunk i: acc at ws[(h' * n_split + i) * D],
// (m, l) at ws[B H n_split D + 2 (h' * n_split + i)], h' = b * H + h.  The
// last block of a group combines its gc heads: every (m, l) into shared
// memory at once, per head the max and the weights exp(m_i - max) (0 for an
// empty chunk) and l summed in chunk order, then out = sum over chunks, in
// order, of acc_i w_i, over max(l, 1e-30), with the loads of 4 chunks in
// flight at a time.  In shard mode out is the sum un-divided and (max, l)
// go to stats.
template <typename T, int D, int G, bool kPartial>
__device__ void combine(const float* __restrict__ ws, typename Out<T, kPartial>::type* __restrict__ out,
                        float* __restrict__ stats, long long bh0, int gc, int n_split,
                        long long n_partials, float* sm) {
  const float* ml = ws + n_partials * D;
  float* sm_w = sm;  // [gc][n_split]: m, then the weights
  float* sm_l = sm + G * kMaxSplit;  // [gc][n_split]
  float* sm_sum = sm_l + G * kMaxSplit;  // [gc]
  for (int t = threadIdx.x; t < gc * n_split; t += kThreads) {
    sm_w[t] = __ldcg(ml + 2 * (bh0 * n_split + t));
    sm_l[t] = __ldcg(ml + 2 * (bh0 * n_split + t) + 1);
  }
  __syncthreads();
  if (threadIdx.x < gc) {
    float* w = sm_w + threadIdx.x * n_split;
    const float* lp = sm_l + threadIdx.x * n_split;
    float mx = -INFINITY;
    for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, w[i]);
    float lsum = 0.f;
    for (int i = 0; i < n_split; ++i) {
      w[i] = w[i] == -INFINITY ? 0.f : __expf(w[i] - mx);
      lsum = fmaf(lp[i], w[i], lsum);
    }
    sm_sum[threadIdx.x] = lsum;
    if constexpr (kPartial) {
      stats[2 * (bh0 + threadIdx.x)] = mx;
      stats[2 * (bh0 + threadIdx.x) + 1] = lsum;
    }
  }
  __syncthreads();
  constexpr int P = (G * D + kThreads - 1) / kThreads;  // (head, dim) pairs a thread
  float o[P];
#pragma unroll
  for (int p = 0; p < P; ++p) o[p] = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_split; ++i) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int t = threadIdx.x + p * kThreads;
      const int j = t / D;
      if (t < gc * D)
        o[p] = fmaf(__ldcg(ws + ((bh0 + j) * n_split + i) * D + (t - j * D)),
                    sm_w[j * n_split + i], o[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = threadIdx.x + p * kThreads;
    const int j = t / D;
    if (t < gc * D) store(out + bh0 * D + t, kPartial ? o[p] : o[p] / fmaxf(sm_sum[j], 1e-30f));
  }
}

// One block per (KV head, batch, chunk x head chunk of G query heads).
template <typename T, int D, int G, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ len_ptr,
                        const int* __restrict__ start_ptr,
                        typename Out<T, kPartial>::type* __restrict__ out,
                        float* __restrict__ ml, float* __restrict__ ws,
                        int* __restrict__ tickets, long long S, int H, int Hkv,
                        int group, int n_split, float scale) {
  using L = Tile<T, D>;
  constexpr int VEC = L::kVec, C = L::kChunks, W = L::kLanes, R = L::kSegs;
  constexpr int ROWS = L::kRows, PASSES = L::kPasses;
  constexpr int kWarpSumBytes = kWarps * G * (D + 2) * 4;
  constexpr int kCombineBytes = (2 * G * kMaxSplit + G) * 4;
  constexpr int kSmem = cmax(L::kRingBytes, cmax(kWarpSumBytes, kCombineBytes));
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ int sm_last;

  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const int n_jc = (group + G - 1) / G;
  const long long sp = blockIdx.z / n_jc;  // this block's chunk
  const int jc = blockIdx.z - (int)sp * n_jc;
  const int j0 = jc * G;
  const int gc = min(G, group - j0);  // query heads in this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / W;
  const int c = lane % W;  // this lane's 16-byte chunk of a row
  const bool active = c < C;

  long long len = *len_ptr;
  if constexpr (kPartial) len -= *start_ptr;  // this shard's positions before cache_len
  len = len < 0 ? 0 : (len > S ? S : len);
  const long long p_begin = sp * S / n_split;
  const long long p_end = min((sp + 1) * S / n_split, len);
  const long long bh0 = b * H + (long long)hk * group + j0;  // first query head

  float qv[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float tmp[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    if (j < gc && active) to_f32(*reinterpret_cast<const uint4*>(q + (bh0 + j) * D + c * VEC), tmp);
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

  if (p_begin < p_end) {  // the same for the whole block
    const long long n_tiles = (p_end - p_begin + ROWS - 1) / ROWS;
    // Warp tile it covers positions r0 .. r0 + ROWS - 1, r0 = p_begin + (warp + it kWarps) ROWS.
    const int n_it = n_tiles > warp ? (int)((n_tiles - warp + kWarps - 1) / kWarps) : 0;
    uint4* ring = reinterpret_cast<uint4*>(smem) + warp * (kStages * 2 * ROWS * C);
    const long long row_stride = (long long)Hkv * D;  // elements between positions
    const T* kb = kc + (b * S * Hkv + hk) * D;
    const T* vb = vc + (b * S * Hkv + hk) * D;
    auto load = [&](int it) {
      const long long r0 = p_begin + (warp + (long long)it * kWarps) * ROWS;
      uint4* st = ring + (it % kStages) * (2 * ROWS * C);
#pragma unroll
      for (int x0 = 0; x0 < ROWS * C; x0 += 32) {
        const int x = x0 + lane;
        if (x < ROWS * C) {
          const int r = x / C;
          const long long p = r0 + r;
          const bool ok = p < p_end;
          const long long off = ok ? p * row_stride + (x - r * C) * VEC : 0;
          cp_async16(st + x, kb + off, ok);
          cp_async16(st + ROWS * C + x, vb + off, ok);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_it) load(s);
      cp_async_commit();
    }
    for (int it = 0; it < n_it; ++it) {
      if (it + kStages - 1 < n_it) load(it + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // tile it has landed
      __syncwarp();
      const uint4* ks = ring + (it % kStages) * (2 * ROWS * C);
      const uint4* vs = ks + ROWS * C;
      const long long r0 = p_begin + (warp + (long long)it * kWarps) * ROWS;
      float s[PASSES][G];
      float vx[PASSES][VEC];
      bool valid[PASSES];
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        const int r = u * R + seg;
        valid[u] = r0 + r < p_end;
        uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
        if (active) {
          kraw = ks[r * C + c];
          vraw = vs[r * C + c];
        }
        float kx[VEC];
        to_f32(kraw, kx);
        to_f32(vraw, vx[u]);
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
        for (int u = 0; u < PASSES; ++u) mn = fmaxf(mn, s[u][j]);
        if (mn == -INFINITY) continue;  // no valid row seen by this segment yet
        const float alpha = __expf(m[j] - mn);  // 0 when m[j] is -inf
        m[j] = mn;
        l[j] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] *= alpha;
#pragma unroll
        for (int u = 0; u < PASSES; ++u) {
          const float p = valid[u] ? __expf(s[u][j] - mn) : 0.f;
          l[j] += p;  // l from the unrounded p, as the Pallas kernel
          const float pr = round_to(p, q);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(pr, vx[u][e], acc[j][e]);
        }
      }
      __syncwarp();  // the stage is free for the load of tile it + kStages
    }
  }
  cp_async_wait<0>();

  // Combine the R segments of each warp (lanes W, 2W, ... apart).
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
  const long long n_partials = (long long)gridDim.y * H * n_split;
  __syncthreads();  // every warp is done with its ring: it becomes the scratch below
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;  // [kWarps][G]
  float* sm_acc = sm_l + kWarps * G;  // [kWarps][G][D]
  if (lane < W) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (lane == 0) {
        sm_m[warp * G + j] = m[j];
        sm_l[warp * G + j] = l[j];
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm_acc[(warp * G + j) * D + c * VEC + e] = acc[j][e];
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
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + j]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = __expf(sm_m[w * G + j] - mx);  // 0 for a warp with no row
        lsum = fmaf(sm_l[w * G + j], f, lsum);
        o = fmaf(sm_acc[(w * G + j) * D + d], f, o);
      }
    }
    if (n_split == 1) {
      if constexpr (kPartial) {
        store(out + (bh0 + j) * D + d, o);
        if (d == 0) {
          ml[2 * (bh0 + j)] = mx;
          ml[2 * (bh0 + j) + 1] = lsum;
        }
      } else {
        store(out + (bh0 + j) * D + d, o / fmaxf(lsum, 1e-30f));
      }
    } else {
      const long long pi = (bh0 + j) * n_split + sp;
      ws[pi * D + d] = o;
      if (d == 0) {
        ws[n_partials * D + 2 * pi] = mx;
        ws[n_partials * D + 2 * pi + 1] = lsum;
      }
    }
  }
  if (n_split == 1) return;

  // The last block of this (batch, KV head, head chunk) combines the chunks.
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = tickets + ((long long)b * Hkv + hk) * n_jc + jc;
    const bool last = atomicAdd(ticket, 1) == n_split - 1;
    if (last) *ticket = 0;  // every block of the group has counted: ready for the next call
    sm_last = last;
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  combine<T, D, G, kPartial>(ws, out, ml, bh0, gc, n_split, n_partials,
                             reinterpret_cast<float*>(smem));
}

template <typename T, int D, int G, bool kPartial>
int launch(const void* q, const void* kc, const void* vc, const int* len, const int* start,
           void* out, void* ml, void* ws, void* tickets, long long B, long long S, int H,
           int Hkv, int n_split, void* stream) {
  using O = typename Out<T, kPartial>::type;
  const int group = H / Hkv;
  const int n_jc = (group + G - 1) / G;
  if (B > 65535 || (long long)n_split * n_jc > 65535 || n_split > S || n_split > kMaxSplit ||
      (n_split > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)Hkv, (unsigned)B, (unsigned)(n_split * n_jc));
  const float scale = 1.f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  flash_decode_kernel<T, D, G, kPartial><<<grid, kThreads, 0, st>>>(
      (const T*)q, (const T*)kc, (const T*)vc, len, start, (O*)out, (float*)ml, (float*)ws,
      (int*)tickets, S, H, Hkv, group, n_split, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kPartial>
int by_group(const void* q, const void* kc, const void* vc, const int* len, const int* start,
             void* out, void* ml, void* ws, void* tickets, long long B, long long S, int H,
             int Hkv, int n_split, void* stream) {
  if (H / Hkv == 1)
    return launch<T, D, 1, kPartial>(q, kc, vc, len, start, out, ml, ws, tickets, B, S, H,
                                     Hkv, n_split, stream);
  return launch<T, D, kGroupHeads, kPartial>(q, kc, vc, len, start, out, ml, ws, tickets, B,
                                             S, H, Hkv, n_split, stream);
}

template <typename T, bool kPartial>
int by_dim(const void* q, const void* kc, const void* vc, const int* n, const int* start,
           void* out, void* ml, void* ws, void* tickets, long long B, long long S, int H,
           int Hkv, int D, int n_split, void* stream) {
  switch (D) {
    case 16: return by_group<T, 16, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    case 32: return by_group<T, 32, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    case 64: return by_group<T, 64, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    case 80: return by_group<T, 80, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    case 96: return by_group<T, 96, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    case 128: return by_group<T, 128, kPartial>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, n_split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* len,
             const void* shard_start, void* out, void* ml, void* ws, void* tickets,
             long long B, long long S, int H, int Hkv, int D, int n_split, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || S <= 0 || n_split < 1) return (int)cudaErrorInvalidValue;
  const int* n = (const int*)len;
  const int* start = (const int*)shard_start;
  if (start == nullptr)
    return by_dim<T, false>(q, kc, vc, n, nullptr, out, nullptr, ws, tickets, B, S, H, Hkv, D,
                            n_split, stream);
  if (ml == nullptr) return (int)cudaErrorInvalidValue;
  return by_dim<T, true>(q, kc, vc, n, start, out, ml, ws, tickets, B, S, H, Hkv, D, n_split,
                         stream);
}

}  // namespace

extern "C" {

// q [B, H, D], k_cache and v_cache [B, S, Hkv, D], all contiguous and of one
// dtype; cache_len a device int32 scalar; D in {16, 32, 64, 80, 96, 128} (at
// 16 and 32 a row is 2 to 8 chunks, taken by a segment of 8 lanes whose
// lanes past the row read nothing and add zeros).  n_split
// chunks of the positions (1 <= n_split <= S); for n_split > 1, ws an f32
// workspace of B H n_split (D + 2) elements and tickets B H int32 zeros that
// the kernel leaves at zero.  shard_start null: out [B, H, D] in the
// caches' dtype, normalised, ml unused.  shard_start a device int32 scalar
// (shard mode): out [B, H, D] f32, the un-normalised sum over this shard's
// positions below cache_len, and ml [B, H, 2] f32, each row's (max, l).
// Returns cudaGetLastError().
int flash_decode_bf16(const void* q, const void* kc, const void* vc,
                      const void* cache_len, const void* shard_start, void* out, void* ml,
                      void* ws, void* tickets, long long B, long long S, int H, int Hkv,
                      int D, int n_split, void* stream) {
  return dispatch<__nv_bfloat16>(q, kc, vc, cache_len, shard_start, out, ml, ws, tickets, B, S,
                                 H, Hkv, D, n_split, stream);
}

int flash_decode_f32(const void* q, const void* kc, const void* vc,
                     const void* cache_len, const void* shard_start, void* out, void* ml,
                     void* ws, void* tickets, long long B, long long S, int H, int Hkv, int D,
                     int n_split, void* stream) {
  return dispatch<float>(q, kc, vc, cache_len, shard_start, out, ml, ws, tickets, B, S, H, Hkv,
                         D, n_split, stream);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
