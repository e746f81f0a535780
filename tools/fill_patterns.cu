// Store patterns for filling a [1,272,000, 64] f32 output with zeros, some
// reading a bitmap of rows to skip (all clear here), as K1' does.  Built and
// run by tools/fill_patterns.py; none of these is a kernel of the port.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void zero(float4* p, bool cs) {
  if (cs)
    __stcs(p, make_float4(0.f, 0.f, 0.f, 0.f));
  else
    *p = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Grid-stride over 16-byte vectors; threads below LO of each block idle
// (K1''s grouping warps); with BM the row's bit is read before each store.
template <int LO, bool BM, bool CS>
__global__ void sweep(float4* p, const unsigned* bm, long long rows) {
  if ((int)threadIdx.x < LO) return;
  const int ft = blockDim.x - LO;
  const long long total = rows * 16, T = (long long)gridDim.x * ft;
  for (long long j = (long long)blockIdx.x * ft + threadIdx.x - LO; j < total; j += T) {
    if (BM) {
      const long long r = j >> 4;
      if ((bm[r >> 5] >> (r & 31)) & 1u) continue;
    }
    zero(p + j, CS);
  }
}

// The sweep with each thread's bitmap words loaded AHEAD steps early.
template <int LO, int AHEAD>
__global__ void sweep_ahead(float4* p, const unsigned* bm, long long rows) {
  if ((int)threadIdx.x < LO) return;
  const int ft = blockDim.x - LO;
  const long long total = rows * 16, T = (long long)gridDim.x * ft;
  auto at = [&](long long j) { return j < total ? bm[(j >> 4) >> 5] : ~0u; };
  const long long j0 = (long long)blockIdx.x * ft + threadIdx.x - LO;
  unsigned ah[AHEAD];
#pragma unroll
  for (int q = 0; q < AHEAD; ++q) ah[q] = at(j0 + q * T);
  for (long long j = j0; j < total; j += AHEAD * T) {
#pragma unroll
    for (int q = 0; q < AHEAD; ++q) {
      const long long jq = j + q * T;
      const unsigned w = ah[q];
      ah[q] = at(jq + AHEAD * T);
      if (jq < total && !((w >> ((jq >> 4) & 31)) & 1u)) zero(p + jq, true);
    }
  }
}

// Block b fills bitmap words b, b + G, ... (32 rows, 512 vectors each).
template <int LO>
__global__ void owned(float4* p, const unsigned* bm, long long rows) {
  if ((int)threadIdx.x < LO) return;
  const int ft = blockDim.x - LO, t = threadIdx.x - LO;
  const long long words = (rows + 31) >> 5;
  for (long long u = blockIdx.x; u < words; u += gridDim.x) {
    const unsigned w = bm[u];
    for (int i = t; i < 512; i += ft)
      if (!((w >> (i >> 4)) & 1u)) zero(p + (u << 9) + i, true);
  }
}

// One vector a thread, the grid as large as the output (a plain fill's shape).
template <bool BM>
__global__ void one_vector(float4* p, const unsigned* bm, long long rows) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rows * 16) return;
  if (BM && ((bm[(j >> 4) >> 5] >> ((j >> 4) & 31)) & 1u)) return;
  zero(p + j, true);
}

// One TMA bulk store of C bytes from zeroed shared memory a warp at a time.
template <int C>
__global__ void bulk(char* p, long long bytes) {
  __shared__ __align__(128) float4 z[C / 16];
  for (int i = threadIdx.x; i < C / 16; i += blockDim.x) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long W = ((long long)gridDim.x * blockDim.x) >> 5;
  if ((threadIdx.x & 31) == 0) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(z);
    for (long long c = w; c * C < bytes; c += W) {
      const long long n = bytes - c * C < C ? bytes - c * C : C;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(p + c * C),
                   "r"(s), "r"((int)n)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  __syncthreads();
}

}  // namespace

extern "C" {

// Pattern `which` (see PATTERNS in fill_patterns.py) over out [rows, 64] f32
// with the bitmap bm [ceil(rows / 32)]; blocks for the persistent ones.
int fill_pattern(int which, void* out, const void* bm, long long rows, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float4* q = (float4*)out;
  const unsigned* b = (const unsigned*)bm;
  const unsigned vec_blocks = (unsigned)((rows * 16 + 255) / 256);
  switch (which) {
    case 0: sweep<0, false, false><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 1: sweep<0, false, true><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 2: sweep<64, false, true><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 3: sweep<64, true, true><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 4: sweep<64, true, false><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 5: sweep_ahead<64, 8><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 6: sweep_ahead<64, 4><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 7: owned<64><<<blocks, 256, 0, s>>>(q, b, rows); break;
    case 8: one_vector<false><<<vec_blocks, 256, 0, s>>>(q, b, rows); break;
    case 9: one_vector<true><<<vec_blocks, 256, 0, s>>>(q, b, rows); break;
    case 10: bulk<2048><<<blocks, 256, 0, s>>>((char*)out, rows * 256); break;
    case 11: bulk<8192><<<blocks, 256, 0, s>>>((char*)out, rows * 256); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
