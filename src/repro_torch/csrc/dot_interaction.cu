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
//
// What the design does about it: every input byte is read from device
// memory once.  A block of 256 threads stages S whole samples (as many as
// fit in 48 KB of shared memory, at most 16) with coalesced loads, upcasting
// bf16 to f32 on the way in; rows are padded to D + 1 floats so threads that
// read different rows at the same column hit different banks.  Each thread
// then computes (sample, i, j) dots strided by the block size, accumulating
// in f32 over d in order, and consecutive threads write consecutive outputs
// (coalesced stores).  The full [F, F] matrix is written, as the TPU kernel
// does; the triu is taken outside.  The last block masks the ragged edge,
// so any batch size works (the TPU kernel needs B % block_b == 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 16;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ x,
                                       float* __restrict__ out, int64_t batch,
                                       int F, int D, int S) {
  extern __shared__ float smem[];  // [S * F][D + 1]
  const int ld = D + 1;
  const int64_t b0 = (int64_t)blockIdx.x * S;
  const int ns = (int)(batch - b0 < S ? batch - b0 : S);
  const T* xb = x + b0 * F * D;
  const int n_in = ns * F * D;
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    const int row = e / D;
    smem[row * ld + (e - row * D)] = to_f32(xb[e]);
  }
  __syncthreads();
  const int FF = F * F;
  const int n_out = ns * FF;
  float* ob = out + b0 * FF;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int s = e / FF;
    const int r = e - s * FF;
    const int i = r / F;
    const int j = r - i * F;
    const float* xi = smem + (s * F + i) * ld;
    const float* xj = smem + (s * F + j) * ld;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(xi[d], xj[d], acc);
    ob[e] = acc;
  }
}

template <typename T>
int launch(const void* x, void* out, long long batch, int F, int D,
           void* stream) {
  if (batch <= 0) return 0;
  const long long per_sample = (long long)F * (D + 1) * sizeof(float);
  long long S = kDefaultSmem / per_sample;
  if (S < 1) S = 1;
  if (S > kMaxSamples) S = kMaxSamples;
  if (S > batch) S = batch;
  const long long smem = S * per_sample;
  if (smem > kDefaultSmem) {
    // One sample alone exceeds 48 KB: opt in to Hopper's larger carve-out
    // (the launch below reports an error past 227 KB).
    const cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (batch + S - 1) / S;
  dot_interaction_kernel<T><<<(unsigned)blocks, kThreads, (size_t)smem,
                              (cudaStream_t)stream>>>(
      (const T*)x, (float*)out, batch, F, D, (int)S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, F, D], out [batch, F, F] f32.  Returns cudaGetLastError().
int dot_interaction_f32(const void* x, void* out, long long batch, int F,
                        int D, void* stream) {
  return launch<float>(x, out, batch, F, D, stream);
}

int dot_interaction_bf16(const void* x, void* out, long long batch, int F,
                         int D, void* stream) {
  return launch<__nv_bfloat16>(x, out, batch, F, D, stream);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
