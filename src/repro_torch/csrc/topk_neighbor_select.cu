// Kernel K5: per-row top-k with ties to the lowest column, the co-occurrence
// prefetcher's neighbor select, for Hopper, sm_90a.
//
// Replaces: src/repro/prefetch/kernels.py::topk_neighbor_select, the Pallas
// TPU kernel (pallas_call at :84) that holds one [1, L] score row (L padded
// to a multiple of 128 with -inf) in VMEM and runs k rounds of argmax over a
// `taken` mask.
//
//   order: score descending, ties to the lower column, -inf after every
//          finite score (an all -inf row walks its columns in order) and NaN
//          after -inf (where numpy's stable argsort of -scores puts it)
//   vals[m, j] = scores[m, idx[m, j]],  idx[m, :] = the first k columns of
//                row m in that order
//
// It takes f32 (the TPU contract) and f64: the host miner scores in f64, and
// rounding those to f32 could merge two distinct scores into a tie and pick
// another neighbor.  No padding: columns are masked by L itself.
//
// What bounds it on the card: bytes (M*L scores in, M*k values and indices
// out; the comparisons are a few per score and round).
//
// What the design does about it: one warp per row and no `taken` mask.  The
// order above is total, so round j picks the best column strictly after
// round j-1's pick: every lane scans its columns (lane, lane + 32, ...),
// keeps its best candidate in registers, and a shuffle butterfly leaves the
// warp's best in every lane.  There is no shared memory and no state but
// the previous pick, so any L works; the row is re-read each round from L1
// (L = 16 for the miner's lists, 128 for the TPU-shaped check).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

// True when (va, ca) comes strictly before (vb, cb) in the selection order.
template <typename T>
__device__ __forceinline__ bool before(T va, int ca, T vb, int cb) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return nb;
  if (!na && va != vb) return va > vb;
  return ca < cb;
}

template <typename T>
__global__ void topk_kernel(const T* __restrict__ scores, T* __restrict__ vals,
                            int32_t* __restrict__ idx, int64_t rows, int width,
                            int k) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* s = scores + row * width;
  T prev_v = T(0);
  int prev_c = -1;
  for (int j = 0; j < k; ++j) {
    T best_v = T(0);
    int best_c = width;  // none yet
    for (int c = lane; c < width; c += 32) {
      const T v = s[c];
      if (prev_c >= 0 && !before(prev_v, prev_c, v, c)) continue;  // taken
      if (best_c == width || before(v, c, best_v, best_c)) {
        best_v = v;
        best_c = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      if (oc != width && (best_c == width || before(ov, oc, best_v, best_c))) {
        best_v = ov;
        best_c = oc;
      }
    }
    prev_v = best_v;
    prev_c = best_c;
    if (lane == 0) {
      vals[row * k + j] = best_v;
      idx[row * k + j] = best_c;
    }
  }
}

template <typename T>
int launch(const void* scores, void* vals, void* idx, long long rows, int width,
           int k, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  topk_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const T*)scores, (T*)vals, (int32_t*)idx, rows, width, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scores [rows, width], vals [rows, k] of the same type, idx [rows, k] int32;
// k <= width (the wrapper checks).  Returns cudaGetLastError().
int topk_neighbor_select_f32(const void* scores, void* vals, void* idx,
                             long long rows, int width, int k, void* stream) {
  return launch<float>(scores, vals, idx, rows, width, k, stream);
}

int topk_neighbor_select_f64(const void* scores, void* vals, void* idx,
                             long long rows, int width, int k, void* stream) {
  return launch<double>(scores, vals, idx, rows, width, k, stream);
}

const char* topk_neighbor_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
