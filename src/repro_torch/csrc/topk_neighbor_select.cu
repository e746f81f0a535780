// Kernel K5: per-row top-k with ties to the lowest column, the co-occurrence
// prefetcher's neighbor select, for Hopper, sm_90a.
//
// Replaces: src/repro/prefetch/kernels.py::topk_neighbor_select, the Pallas
// TPU kernel (pallas_call at :84) that holds one [1, L] score row (L padded
// to a multiple of 128 with -inf) in VMEM and runs k rounds of argmax over a
// `taken` mask.
//
//   order: score descending, ties to the lower column, -inf after every
//          finite score (an all -inf row walks its columns in order), NaN
//          after -inf (where numpy's stable argsort of -scores puts it;
//          several NaNs by column), -0.0 equal to +0.0
//   vals[m, j] = scores[m, idx[m, j]],  idx[m, :] = the first k columns of
//                row m in that order
//
// It takes f32 (the TPU contract) and f64: the host miner scores in f64, and
// rounding those to f32 could merge two distinct scores into a tie and pick
// another neighbor.  No padding: columns are masked by L itself.
//
// What bounds it on the card: neither bytes nor operations.  The miner's
// lists ([64, 16] f64, k = 12) are 8 KB in and 9 KB out, 5 ns at 3.35 TB/s;
// what a launch costs is its latency, and k rounds of a warp argmax (the
// Pallas kernel's design) would chain about 60 dependent shuffles at k = 12.
//
// What the design does about it: a rank select, one pass, no rounds.  Every
// score maps to an unsigned key whose order is the selection order (NaN
// lowest, -0.0 as +0.0), and a column's place in the output is its rank:
// the number of the row's columns that come before it (a larger key, or an
// equal key at a lower column).  Each lane computes the rank of its own
// columns from every other column's key, fetched by shuffles that do not
// wait on one another, and a lane whose rank is below k writes vals and idx
// at that rank: each output is written once, whatever k is.
//  * L <= 32 (the miner's lists): a row takes a group of G lanes, 16 for
//    L <= 16 (two rows share a warp) and 32 above; each lane loads one
//    column (one coalesced load a row) and takes L shuffles within its
//    group.
//  * L > 32 (the TPU-shaped check, [4096, 128] f32, k = 32): a warp takes a
//    row, kCols columns a lane a pass; the row's keys come by shuffles,
//    kCols * 32 at a time, so any L works without shared memory.
// Lanes past L hold no column: they load nothing, are never counted, and
// write nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;  // columns a lane a pass, rows wider than 32

template <typename T>
struct Keys;
template <>
struct Keys<float> {
  using U = uint32_t;
  static __device__ __forceinline__ U bits(float v) { return __float_as_uint(v); }
};
template <>
struct Keys<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U bits(double v) {
    return (U)__double_as_longlong(v);
  }
};

// An unsigned key in the selection order: a larger key comes first; NaN is
// 0, below -inf; -0.0 and +0.0 share one key.
template <typename T>
__device__ __forceinline__ typename Keys<T>::U sort_key(T v) {
  using U = typename Keys<T>::U;
  constexpr U kSign = U(1) << (8 * sizeof(U) - 1);
  if (isnan(v)) return 0;
  const U u = Keys<T>::bits(v == T(0) ? T(0) : v);
  return (u & kSign) ? ~u : (u | kSign);
}

// 1 when column j (key kj) comes before column i (key ki).
template <typename U>
__device__ __forceinline__ int before(U kj, int j, U ki, int i) {
  return (kj > ki) | ((kj == ki) & (j < i));
}

// Rows of at most G (16 or 32) columns: a group of G lanes a row.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    topk_narrow_kernel(const T* __restrict__ scores, T* __restrict__ vals,
                       int32_t* __restrict__ idx, int64_t rows, int width, int k) {
  using U = typename Keys<T>::U;
  const int col = threadIdx.x & (G - 1);
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  const bool live = row < rows && col < width;
  const T v = live ? scores[row * width + col] : T(0);
  const U key = sort_key(v);
  int rank = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const U kj = __shfl_sync(0xffffffffu, key, j, G);
    if (j < width) rank += before(kj, j, key, col);
  }
  if (live && rank < k) {
    vals[row * k + rank] = v;
    idx[row * k + rank] = col;
  }
}

// Rows wider than 32: a warp a row, kCols columns a lane a pass.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_wide_kernel(const T* __restrict__ scores, T* __restrict__ vals,
                     int32_t* __restrict__ idx, int64_t rows, int width, int k) {
  using U = typename Keys<T>::U;
  constexpr int kSpan = 32 * kCols;  // columns a pass
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* s = scores + row * width;
  for (int own = 0; own < width; own += kSpan) {
    T v[kCols];
    U key[kCols];
    int rank[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = own + 32 * t + lane;
      v[t] = c < width ? s[c] : T(0);
      key[t] = sort_key(v[t]);
      rank[t] = 0;
    }
    for (int src = 0; src < width; src += kSpan) {
      U sk[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = src + 32 * t + lane;
        sk[t] = c < width ? sort_key(s[c]) : U(0);
      }
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        if (src + 32 * t >= width) break;  // warp-uniform
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const U kj = __shfl_sync(0xffffffffu, sk[t], l);
          const int j = src + 32 * t + l;
          if (j < width) {
#pragma unroll
            for (int u = 0; u < kCols; ++u) rank[u] += before(kj, j, key[u], own + 32 * u + lane);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = own + 32 * t + lane;
      if (c < width && rank[t] < k) {
        vals[row * k + rank[t]] = v[t];
        idx[row * k + rank[t]] = c;
      }
    }
  }
}

template <typename T, int G>
void launch_narrow(const T* scores, T* vals, int32_t* idx, long long rows, int width, int k,
                   cudaStream_t stream) {
  const long long blocks = (rows * G + kThreads - 1) / kThreads;
  topk_narrow_kernel<T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(scores, vals, idx, rows,
                                                                      width, k);
}

template <typename T>
int launch(const void* scores_, void* vals_, void* idx_, long long rows, int width, int k,
           void* stream_) {
  if (rows <= 0 || k <= 0) return 0;
  const T* scores = (const T*)scores_;
  T* vals = (T*)vals_;
  int32_t* idx = (int32_t*)idx_;
  const cudaStream_t stream = (cudaStream_t)stream_;
  if (width <= 16) launch_narrow<T, 16>(scores, vals, idx, rows, width, k, stream);
  else if (width <= 32) launch_narrow<T, 32>(scores, vals, idx, rows, width, k, stream);
  else {
    const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    topk_wide_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(scores, vals, idx, rows,
                                                                   width, k);
  }
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
