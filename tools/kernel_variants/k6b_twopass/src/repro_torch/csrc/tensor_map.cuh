// Host code of the TMA tensor maps of the [B, S, heads, dh] bf16 tensors
// that K6 (flash_attention.cu) and its backward K6'
// (flash_attention_backward.cu) load: cuTensorMapEncodeTiled and
// cuTensorMapReplaceAddress fetched from libcuda through the runtime, and a
// 4-D map over (dh, heads, S, B).  A map is encoded once for each shape,
// strides and box and kept; a later call with the same ones copies it and
// gives it its own address (cuTensorMapReplaceAddress), which costs the host
// a fraction of an encode.  Each source that includes it builds into a
// library of its own, with a cache of its own.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

namespace tensor_map {

// cuTensorMapEncodeTiled and cuTensorMapReplaceAddress from libcuda, fetched
// once through the runtime (the library links nothing but cudart).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

constexpr int kEncodeError = 10000;  // + CUresult: a tensor map was refused
constexpr int kCached = 64;  // maps kept, by shape, strides and box

template <typename Fn>
inline Fn driver_function(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
    p = nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess) p = nullptr;
#endif
  return p != nullptr && q == cudaDriverEntryPointSuccess ? reinterpret_cast<Fn>(p) : nullptr;
}

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = driver_function<EncodeTiled>("cuTensorMapEncodeTiled");
  return fn;
}

inline ReplaceAddress replace_address() {
  static ReplaceAddress fn = driver_function<ReplaceAddress>("cuTensorMapReplaceAddress");
  return fn;
}

// Encodes a 4-D map over (dh, heads, S, B) of a bf16 [B, S, heads, dh]
// tensor with element strides sb, ss, sh: boxes of `cols` columns x `rows`
// rows, swizzled over the box's row of cols * 2 bytes (128, 64 or 32), zeros
// outside the tensor.  Returns 0 or kEncodeError + CUresult.
inline int encode_map(CUtensorMap* map, const void* ptr, long long B, long long S, int heads,
                      int D, long long sb, long long ss, long long sh, int cols, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Everything a map holds but its address.
struct MapKey {
  long long B, S, sb, ss, sh;
  int heads, D, cols, rows;
  bool operator==(const MapKey& o) const {
    return B == o.B && S == o.S && sb == o.sb && ss == o.ss && sh == o.sh && heads == o.heads &&
           D == o.D && cols == o.cols && rows == o.rows;
  }
};

// The map encode_map would give, from the cache where one of the same key
// is kept: a copy of it with ptr as its address.  A miss encodes and keeps
// the map (the oldest of kCached goes).  Without cuTensorMapReplaceAddress
// every call encodes.  Returns 0 or kEncodeError + CUresult.
inline int make_map(CUtensorMap* map, const void* ptr, long long B, long long S, int heads,
                    int D, long long sb, long long ss, long long sh, int cols, int rows) {
  static std::mutex mu;
  static MapKey keys[kCached];
  static CUtensorMap maps[kCached];
  static int used = 0, next = 0;
  const MapKey key{B, S, sb, ss, sh, heads, D, cols, rows};
  ReplaceAddress replace = replace_address();
  if (replace != nullptr) {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      if (keys[i] == key) {
        *map = maps[i];
        const CUresult r = replace(map, const_cast<void*>(ptr));
        return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
      }
    }
  }
  const int err = encode_map(map, ptr, B, S, heads, D, sb, ss, sh, cols, rows);
  if (err == 0 && replace != nullptr) {
    std::lock_guard<std::mutex> lock(mu);
    keys[next] = key;
    maps[next] = *map;
    next = (next + 1) % kCached;
    used = used < kCached ? used + 1 : kCached;
  }
  return err;
}

}  // namespace tensor_map
