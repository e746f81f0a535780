// Host code of the TMA tensor maps of the [B, S, heads, dh] bf16 tensors
// that K6 (flash_attention.cu) and its backward K6'
// (flash_attention_backward.cu) load: cuTensorMapEncodeTiled fetched from
// libcuda through the runtime, and a 4-D map over (dh, heads, S, B).
// Each source that includes it builds into a library of its own.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tensor_map {

// cuTensorMapEncodeTiled from libcuda, fetched once through the runtime (the
// library links nothing but cudart).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kEncodeError = 10000;  // + CUresult: a tensor map was refused

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return p != nullptr && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                            : nullptr;
  }();
  return fn;
}

// A 4-D map over (dh, heads, S, B) of a bf16 [B, S, heads, dh] tensor with
// element strides sb, ss, sh: boxes of `cols` columns x `rows` rows, swizzled
// over the box's row of cols * 2 bytes (128, 64 or 32), zeros outside the
// tensor.  Returns 0 or kEncodeError + CUresult.
inline int make_map(CUtensorMap* map, const void* ptr, long long B, long long S, int heads,
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

}  // namespace tensor_map
