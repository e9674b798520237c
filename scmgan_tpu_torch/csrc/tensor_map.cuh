// Host side of the TMA weight streams of the transition kernels
// (fused_transition.cu, int8_transition.cu): tensor maps encoded with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace scm {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a kernel-layout weight matrix: `rows` rows of 128 bytes (one K
// tile of one output channel, `type` elements), read as boxes of n rows in
// the 128-byte swizzle that the wgmma descriptors expect.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, CUtensorMapDataType type,
                              int elem_bytes, int rows, int n) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)(128 / elem_bytes), (cuuint64_t)rows};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)n};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(w), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace scm
