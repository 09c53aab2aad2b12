// Host side of the TMA unit's tensor maps, shared by the kernels that read
// or write through one (depthwise_pool.cu, temporal_attention.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_runtime.h>

namespace pvrl {

// cuTensorMapEncodeTiled, through the runtime (the driver library is not
// linked), or null
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The encoder reads the thread's current context, and a host thread's first
// runtime call is what makes the device's context current there (autograd
// runs a backward on a thread of its own): bind it before encoding.
inline bool bind_context() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

// A 5-d tensor map of bf16 (esize 2) or fp32 (4) elements at `base`: dims
// innermost first, dimension 0 contiguous, the byte strides of dimensions
// 1-4 (multiples of 16, in any order), boxes of `box` elements; what a box
// reaches outside the dims is zero-filled on a load and dropped on a store.
inline bool tensor_map_5d(CUtensorMap* map, const void* base, int esize,
                          const cuuint64_t (&dims)[5],
                          const cuuint64_t (&strides)[4],
                          const cuuint32_t (&box)[5],
                          CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                5, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pvrl
