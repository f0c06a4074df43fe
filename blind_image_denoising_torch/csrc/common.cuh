// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes by blind_image_denoising_torch/ops/cuda_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// status codes returned by the C entry points besides cudaError_t values
#define BID_ERR_UNSUPPORTED (-1)
#define BID_ERR_BAD_ARGUMENT (-2)

namespace bid {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16-byte vector of T: 4 floats or 8 bf16, moved as one uint4
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T& operator[](int j) {
    return reinterpret_cast<T*>(&raw)[j];
  }
};

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace bid
