// K1's general route (convnext_general.cuh has the kernels and their design
// notes): every shape JAX's kernel takes that the one-pass layouts do not,
// in every I/O mode, as three kernels through scratch in device memory.
#include "convnext_general.cuh"

namespace bid_k1 {

int launch_general(int dtype, const void* x, void* out, const void* dw,
                   const void* ln, const void* w2, const void* w3,
                   const void* gain, void* scratch, long long scratch_bytes,
                   int B, int H, int W, int C, int K, int E, float slope,
                   float s_in, float inv_out, cudaStream_t s) {
  if (dtype == 0)
    return launch_general_t<float>(x, out, dw, ln, w2, w3, gain, scratch,
                                   scratch_bytes, B, H, W, C, K, E, slope,
                                   s_in, inv_out, s);
  if (dtype == 1)
    return launch_general_t<bf16>(x, out, dw, ln, w2, w3, gain, scratch,
                                  scratch_bytes, B, H, W, C, K, E, slope,
                                  s_in, inv_out, s);
  if (dtype == 2)
    return launch_general_t<int8_t>(x, out, dw, ln, w2, w3, gain, scratch,
                                    scratch_bytes, B, H, W, C, K, E, slope,
                                    s_in, inv_out, s);
  return BID_ERR_UNSUPPORTED;
}

int info_general(int dtype, int C, int* v) {
  if (dtype == 0) return info_general_t<float>(C, v);
  if (dtype == 1) return info_general_t<bf16>(C, v);
  if (dtype == 2) return info_general_t<int8_t>(C, v);
  return BID_ERR_UNSUPPORTED;
}

long long general_scratch_bytes(long long P, int C, int E, int dtype) {
  return (long long)general_scratch(P, C, E, dtype == 0 ? 4 : 2).total;
}

}  // namespace bid_k1
