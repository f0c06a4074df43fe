// K1 at K = 7 for every C up to 128 (E = 4C), in every I/O mode: (32, 7),
// (64, 7) and (128, 7) with instantiations of their own, and, through
// convnext_class.cuh, the class layouts of width C rounded up to 16 for
// every other C (the true C a launch argument, the weights padded by the
// wrapper). The
// layouts and what K = 7 changes in them are noted in convnext_block.cuh.
// Sources of their own (K = 7 unrolls 49 taps) so that they build beside
// the K <= 5 instantiations.
#include "convnext_block.cuh"

namespace {

template <typename T>
int dispatch(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, float slope, float s_in, float inv_out,
             cudaStream_t s) {
#define BID_K7(CW)                                                           \
  if (C == CW)                                                               \
    return launch<T, CW, 7>(x, out, dw, ln, w2, w3, gain, B, H, W, C, slope, \
                            s_in, inv_out, s);
  BID_K7(32)
  BID_K7(64)
  BID_K7(128)
#undef BID_K7
  return bid_k1::launch_k7_class(dtype_code<T>(), x, out, dw, ln, w2, w3,
                                 gain, B, H, W, C, slope, s_in, inv_out, s);
}

template <typename T>
int dispatch_info(int C, int* v) {
  if (C == 32) return info<T, 32, 7>(v);
  if (C == 64) return info<T, 64, 7>(v);
  if (C == 128) return info<T, 128, 7>(v);
  return bid_k1::info_k7_class(dtype_code<T>(), C, v);
}

}  // namespace

namespace bid_k1 {

int launch_k7(int dtype, const void* x, void* out, const void* dw,
              const void* ln, const void* w2, const void* w3,
              const void* gain, int B, int H, int W, int C, float slope,
              float s_in, float inv_out, cudaStream_t s) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0)
    return dispatch<float>(x, out, dw, ln, w2, w3, gain, B, H, W, C, slope,
                           s_in, inv_out, s);
  if (dtype == 1)
    return dispatch<bf16>(x, out, dw, ln, w2, w3, gain, B, H, W, C, slope,
                          s_in, inv_out, s);
  if (dtype == 2)
    return dispatch<int8_t>(x, out, dw, ln, w2, w3, gain, B, H, W, C, slope,
                            s_in, inv_out, s);
  return BID_ERR_UNSUPPORTED;
}

int info_k7(int dtype, int C, int* v) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0) return dispatch_info<float>(C, v);
  if (dtype == 1) return dispatch_info<bf16>(C, v);
  if (dtype == 2) return dispatch_info<int8_t>(C, v);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace bid_k1
