// K1's class kernels: one ConvNext residual unit for every C up to 128 at
// K = 1, 3 or 5 (E = 4C; K = 7: convnext_k7.cu) but the (C, K) of their own
// (convnext_block.cu),
// in every I/O mode: the layouts of C = 32, 64 and 128 with the true C a
// launch argument and the weights padded to the class's width by the
// wrapper (convnext_block.cuh notes how padded channels behave).
#include "convnext_block.cuh"

namespace {

template <typename T>
int dispatch(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, int K, float slope, float s_in, float inv_out,
             cudaStream_t s) {
  const int cw = C <= 32 ? 32 : C <= 64 ? 64 : 128;
#define BID_CLASS(CW, KK)                                                   \
  if (cw == CW && K == KK)                                                  \
    return launch<T, CW, KK, true>(x, out, dw, ln, w2, w3, gain, B, H, W, C, \
                                   slope, s_in, inv_out, s);
  BID_CLASS(32, 1)
  BID_CLASS(32, 3)
  BID_CLASS(32, 5)
  BID_CLASS(64, 1)
  BID_CLASS(64, 3)
  BID_CLASS(64, 5)
  BID_CLASS(128, 1)
  BID_CLASS(128, 3)
  BID_CLASS(128, 5)
#undef BID_CLASS
  return BID_ERR_UNSUPPORTED;
}

template <typename T>
int dispatch_info(int C, int K, int* v) {
  const int cw = C <= 32 ? 32 : C <= 64 ? 64 : 128;
#define BID_INFO(CW, KK) \
  if (cw == CW && K == KK) return info<T, CW, KK, true>(v);
  BID_INFO(32, 1)
  BID_INFO(32, 3)
  BID_INFO(32, 5)
  BID_INFO(64, 1)
  BID_INFO(64, 3)
  BID_INFO(64, 5)
  BID_INFO(128, 1)
  BID_INFO(128, 3)
  BID_INFO(128, 5)
#undef BID_INFO
  return BID_ERR_UNSUPPORTED;
}

}  // namespace

namespace bid_k1 {

int launch_class(int dtype, const void* x, void* out, const void* dw,
                 const void* ln, const void* w2, const void* w3,
                 const void* gain, int B, int H, int W, int C, int K,
                 float slope, float s_in, float inv_out, cudaStream_t s) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0)
    return dispatch<float>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K, slope,
                           s_in, inv_out, s);
  if (dtype == 1)
    return dispatch<bf16>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K, slope,
                          s_in, inv_out, s);
  if (dtype == 2)
    return dispatch<int8_t>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K,
                            slope, s_in, inv_out, s);
  return BID_ERR_UNSUPPORTED;
}

int info_class(int dtype, int C, int K, int* v) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0) return dispatch_info<float>(C, K, v);
  if (dtype == 1) return dispatch_info<bf16>(C, K, v);
  if (dtype == 2) return dispatch_info<int8_t>(C, K, v);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace bid_k1
