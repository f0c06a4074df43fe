// K1 at K = 7: the classes of width 32, 64 and 128 for every C up to 128
// but 32, 64 and 128 themselves (convnext_k7.cu), in every I/O mode.
#include "convnext_block.cuh"

namespace {

template <typename T>
int dispatch(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, float slope, float s_in, float inv_out,
             cudaStream_t s) {
  const int cw = C <= 32 ? 32 : C <= 64 ? 64 : 128;
#define BID_K7_CLASS(CW)                                                    \
  if (cw == CW)                                                             \
    return launch<T, CW, 7, true>(x, out, dw, ln, w2, w3, gain, B, H, W, C, \
                                  slope, s_in, inv_out, s);
  BID_K7_CLASS(32)
  BID_K7_CLASS(64)
  BID_K7_CLASS(128)
#undef BID_K7_CLASS
  return BID_ERR_UNSUPPORTED;
}

template <typename T>
int dispatch_info(int C, int* v) {
  const int cw = C <= 32 ? 32 : C <= 64 ? 64 : 128;
  if (cw == 32) return info<T, 32, 7, true>(v);
  if (cw == 64) return info<T, 64, 7, true>(v);
  return info<T, 128, 7, true>(v);
}

}  // namespace

namespace bid_k1 {

int launch_k7_class(int dtype, const void* x, void* out, const void* dw,
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

int info_k7_class(int dtype, int C, int* v) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0) return dispatch_info<float>(C, v);
  if (dtype == 1) return dispatch_info<bf16>(C, v);
  if (dtype == 2) return dispatch_info<int8_t>(C, v);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace bid_k1
