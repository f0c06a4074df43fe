// K1's class layouts at K = 1, 3, 5 (convnext_class.cuh): the widths 16,
// 32 and 48, and the dispatch of every class width to its source.
#include "convnext_class.cuh"

BID_CLASS_WIDTHS(class_16_48, false, 16, 32, 48)

namespace bid_k1 {

int launch_class(int dtype, const void* x, void* out, const void* dw,
                 const void* ln, const void* w2, const void* w3,
                 const void* gain, int B, int H, int W, int C, int K,
                 float slope, float s_in, float inv_out, cudaStream_t s) {
  const int cw = class_width(dtype, C);
  auto* f = cw <= 48 ? launch_class_16_48 : cw <= 80 ? launch_class_64_80
            : cw <= 112 ? launch_class_96_112 : launch_class_128;
  return f(dtype, x, out, dw, ln, w2, w3, gain, B, H, W, C, K, slope, s_in,
           inv_out, s);
}

int info_class(int dtype, int C, int K, int* v) {
  const int cw = class_width(dtype, C);
  auto* f = cw <= 48 ? info_class_16_48 : cw <= 80 ? info_class_64_80
            : cw <= 112 ? info_class_96_112 : info_class_128;
  return f(dtype, C, K, v);
}

int launch_k7_class(int dtype, const void* x, void* out, const void* dw,
                    const void* ln, const void* w2, const void* w3,
                    const void* gain, int B, int H, int W, int C, float slope,
                    float s_in, float inv_out, cudaStream_t s) {
  const int cw = class_width(dtype, C);
  auto* f = cw <= 64 ? launch_k7_class_16_64 : cw <= 96 ? launch_k7_class_80_96
                                                        : launch_k7_class_112_128;
  return f(dtype, x, out, dw, ln, w2, w3, gain, B, H, W, C, 7, slope, s_in,
           inv_out, s);
}

int info_k7_class(int dtype, int C, int* v) {
  const int cw = class_width(dtype, C);
  auto* f = cw <= 64 ? info_k7_class_16_64 : cw <= 96 ? info_k7_class_80_96
                                                      : info_k7_class_112_128;
  return f(dtype, C, 7, v);
}

}  // namespace bid_k1
