// K1's class layouts: one ConvNext residual unit for every C up to 128 but
// the (C, K) with instantiations of their own (convnext_block.cu,
// convnext_k7.cu), run by the layout of width class_width(C), C rounded up
// to 16, with the true C a launch argument (kRagged; the wrapper pads the
// weights to the width, convnext_block.cuh notes how padded channels
// behave). The widths are built over several sources, so that each nvcc
// pass stays short (convnext_class.cu, convnext_class_64.cu,
// convnext_class_96.cu, convnext_class_128.cu at K = 1, 3, 5;
// convnext_k7_class.cu, convnext_k7_class_80.cu and convnext_k7_class_112.cu
// at K = 7); each source
// instantiates its widths through launch_classes / info_classes below.
#pragma once

#include "convnext_block.cuh"

namespace {

// the width of the layout that runs C <= 128 channels (off the (C, K) of
// their own) in I/O type T: C rounded up to 16, the k step of the
// products' m16n8k16; float32 from C = 97 to 112 keeps the width 128 (its
// width-112 layout, t and the accumulators 112 registers a lane beside
// the streamed chunks' splits, spilled 64-96 bytes at 255 registers)
template <typename T>
constexpr bool built_width(int CW) {
  return !(std::is_same<T, float>::value && CW == 112);
}

template <typename T>
constexpr int class_width(int C) {
  const int cw = (C + 15) / 16 * 16;
  return built_width<T>(cw) ? cw : cw + 16;
}

inline int class_width(int dtype, int C) {
  return dtype == 0 ? class_width<float>(C) : class_width<bf16>(C);
}

// the layout of width CW (one of CWs) at K, for I/O type T
template <typename T, int K, int CW, int... Rest>
int launch_width(int cw, const void* x, void* out, const void* dw,
                 const void* ln, const void* w2, const void* w3,
                 const void* gain, int B, int H, int W, int C, float slope,
                 float s_in, float inv_out, cudaStream_t s) {
  if constexpr (built_width<T>(CW)) {
    if (cw == CW)
      return launch<T, CW, K, true>(x, out, dw, ln, w2, w3, gain, B, H, W, C,
                                    slope, s_in, inv_out, s);
  }
  if constexpr (sizeof...(Rest) > 0)
    return launch_width<T, K, Rest...>(cw, x, out, dw, ln, w2, w3, gain, B,
                                       H, W, C, slope, s_in, inv_out, s);
  return BID_ERR_UNSUPPORTED;
}

template <typename T, int K, int CW, int... Rest>
int info_width(int cw, int* v) {
  if constexpr (built_width<T>(CW)) {
    if (cw == CW) return info<T, CW, K, true>(v);
  }
  if constexpr (sizeof...(Rest) > 0) return info_width<T, K, Rest...>(cw, v);
  return BID_ERR_UNSUPPORTED;
}

// K7: the source's K = 7 layouts, else its K = 1, 3, 5 ones
template <bool K7, int... CWs, typename T>
int launch_t(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, int K, float slope, float s_in, float inv_out,
             cudaStream_t s, T*) {
  const int cw = class_width<T>(C);
#define BID_CLASS_K(KK)                                                      \
  if (K == KK)                                                               \
    return launch_width<T, KK, CWs...>(cw, x, out, dw, ln, w2, w3, gain, B, \
                                       H, W, C, slope, s_in, inv_out, s);
  if constexpr (K7) {
    BID_CLASS_K(7)
  } else {
    BID_CLASS_K(1)
    BID_CLASS_K(3)
    BID_CLASS_K(5)
  }
#undef BID_CLASS_K
  return BID_ERR_UNSUPPORTED;
}

template <bool K7, int... CWs, typename T>
int info_t(int C, int K, int* v, T*) {
  const int cw = class_width<T>(C);
  if constexpr (K7) {
    if (K == 7) return info_width<T, 7, CWs...>(cw, v);
  } else {
    if (K == 1) return info_width<T, 1, CWs...>(cw, v);
    if (K == 3) return info_width<T, 3, CWs...>(cw, v);
    if (K == 5) return info_width<T, 5, CWs...>(cw, v);
  }
  return BID_ERR_UNSUPPORTED;
}

// by dtype code (0 float32, 1 bfloat16, 2 int8)
template <bool K7, int... CWs>
int launch_classes(int dtype, const void* x, void* out, const void* dw,
                   const void* ln, const void* w2, const void* w3,
                   const void* gain, int B, int H, int W, int C, int K,
                   float slope, float s_in, float inv_out, cudaStream_t s) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0)
    return launch_t<K7, CWs...>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K,
                                slope, s_in, inv_out, s, (float*)nullptr);
  if (dtype == 1)
    return launch_t<K7, CWs...>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K,
                                slope, s_in, inv_out, s, (bf16*)nullptr);
  if (dtype == 2)
    return launch_t<K7, CWs...>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K,
                                slope, s_in, inv_out, s, (int8_t*)nullptr);
  return BID_ERR_UNSUPPORTED;
}

template <bool K7, int... CWs>
int info_classes(int dtype, int C, int K, int* v) {
  if (C < 1 || C > 128) return BID_ERR_UNSUPPORTED;
  if (dtype == 0) return info_t<K7, CWs...>(C, K, v, (float*)nullptr);
  if (dtype == 1) return info_t<K7, CWs...>(C, K, v, (bf16*)nullptr);
  if (dtype == 2) return info_t<K7, CWs...>(C, K, v, (int8_t*)nullptr);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace

namespace bid_k1 {

// each source's widths, by dtype code; BID_ERR_UNSUPPORTED off them
#define BID_CLASS_SOURCE(NAME)                                               \
  int launch_##NAME(int dtype, const void* x, void* out, const void* dw,     \
                    const void* ln, const void* w2, const void* w3,          \
                    const void* gain, int B, int H, int W, int C, int K,     \
                    float slope, float s_in, float inv_out, cudaStream_t s); \
  int info_##NAME(int dtype, int C, int K, int* v);
BID_CLASS_SOURCE(class_16_48)    // convnext_class.cu: 16, 32, 48
BID_CLASS_SOURCE(class_64_80)    // convnext_class_64.cu
BID_CLASS_SOURCE(class_96_112)   // convnext_class_96.cu
BID_CLASS_SOURCE(class_128)      // convnext_class_128.cu
BID_CLASS_SOURCE(k7_class_16_64)   // convnext_k7_class.cu: 16 .. 64
BID_CLASS_SOURCE(k7_class_80_96)   // convnext_k7_class_80.cu
BID_CLASS_SOURCE(k7_class_112_128)  // convnext_k7_class_112.cu
#undef BID_CLASS_SOURCE

}  // namespace bid_k1

// a source's definitions of its widths (K7: at K = 7)
#define BID_CLASS_WIDTHS(NAME, K7, ...)                                       \
  namespace bid_k1 {                                                          \
  int launch_##NAME(int dtype, const void* x, void* out, const void* dw,      \
                    const void* ln, const void* w2, const void* w3,           \
                    const void* gain, int B, int H, int W, int C, int K,      \
                    float slope, float s_in, float inv_out, cudaStream_t s) { \
    return launch_classes<K7, __VA_ARGS__>(dtype, x, out, dw, ln, w2, w3,     \
                                           gain, B, H, W, C, K, slope, s_in,  \
                                           inv_out, s);                       \
  }                                                                           \
  int info_##NAME(int dtype, int C, int K, int* v) {                          \
    return info_classes<K7, __VA_ARGS__>(dtype, C, K, v);                     \
  }                                                                           \
  }
