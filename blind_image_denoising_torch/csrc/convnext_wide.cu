// K1's wide class of width 256: one ConvNext residual unit for
// 128 < C <= 256 at K = 1, 3, 5 or 7 (E = 4C), in every I/O mode
// (convnext_wide.cuh has the kernel, convnext_block.cuh the design notes).
#include "convnext_wide.cuh"

namespace bid_k1 {

int launch_wide(int dtype, const void* x, void* out, const void* dw,
                const void* ln, const void* w2, const void* w3,
                const void* gain, int B, int H, int W, int C, int K,
                float slope, float s_in, float inv_out, cudaStream_t s) {
  return launch_wide_class<256>(dtype, x, out, dw, ln, w2, w3, gain, B, H, W,
                                C, K, slope, s_in, inv_out, s);
}

int info_wide(int dtype, int C, int K, int* v) {
  return info_wide_class<256>(dtype, C, K, v);
}

}  // namespace bid_k1
