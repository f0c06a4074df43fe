// K1's wide class of width 512: one ConvNext residual unit for
// 256 < C <= 512 at K = 1, 3, 5 or 7 (E = 4C), in every I/O mode (a depth-5
// unet_laplacian_v6 without self-attention runs (512, 5) at its level 4).
// The kernel is convnext_wide.cuh's at CW = 512: tiles of 4 x 8 pixels, four
// warps an m16 tile, the depthwise by groups of 64 channels
// (convnext_block.cuh has the design notes). In a source of its own so that
// it builds beside the width-256 class.
#include "convnext_wide.cuh"

namespace bid_k1 {

int launch_wide512(int dtype, const void* x, void* out, const void* dw,
                   const void* ln, const void* w2, const void* w3,
                   const void* gain, int B, int H, int W, int C, int K,
                   float slope, float s_in, float inv_out, cudaStream_t s) {
  return launch_wide_class<512>(dtype, x, out, dw, ln, w2, w3, gain, B, H, W,
                                C, K, slope, s_in, inv_out, s);
}

int info_wide512(int dtype, int C, int K, int* v) {
  return info_wide_class<512>(dtype, C, K, v);
}

}  // namespace bid_k1
