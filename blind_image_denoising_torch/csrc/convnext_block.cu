// One ConvNext residual unit at inference, fused (K1): the C entry points
// and the nine (C, K) at K <= 5 with instantiations of their own. Replaces
// blind_image_denoising_tpu/ops/pallas_convnext.py fused_convnext_block
// (body _block_kernel), float and int8 I/O modes; the design, and how
// every other C up to 1024 at K = 1, 3, 5, 7 with E = 4C runs in one pass
// (convnext_class.cuh, convnext_k7.cu, convnext_wide.cu and, on a
// thread-block cluster, convnext_cluster.cuh), is noted in
// convnext_block.cuh; every other shape JAX's kernel takes (C above 1024,
// any odd K, any E) runs the general route of three kernels
// (convnext_general.cuh).
#include "convnext_block.cuh"

namespace {

// the least C a thread-block cluster runs (convnext_cluster.cuh, which
// takes every C above 128): at C = 256 the one-block class of width 256
// measured faster (PERF.md §6)
constexpr int kClusterFrom = 257;

// the one-pass layouts take C = 1..1024 at K = 1, 3, 5, 7 with E = 4C
bool one_pass(int C, int K, int E) {
  return C >= 1 && C <= 1024 && (K == 1 || K == 3 || K == 5 || K == 7) &&
         (long long)E == 4LL * C;
}

// K1 takes every C >= 1, odd K >= 1 and E >= 1 in every I/O mode (JAX's
// kernel: K = 2 pad + 1)
bool supported(int C, int K, int E) {
  return C >= 1 && K >= 1 && (K & 1) && E >= 1;
}

template <typename T>
int dispatch(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, int K, float slope, float s_in, float inv_out,
             cudaStream_t s) {
#define BID_CASE(CC, KK)                                                     \
  if (C == CC && K == KK)                                                    \
    return launch<T, CC, KK>(x, out, dw, ln, w2, w3, gain, B, H, W, CC,      \
                             slope, s_in, inv_out, s);
  BID_CASE(32, 1)  // the decoders of unet_laplacian_v3 / v4 / v5, level 0
  BID_CASE(32, 3)  // the packaged flagship's level 0
  BID_CASE(32, 5)  // unet_laplacian_v6's level 0 (and v3 / v4 / v5's)
  BID_CASE(64, 1)  // the decoders of unet_laplacian_v3 / v4 / v5, level 1
  BID_CASE(64, 3)  // level 1 of a K = 3 level list
  BID_CASE(64, 5)  // level 1 of all
  BID_CASE(128, 1)  // the decoders of unet_laplacian_v3 / v4, level 2
  BID_CASE(128, 3)  // level 2 of a K = 3 level list
  BID_CASE(128, 5)  // v3 / v4's level 2; a depth-4 unet_laplacian_v6's
#undef BID_CASE
  if (C <= 128 && K == 7)
    return bid_k1::launch_k7(dtype_code<T>(), x, out, dw, ln, w2, w3, gain,
                             B, H, W, C, slope, s_in, inv_out, s);
  if (C <= 128)
    return bid_k1::launch_class(dtype_code<T>(), x, out, dw, ln, w2, w3,
                                gain, B, H, W, C, K, slope, s_in, inv_out, s);
  if (C < kClusterFrom)
    return bid_k1::launch_wide(dtype_code<T>(), x, out, dw, ln, w2, w3, gain,
                               B, H, W, C, K, slope, s_in, inv_out, s);
  return bid_k1::launch_cluster_unit<T>(x, out, dw, ln, w2, w3, gain, B, H, W,
                                        C, K, slope, s_in, inv_out, s);
}

template <typename T>
int dispatch_info(int C, int K, int* v) {
#define BID_INFO(CC, KK) \
  if (C == CC && K == KK) return info<T, CC, KK>(v);
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
  if (C <= 128 && K == 7) return bid_k1::info_k7(dtype_code<T>(), C, v);
  if (C <= 128) return bid_k1::info_class(dtype_code<T>(), C, K, v);
  if (C < kClusterFrom) return bid_k1::info_wide(dtype_code<T>(), C, K, v);
  return bid_k1::info_cluster_unit<T>(C, K, v);
}

}  // namespace

// info[0..8]: dynamic shared-memory bytes, registers per thread, local
// (spill) bytes per thread, threads per block, resident blocks per SM,
// cluster size (1 for the one-block layouts), the clusters (blocks) the
// card holds at once, the width of the layout (the channels the weights
// are padded to), and the stages of its weight ring (0 where W2 and W3
// are resident or on a cluster's own ring), of the instantiation that
// runs (C, K, E); the general route's: the largest shared memory,
// registers and spills of its three kernels, the fewest blocks an SM
// holds, cluster size 1, width C, no ring
extern "C" int bid_convnext_block_info(int C, int K, int E, int dtype,
                                       int* info) {
  if (!supported(C, K, E) || dtype < 0 || dtype > 2)
    return BID_ERR_UNSUPPORTED;
  if (!one_pass(C, K, E)) return bid_k1::info_general(dtype, C, info);
  if (dtype == 0) return dispatch_info<float>(C, K, info);
  if (dtype == 1) return dispatch_info<bf16>(C, K, info);
  return dispatch_info<int8_t>(C, K, info);
}

// the bytes of device memory the general route takes as its scratch for P
// pixels of C channels and E expansion channels in I/O mode dtype
extern "C" long long bid_convnext_general_scratch_bytes(long long P, int C,
                                                        int E, int dtype) {
  return bid_k1::general_scratch_bytes(P, C, E, dtype);
}

// the general route at any shape it takes (the dispatcher below runs it
// only where the one-pass layouts do not): dw [K * K][C] f32, W2 [E][C] and
// W3 [C][E] in the I/O type (bf16 for int8), scratch of
// bid_convnext_general_scratch_bytes at least, on 256 bytes
extern "C" int bid_convnext_block_general(
    const void* x, void* out, const void* dw, const void* ln, const void* w2,
    const void* w3, const void* gain, void* scratch, long long scratch_bytes,
    int B, int H, int W, int C, int K, int E, int dtype, float slope,
    float s_in, float inv_out, void* stream) {
  if (B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  if (!supported(C, K, E)) return BID_ERR_UNSUPPORTED;
  return bid_k1::launch_general(dtype, x, out, dw, ln, w2, w3, gain, scratch,
                                scratch_bytes, B, H, W, C, K, E, slope, s_in,
                                inv_out, static_cast<cudaStream_t>(stream));
}

// one unit; the operands are kernel_operands' for the route of (C, K, E)
// (ops/pallas_convnext.py), and scratch (the general route's) may be null
// where the one-pass layouts run
extern "C" int bid_convnext_block(const void* x, void* out, const void* dw,
                                  const void* ln, const void* w2,
                                  const void* w3, const void* gain,
                                  void* scratch, long long scratch_bytes,
                                  int B, int H, int W, int C, int K, int E,
                                  int dtype, float slope, float s_in,
                                  float inv_out, void* stream) {
  if (B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  if (!supported(C, K, E)) return BID_ERR_UNSUPPORTED;
  if (!one_pass(C, K, E))
    return bid_convnext_block_general(x, out, dw, ln, w2, w3, gain, scratch,
                                      scratch_bytes, B, H, W, C, K, E, dtype,
                                      slope, s_in, inv_out, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
