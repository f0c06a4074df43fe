// K1 run by a thread-block cluster in the int8 I/O mode: one ConvNext
// residual unit for 256 < C <= 1024 at K = 1, 3, 5 or 7 (E = 4C)
// (convnext_cluster.cuh has the kernel and its design notes). One source
// per I/O mode, so that the three build side by side.
#include "convnext_cluster.cuh"

namespace bid_k1 {

template int launch_cluster_unit<int8_t>(const void* x, void* out,
    const void* dw, const void* ln, const void* w2, const void* w3,
    const void* gain, int B, int H, int W, int C, int K, float slope,
    float s_in, float inv_out, cudaStream_t s);
template int info_cluster_unit<int8_t>(int C, int K, int* v);

}  // namespace bid_k1
