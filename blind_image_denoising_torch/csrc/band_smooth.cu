// Laplacian band split, band = x - A x and smooth = A x, where A is the
// count-aware SAME k x k stride-1 box mean (the extra row/column of an
// even window on the HIGH side, divide by the in-image tap count).
//
// Replaces blind_image_denoising_tpu/ops/pallas_pyramid.py
// laplacian_band_smooth_pallas (body _band_smooth_kernel). Memory-bound:
// one read of x and one write each of band and smooth. One thread per
// 16-byte vector of channels of one NHWC pixel; the tap sum is float32
// in row-major tap order, then multiplied by 1/count computed from the
// index (the plain PyTorch version, band_smooth_plain, does the same
// arithmetic in the same order).
#include "common.cuh"

namespace {

using bid::Vec16;

template <typename T>
__global__ void __launch_bounds__(256) band_smooth_kernel(
    const T* __restrict__ x, T* __restrict__ band, T* __restrict__ smooth,
    int B, int H, int W, int C, int k) {
  constexpr int V = Vec16<T>::N;
  const int cv_n = C / V;
  const long long n = (long long)B * H * W * cv_n;
  const int lo = (k - 1) / 2;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int cv = (int)(i % cv_n);
    const long long pix = i / cv_n;
    const int w = (int)(pix % W);
    const long long bh = pix / W;
    const int h = (int)(bh % H);
    const long long b = bh / H;
    const int y0 = h - lo, x0 = w - lo;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < k; ++dy) {
      const int y = y0 + dy;
      if (y < 0 || y >= H) continue;
      for (int dx = 0; dx < k; ++dx) {
        const int xx = x0 + dx;
        if (xx < 0 || xx >= W) continue;
        Vec16<T> t;
        t.raw = *reinterpret_cast<const uint4*>(
            x + ((b * H + y) * W + xx) * C + cv * V);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], bid::to_float(t[j]));
      }
    }
    const int rows = min(y0 + k, H) - max(y0, 0);
    const int cols = min(x0 + k, W) - max(x0, 0);
    const float inv = __fdiv_rn(1.f, (float)(rows * cols));
    const long long off = ((b * H + h) * W + w) * C + cv * V;
    Vec16<T> xc, sb, ss;
    xc.raw = *reinterpret_cast<const uint4*>(x + off);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float s = __fmul_rn(acc[j], inv);
      ss[j] = bid::from_float<T>(s);
      sb[j] = bid::from_float<T>(__fsub_rn(bid::to_float(xc[j]), s));
    }
    *reinterpret_cast<uint4*>(band + off) = sb.raw;
    *reinterpret_cast<uint4*>(smooth + off) = ss.raw;
  }
}

template <typename T>
int launch(const void* x, void* band, void* smooth, int B, int H, int W,
           int C, int k, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (C % V != 0 || k < 1 || B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  const long long n = (long long)B * H * W * (C / V);
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)bid::sm_count() * 16;
  if (blocks > cap) blocks = cap;
  band_smooth_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(band), static_cast<T*>(smooth),
      B, H, W, C, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bid_band_smooth(const void* x, void* band, void* smooth,
                               int B, int H, int W, int C, int k, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, band, smooth, B, H, W, C, k, s);
  if (dtype == 1) return launch<bid::bf16>(x, band, smooth, B, H, W, C, k, s);
  return BID_ERR_UNSUPPORTED;
}

extern "C" const char* bid_error_string(int code) {
  if (code == BID_ERR_UNSUPPORTED) return "unsupported dtype or shape";
  if (code == BID_ERR_BAD_ARGUMENT) return "bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
