// One ConvNext residual unit at inference, fused:
//   t = LN(depthwise_KxK(x)) (f32 stats, eps 1e-3, scale only)
//   h = leaky_relu(W2 t, slope)   1x1, C -> E = 4C
//   p = W3 h                      1x1, E -> C
//   out = x + gain * p
//
// Replaces blind_image_denoising_tpu/ops/pallas_convnext.py
// fused_convnext_block (body _block_kernel), float I/O mode. NHWC in and
// out. Design and bound: see blind_image_denoising_torch/ops/
// pallas_convnext.py. In short:
// * persistent blocks walk over tiles of TH x TW output pixels of one
//   image; the weights are staged into shared memory once per block;
// * the input tile plus its K/2 halo is copied into shared memory with
//   zeros outside the image (SAME padding on all four borders);
// * one thread per pixel does the depthwise sum and the LayerNorm in f32;
// * bf16 I/O: each warp runs both 1x1 products for 16 pixels at a time
//   with mma.sync m16n8k16 (bf16 operands, f32 accumulation). The
//   expansion's accumulators, leaky-ReLU'd and rounded to bf16, are the
//   projection's A fragments in registers (chunks of 64 of the E
//   channels), so h never leaves the registers;
// * f32 I/O: every operation is f32 on the CUDA cores, one thread per
//   pixel, t and p held in registers.
#include <type_traits>

#include "common.cuh"

namespace {

using bid::bf16;

constexpr float kLnEps = 1e-3f;

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int TH = 8, TW = 32; };
template <> struct Tile<float> { static constexpr int TH = 8, TW = 16; };

template <typename T, int C_, int K_>
struct Cfg {
  static constexpr int C = C_, K = K_, E = 4 * C_, PAD = K_ / 2;
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int TH = Tile<T>::TH, TW = Tile<T>::TW;
  static constexpr int P = TH * TW;          // pixels per tile = threads
  static constexpr int IH = TH + 2 * PAD, IW = TW + 2 * PAD;
  static constexpr int V = 16 / sizeof(T);   // elements per 16-byte vector
  // row strides (elements) padded so that the warp's accesses below are
  // free of shared-memory bank conflicts
  static constexpr int LDX = C + V;          // input tile, per pixel
  static constexpr int LDT = C + 8;          // bf16 t / output tile rows
  static constexpr int LDW2 = C + 8;         // bf16 W2 [E][C] rows
  static constexpr int LDW3 = E + 8;         // bf16 W3 [C][E] rows
  // shared-memory layout (bytes)
  static constexpr size_t OFF_DW = 0;        // f32 [K*K][C]
  static constexpr size_t OFF_LN = align16(OFF_DW + 4 * K * K * C);
  static constexpr size_t OFF_GN = align16(OFF_LN + 4 * C);
  static constexpr size_t OFF_X = align16(OFF_GN + 4 * C);
  static constexpr size_t OFF_W2 = align16(OFF_X + sizeof(T) * IH * IW * LDX);
  // bf16: W2 bf16 [E][LDW2], W3 bf16 [C][LDW3], t/out tile bf16 [P][LDT]
  // f32:  W2 f32 [E][C], W3 transposed f32 [E][C]
  static constexpr size_t OFF_W3 =
      align16(OFF_W2 + (kBf16 ? 2 * E * LDW2 : 4 * E * C));
  static constexpr size_t OFF_T =
      align16(OFF_W3 + (kBf16 ? 2 * C * LDW3 : 4 * E * C));
  static constexpr size_t SMEM = OFF_T + (kBf16 ? 2 * P * LDT : 0);
};

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// D += A B for one m16n8k16 tile: A row-major bf16 (4 regs), B col-major
// bf16 (2 regs), D f32 (4 regs)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int C, int K>
__global__ void __launch_bounds__(Cfg<T, C, K>::P)
convnext_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ dw,
                      const float* __restrict__ ln,
                      const T* __restrict__ w2, const T* __restrict__ w3,
                      const float* __restrict__ gain, int B, int H, int W,
                      float slope) {
  using G = Cfg<T, C, K>;
  constexpr int E = G::E, P = G::P, V = G::V;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dws = reinterpret_cast<float*>(smem + G::OFF_DW);
  float* lns = reinterpret_cast<float*>(smem + G::OFF_LN);
  float* gns = reinterpret_cast<float*>(smem + G::OFF_GN);
  T* xs = reinterpret_cast<T*>(smem + G::OFF_X);
  const int tid = threadIdx.x;

  // ---- weights, once per block
  for (int i = tid; i < C * K * K; i += P) {
    const int c = i / (K * K), tap = i % (K * K);
    dws[tap * C + c] = dw[i];
  }
  for (int c = tid; c < C; c += P) {
    lns[c] = ln[c];
    gns[c] = gain[c];
  }
  if constexpr (G::kBf16) {
    bf16* w2s = reinterpret_cast<bf16*>(smem + G::OFF_W2);
    bf16* w3s = reinterpret_cast<bf16*>(smem + G::OFF_W3);
    for (int i = tid; i < E * C / 8; i += P) {
      const int e = i / (C / 8), c8 = i % (C / 8);
      *reinterpret_cast<uint4*>(w2s + e * G::LDW2 + c8 * 8) =
          *reinterpret_cast<const uint4*>(w2 + e * C + c8 * 8);
    }
    for (int i = tid; i < C * E / 8; i += P) {
      const int c = i / (E / 8), e8 = i % (E / 8);
      *reinterpret_cast<uint4*>(w3s + c * G::LDW3 + e8 * 8) =
          *reinterpret_cast<const uint4*>(w3 + c * E + e8 * 8);
    }
  } else {
    float* w2s = reinterpret_cast<float*>(smem + G::OFF_W2);
    float* w3t = reinterpret_cast<float*>(smem + G::OFF_W3);
    for (int i = tid; i < E * C; i += P) w2s[i] = w2[i];
    for (int i = tid; i < E * C; i += P) {
      const int c = i / E, e = i % E;
      w3t[e * C + c] = w3[i];
    }
  }

  const int tiles_w = (W + G::TW - 1) / G::TW;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  const int py = tid / G::TW, px = tid % G::TW;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_w);
    const long long rest = tile / tiles_w;
    const int ty = (int)(rest % tiles_h);
    const long long b = rest / tiles_h;
    const int y0 = ty * G::TH, x0 = tx * G::TW;

    __syncthreads();  // weights staged / previous tile done with smem

    // ---- input tile + halo, zeros outside the image
    constexpr int CV = C / V;
    for (int i = tid; i < G::IH * G::IW * CV; i += P) {
      const int cv = i % CV, pix = i / CV;
      const int iy = pix / G::IW, ix = pix % G::IW;
      const int gy = y0 + iy - G::PAD, gx = x0 + ix - G::PAD;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + ((b * H + gy) * W + gx) * C + cv * V));
      *reinterpret_cast<uint4*>(xs + pix * G::LDX + cv * V) = v;
    }
    __syncthreads();

    // ---- depthwise KxK + LayerNorm: one thread per pixel, f32
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const T* xp = xs + ((py + dy) * G::IW + px + dx) * G::LDX;
        const float* wp = dws + (dy * K + dx) * C;
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += V) {
          bid::Vec16<T> v;
          v.raw = *reinterpret_cast<const uint4*>(xp + c0);
#pragma unroll
          for (int j4 = 0; j4 < V; j4 += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wp + c0 + j4);
            acc[c0 + j4 + 0] = fmaf(bid::to_float(v[j4 + 0]), w4.x, acc[c0 + j4 + 0]);
            acc[c0 + j4 + 1] = fmaf(bid::to_float(v[j4 + 1]), w4.y, acc[c0 + j4 + 1]);
            acc[c0 + j4 + 2] = fmaf(bid::to_float(v[j4 + 2]), w4.z, acc[c0 + j4 + 2]);
            acc[c0 + j4 + 3] = fmaf(bid::to_float(v[j4 + 3]), w4.w, acc[c0 + j4 + 3]);
          }
        }
      }
    }
    float mean = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) mean += acc[c];
    mean *= (1.f / C);
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = acc[c] - mean;
      var = fmaf(d, d, var);
    }
    var *= (1.f / C);
    const float rs = rsqrtf(var + kLnEps);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = (acc[c] - mean) * rs * lns[c];

    if constexpr (G::kBf16) {
      // ---- t -> shared memory as bf16, one row per pixel
      bf16* ts = reinterpret_cast<bf16*>(smem + G::OFF_T);
      const bf16* w2s = reinterpret_cast<const bf16*>(smem + G::OFF_W2);
      const bf16* w3s = reinterpret_cast<const bf16*>(smem + G::OFF_W3);
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 8) {
        uint4 v;
        v.x = pack_bf16(acc[c0 + 0], acc[c0 + 1]);
        v.y = pack_bf16(acc[c0 + 2], acc[c0 + 3]);
        v.z = pack_bf16(acc[c0 + 4], acc[c0 + 5]);
        v.w = pack_bf16(acc[c0 + 6], acc[c0 + 7]);
        *reinterpret_cast<uint4*>(ts + tid * G::LDT + c0) = v;
      }
      __syncthreads();

      // ---- both 1x1 products on the tensor cores, 16 pixels per step
      const int warp = tid >> 5, lane = tid & 31;
      const int g = lane >> 2, q = lane & 3;
      for (int mt = warp; mt < P / 16; mt += P / 32) {
        const int m0 = mt * 16;
        uint32_t af[C / 16][4];
#pragma unroll
        for (int kt = 0; kt < C / 16; ++kt) {
          const bf16* r0 = ts + (m0 + g) * G::LDT + kt * 16 + 2 * q;
          const bf16* r1 = r0 + 8 * G::LDT;
          af[kt][0] = ld_u32(r0);
          af[kt][1] = ld_u32(r1);
          af[kt][2] = ld_u32(r0 + 8);
          af[kt][3] = ld_u32(r1 + 8);
        }
        float pacc[C / 8][4];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
#pragma unroll 1
        for (int ec = 0; ec < E; ec += 64) {
          float hacc[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) hacc[nt][i] = 0.f;
            const bf16* wr = w2s + (ec + nt * 8 + g) * G::LDW2 + 2 * q;
#pragma unroll
            for (int kt = 0; kt < C / 16; ++kt)
              mma_bf16(hacc[nt], af[kt], ld_u32(wr + kt * 16),
                       ld_u32(wr + kt * 16 + 8));
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t a[4];
            a[0] = pack_bf16(leaky(hacc[2 * kk][0], slope),
                             leaky(hacc[2 * kk][1], slope));
            a[1] = pack_bf16(leaky(hacc[2 * kk][2], slope),
                             leaky(hacc[2 * kk][3], slope));
            a[2] = pack_bf16(leaky(hacc[2 * kk + 1][0], slope),
                             leaky(hacc[2 * kk + 1][1], slope));
            a[3] = pack_bf16(leaky(hacc[2 * kk + 1][2], slope),
                             leaky(hacc[2 * kk + 1][3], slope));
#pragma unroll
            for (int nt = 0; nt < C / 8; ++nt) {
              const bf16* wr = w3s + (nt * 8 + g) * G::LDW3 + ec + kk * 16 + 2 * q;
              mma_bf16(pacc[nt], a, ld_u32(wr), ld_u32(wr + 8));
            }
          }
        }
        __syncwarp();
        // ---- out = x + gain * p, into this warp's rows of the tile
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
          const int c = nt * 8 + 2 * q;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = m0 + g + 8 * hf;
            const int ly = m / G::TW, lx = m % G::TW;
            const bf16* xr =
                xs + ((ly + G::PAD) * G::IW + lx + G::PAD) * G::LDX + c;
            const float o0 = __fadd_rn(bid::to_float(xr[0]),
                                       __fmul_rn(gns[c], pacc[nt][2 * hf]));
            const float o1 = __fadd_rn(bid::to_float(xr[1]),
                                       __fmul_rn(gns[c + 1], pacc[nt][2 * hf + 1]));
            *reinterpret_cast<uint32_t*>(ts + m * G::LDT + c) = pack_bf16(o0, o1);
          }
        }
      }
      __syncthreads();

      // ---- tile -> global, 16-byte stores
      for (int i = tid; i < P * (C / 8); i += P) {
        const int m = i / (C / 8), cv = i % (C / 8);
        const int gy = y0 + m / G::TW, gx = x0 + m % G::TW;
        if (gy < H && gx < W)
          *reinterpret_cast<uint4*>(out + ((b * H + gy) * W + gx) * C + cv * 8) =
              *reinterpret_cast<const uint4*>(ts + m * G::LDT + cv * 8);
      }
    } else {
      // ---- f32: both products on the CUDA cores, t and p in registers
      const float* w2s = reinterpret_cast<const float*>(smem + G::OFF_W2);
      const float* w3t = reinterpret_cast<const float*>(smem + G::OFF_W3);
      float p[C];
#pragma unroll
      for (int c = 0; c < C; ++c) p[c] = 0.f;
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        const float4* wr = reinterpret_cast<const float4*>(w2s + e * C);
        float h0 = 0.f, h1 = 0.f, h2 = 0.f, h3 = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 w = wr[c4];
          h0 = fmaf(w.x, acc[4 * c4 + 0], h0);
          h1 = fmaf(w.y, acc[4 * c4 + 1], h1);
          h2 = fmaf(w.z, acc[4 * c4 + 2], h2);
          h3 = fmaf(w.w, acc[4 * c4 + 3], h3);
        }
        const float hv = leaky((h0 + h1) + (h2 + h3), slope);
        const float4* wr3 = reinterpret_cast<const float4*>(w3t + e * C);
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 w = wr3[c4];
          p[4 * c4 + 0] = fmaf(w.x, hv, p[4 * c4 + 0]);
          p[4 * c4 + 1] = fmaf(w.y, hv, p[4 * c4 + 1]);
          p[4 * c4 + 2] = fmaf(w.z, hv, p[4 * c4 + 2]);
          p[4 * c4 + 3] = fmaf(w.w, hv, p[4 * c4 + 3]);
        }
      }
      const int gy = y0 + py, gx = x0 + px;
      if (gy < H && gx < W) {
        const float* xr = reinterpret_cast<const float*>(xs) +
                          ((py + G::PAD) * G::IW + px + G::PAD) * G::LDX;
        float* orow = reinterpret_cast<float*>(out) + ((b * H + gy) * W + gx) * C;
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          float4 o;
          o.x = __fadd_rn(xr[4 * c4 + 0], __fmul_rn(gns[4 * c4 + 0], p[4 * c4 + 0]));
          o.y = __fadd_rn(xr[4 * c4 + 1], __fmul_rn(gns[4 * c4 + 1], p[4 * c4 + 1]));
          o.z = __fadd_rn(xr[4 * c4 + 2], __fmul_rn(gns[4 * c4 + 2], p[4 * c4 + 2]));
          o.w = __fadd_rn(xr[4 * c4 + 3], __fmul_rn(gns[4 * c4 + 3], p[4 * c4 + 3]));
          *reinterpret_cast<float4*>(orow + 4 * c4) = o;
        }
      }
    }
  }
}

// Launch with a persistent grid: as many blocks as fit on the card at
// once (occupancy for this instantiation's shared memory), capped at the
// number of tiles. The shared-memory attribute and the occupancy are set
// and queried once per instantiation and device.
constexpr int kMaxDevices = 64;

template <typename T, int C, int K>
int launch(const void* x, void* out, const void* dw, const void* ln,
           const void* w2, const void* w3, const void* gain, int B, int H,
           int W, float slope, cudaStream_t stream) {
  using G = Cfg<T, C, K>;
  auto kern = convnext_block_kernel<T, C, K>;
  static int blocks_per_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev < 0 || dev >= kMaxDevices) return BID_ERR_UNSUPPORTED;
  int& max_blocks = blocks_per_device[dev];
  if (max_blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, G::P,
                                                      G::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return BID_ERR_UNSUPPORTED;
    max_blocks = occ * bid::sm_count();
  }
  const long long tiles = (long long)B * ((H + G::TH - 1) / G::TH) *
                          ((W + G::TW - 1) / G::TW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < max_blocks ? tiles : max_blocks);
  kern<<<grid, G::P, G::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const float*>(dw), static_cast<const float*>(ln),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const float*>(gain), B, H, W, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, int K, float slope, cudaStream_t s) {
#define BID_CASE(CC, KK)                                                     \
  if (C == CC && K == KK)                                                    \
    return launch<T, CC, KK>(x, out, dw, ln, w2, w3, gain, B, H, W, slope, s);
  BID_CASE(32, 3)  // the flagship's level 0
  BID_CASE(64, 5)  // the flagship's level 1
#undef BID_CASE
  return BID_ERR_UNSUPPORTED;
}

}  // namespace

extern "C" int bid_convnext_block(const void* x, void* out, const void* dw,
                                  const void* ln, const void* w2,
                                  const void* w3, const void* gain, int B,
                                  int H, int W, int C, int K, int dtype,
                                  float slope, void* stream) {
  if (B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K, slope, s);
  if (dtype == 1)
    return dispatch<bf16>(x, out, dw, ln, w2, w3, gain, B, H, W, C, K, slope, s);
  return BID_ERR_UNSUPPORTED;
}
