// K1's general route: one ConvNext residual unit at any shape that JAX's
// kernel takes (blind_image_denoising_tpu/ops/pallas_convnext.py
// fused_convnext_block: any C, any odd K = 2 pad + 1, any E), in the float32,
// bfloat16 and int8 I/O modes, for every shape the one-pass layouts
// (convnext_block.cuh: C up to 1024 at K = 1, 3, 5, 7 with E = 4C) do not
// take: C above 1024, K = 9, 11, ..., E other than 4C.
//
// Above C = 1024 the unit's weights (2 E C) and its t and h rows no longer
// fit one block's or one 8-block cluster's shared memory, so the unit runs
// as three kernels and t [P][C'] and h [P][E'] go through device memory, in
// scratch that the wrapper allocates (general_scratch below: P rounded up
// to the products' tile of kGM pixels, C' and E' to kGLd elements, the pads
// written as zeros, so that no copy reads past a row's end):
//   1. depthwise + LayerNorm: a group of G threads (a warp up to C = 1024,
//      else the block) owns a pixel and strides over its C channels; K is a
//      run-time loop over the taps that lie inside the image (SAME zero
//      padding); the raw f32 sums are kept in shared memory where they fit
//      (else recomputed), the statistics are f32 and two-pass (mean, then
//      centred variance), summed by shuffles and, over a block, in warp
//      order; t is stored in bf16 (bf16 and int8 I/O, whose codes are read
//      as bf16(q * bf16(scale_in))) or f32;
//   2. expansion h = leaky(t W2^T) and 3. projection out = x + gain (h W3^T):
//      one tiled product each, kGM x kGN outputs a block of 8 warps (32 x 32
//      a warp), a depth of 64 bytes a stage (32 bf16, 16 f32) in two stages
//      of cp.async copies; rows padded to 80 bytes, so that ldmatrix and the
//      f32 fragment loads are free of bank conflicts. bf16 operands run
//      mma.sync m16n8k16 (f32 sums); f32 runs K1's 3xTF32 split
//      (convnext_block.cuh: small.big + big.small + big.big, m16n8k8). Each
//      stage's products are summed on their own and added to the running
//      sums with one rounded f32 add, so a long chain (E = 8192 at C = 2048)
//      keeps f32's accuracy. W2 and W3 are read as they lie ([E][C], [C][E],
//      unpadded): a 16-byte copy where the vector is whole and aligned, else
//      element by element with the edges masked to zero. h is rounded to
//      bf16 in bf16 and int8 I/O; the projection's epilogue adds x and
//      requantizes (int8) at the plain version's rounding points.
// Bound: at C = 2048, E = 8192 the weights' bytes (64 MB in bf16) set the
// least time; the route also moves t and h through device memory twice.
// A simple kernel that is right: no wgmma, no TMA, no split of the products'
// depth across blocks (PERF.md §6 has its times).
#pragma once

#include <algorithm>

#include "convnext_block.cuh"

namespace {

constexpr int kGThreads = 256;
// the products' block tile and its stages (dynamic shared memory)
constexpr int kGM = 64, kGN = 128;
constexpr int kGRowBytes = 64;
constexpr int kGRowPitch = kGRowBytes + 16;
constexpr int kGStages = 2;
constexpr int kGStageBytes = (kGM + kGN) * kGRowPitch;
constexpr int kGGemmSmem = kGStages * kGStageBytes;
// the scratch rows' pitch is a multiple of kGLd elements (a whole stage's
// depth in bf16 and in f32)
constexpr int kGLd = 32;
// the depthwise + LayerNorm pass: the block reduction's bytes (8 warps), and
// the dynamic shared memory it keeps within (no attribute needed)
constexpr size_t kGReduce = 32;
constexpr size_t kGDefaultSmem = 48 * 1024;

inline long long round_up_ll(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// threads per pixel of the depthwise + LayerNorm pass
inline int dwln_group(int C) { return C <= 1024 ? 32 : kGThreads; }

// its dynamic shared memory: the block reduction (a pixel a block) and the
// raw sums of its pixels where they fit, else none (recomputed)
inline size_t dwln_smem(int C) {
  const int g = dwln_group(C);
  const size_t red = g == kGThreads ? kGReduce : 0;
  const size_t rows = (size_t)(kGThreads / g) * (size_t)C * 4;
  return red + rows <= kGDefaultSmem ? red + rows : red;
}

// t [p_pad][ldt] then, from h_off (256-byte aligned), h [p_pad][ldh], in the
// products' operand type (bf16, or f32 in f32 I/O)
struct GeneralScratch {
  long long p_pad, ldt, ldh;
  size_t h_off, total;
};

inline GeneralScratch general_scratch(long long P, int C, int E, int elt) {
  GeneralScratch g;
  g.p_pad = round_up_ll(P, kGM);
  g.ldt = round_up_ll(C, kGLd);
  g.ldh = round_up_ll(E, kGLd);
  g.h_off = (size_t)round_up_ll(g.p_pad * g.ldt * elt, 256);
  g.total = g.h_off + (size_t)(g.p_pad * g.ldh * elt);
  return g;
}

// element i of x as the unit reads it: int8 codes as bf16(q * bf16(s_in))
template <typename T>
__device__ __forceinline__ float load_io(const T* __restrict__ x, size_t i,
                                         float s_in) {
  if constexpr (std::is_same<T, float>::value)
    return x[i];
  else if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(x[i]);
  else
    return __bfloat162float(__float2bfloat16_rn((float)x[i] * s_in));
}

// the sum of v over a pixel's G threads (a warp, or the block in warp
// order: the same bits on every launch)
template <int G>
__device__ __forceinline__ float group_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (G == 32) {
    return v;
  } else {
    __syncthreads();  // the last call's reads are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < G / 32; ++i) s += red[i];
    return s;
  }
}

// 1. t = LayerNorm(depthwise_KxK(x)) for pixel p of a group of G threads;
// rows p >= P of the scratch (the products' padding) are written as zeros,
// and so are the columns C .. ldt of every row. dw is [K * K][C] f32.
template <typename T, typename S, int G>
__global__ void __launch_bounds__(kGThreads)
    general_dwln_kernel(const T* __restrict__ x, S* __restrict__ t,
                        const float* __restrict__ dw,
                        const float* __restrict__ ln, int H, int W, int C,
                        int K, long long P, long long ldt, float s_in,
                        int cached) {
  extern __shared__ float gsm[];
  constexpr int PPB = kGThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const long long p = (long long)blockIdx.x * PPB + grp;
  S* trow = t + p * ldt;
  if (p >= P) {
    for (long long c = lane; c < ldt; c += G) trow[c] = bid::from_float<S>(0.f);
    return;
  }
  float* red = gsm;
  float* row = gsm + (G == kGThreads ? kGReduce / 4 : 0) + (size_t)grp * C;
  const int pad = K / 2;
  const long long hw = (long long)H * W;
  const int b = (int)(p / hw), rem = (int)(p % hw);
  const int y = rem / W, xx = rem % W;
  // the tap rows and columns inside the image
  const int dy0 = max(0, pad - y), dy1 = min(K, H + pad - y);
  const int dx0 = max(0, pad - xx), dx1 = min(K, W + pad - xx);
  // element (row y + dy - pad, column xx + dx - pad, channel c) of image b
  // is x[base + (dy * W + dx) * C + c]; only taps inside the image are read
  const long long base = (((long long)b * H + y - pad) * W + xx - pad) * C;
  auto dwsum = [&](int c) {
    float acc = 0.f;
    for (int dy = dy0; dy < dy1; ++dy) {
      const long long xr = base + (long long)dy * W * C + c;
      const float* wr = dw + (size_t)dy * K * C + c;
      for (int dx = dx0; dx < dx1; ++dx)
        acc = fmaf(load_io(x, (size_t)(xr + (long long)dx * C), s_in),
                   wr[(size_t)dx * C], acc);
    }
    return acc;
  };
  float s = 0.f;
  for (int c = lane; c < C; c += G) {
    const float v = dwsum(c);
    if (cached) row[c] = v;
    s += v;
  }
  const float mean = group_sum<G>(s, red) / (float)C;
  float ss = 0.f;
  for (int c = lane; c < C; c += G) {
    const float d = (cached ? row[c] : dwsum(c)) - mean;
    ss = fmaf(d, d, ss);
  }
  const float var = group_sum<G>(ss, red) / (float)C;
  const float rstd = rsqrtf(var + kLnEps);
  for (long long c = lane; c < ldt; c += G) {
    float v = 0.f;
    if (c < C)
      v = ((cached ? row[c] : dwsum((int)c)) - mean) * rstd * ln[c];
    trow[c] = bid::from_float<S>(v);
  }
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one stage's products of a warp's 32 x 32 outputs into part: A [kGM] rows
// and B [kGN] rows of kGRowBytes at kGRowPitch in shared memory
template <typename S>
__device__ __forceinline__ void general_stage_products(
    const unsigned char* sa, const unsigned char* sb, int wm, int wn,
    int lane, float (&part)[2][4][4]) {
  if constexpr (std::is_same<S, bf16>::value) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 15);
        const int col = ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(af[i], shared_address(sa + row * kGRowPitch + col * 2));
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int mi = lane >> 3;
        const int n = wn * 32 + (2 * jp + (mi >> 1)) * 8 + (lane & 7);
        const int col = ks * 16 + (mi & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, shared_address(sb + n * kGRowPitch + col * 2));
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(part[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  } else {
    constexpr int P4 = kGRowPitch / 4;  // floats a row
    const float* A = reinterpret_cast<const float*>(sa);
    const float* B = reinterpret_cast<const float*>(sb);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = ks * 8;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = wm * 32 + i * 16 + g;
        split_tf32_rn(A[r0 * P4 + kb + q], ab[i][0], as[i][0]);
        split_tf32_rn(A[(r0 + 8) * P4 + kb + q], ab[i][1], as[i][1]);
        split_tf32_rn(A[r0 * P4 + kb + q + 4], ab[i][2], as[i][2]);
        split_tf32_rn(A[(r0 + 8) * P4 + kb + q + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(B[n * P4 + kb + q], bb0, bs0);
        split_tf32(B[n * P4 + kb + q + 4], bb1, bs1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(part[i][j], as[i], bb0, bb1);
          mma_tf32(part[i][j], ab[i], bs0, bs1);
          mma_tf32(part[i][j], ab[i], bb0, bb1);
        }
      }
    }
  }
}

// 2. (kProject false) h = leaky(A B^T, slope) into the scratch [p_pad][ldh],
// every column below ldh (E .. ldh are zeros: B's masked rows);
// 3. (kProject true) out = x + gain * (A B^T) for the rows below P and the
// columns below N = C. A [p_pad][lda] is the scratch (t or h), B [N][Kd]
// the weights as they lie (W2 [E][C] or W3 [C][E]).
template <typename T, typename S, bool kProject>
__global__ void __launch_bounds__(kGThreads)
    general_gemm_kernel(const S* __restrict__ a, long long lda,
                        const S* __restrict__ bw, int N, int Kd,
                        S* __restrict__ h, long long ldh,
                        const T* __restrict__ x, T* __restrict__ out,
                        const float* __restrict__ gain, long long P,
                        float slope, float s_in, float inv_out) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  constexpr int V = 16 / (int)sizeof(S);       // elements a 16-byte copy
  constexpr int BK = kGRowBytes / (int)sizeof(S);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const long long m0 = (long long)blockIdx.x * kGM;
  const int n0 = blockIdx.y * kGN;
  const int nk = (Kd + BK - 1) / BK;

  auto load = [&](int s, int kt) {
    unsigned char* sa = gsmem + s * kGStageBytes;
    unsigned char* sb = sa + kGM * kGRowPitch;
    const int k0 = kt * BK;
    {  // A: kGM rows of 4 chunks, one a thread; the scratch is padded
      const int r = tid / 4, ch = tid % 4;
      cp_async_16n(shared_address(sa + r * kGRowPitch + ch * 16),
                   a + (m0 + r) * lda + k0 + ch * V, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: kGN rows of 4 chunks, two a thread
      const int idx = tid + i * kGThreads, r = idx / 4, ch = idx % 4;
      const int n = n0 + r, k = k0 + ch * V;
      unsigned char* dst = sb + r * kGRowPitch + ch * 16;
      bid::Vec16<S> v;
      v.raw = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) {
        const S* src = bw + (size_t)n * Kd + k;
        if (k + V <= Kd && (reinterpret_cast<size_t>(src) & 15) == 0) {
          cp_async_16n(shared_address(dst), src, 16);
          continue;
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (k + j < Kd) v[j] = src[j];
      }
      *reinterpret_cast<uint4*>(dst) = v.raw;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    const unsigned char* sa = gsmem + (kt & 1) * kGStageBytes;
    general_stage_products<S>(sa, sa + kGM * kGRowPitch, wm, wn, lane, part);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
    __syncthreads();
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long r = m0 + wm * 32 + i * 16 + g + hf * 8;
        const int c = n0 + wn * 32 + j * 8 + 2 * q;
        const float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
        if constexpr (!kProject) {
          if (c < ldh) {  // ldh and c are even
            S* dst = h + r * ldh + c;
            if constexpr (std::is_same<S, float>::value)
              *reinterpret_cast<float2*>(dst) =
                  make_float2(leaky(v0, slope), leaky(v1, slope));
            else
              *reinterpret_cast<uint32_t*>(dst) =
                  pack_bf16(leaky(v0, slope), leaky(v1, slope));
          }
        } else {
          if (r >= P) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = c + e;
            if (cc >= N) continue;
            const size_t idx = (size_t)r * N + cc;
            const float o = __fadd_rn(load_io(x, idx, s_in),
                                      __fmul_rn(gain[cc], e ? v1 : v0));
            if constexpr (std::is_same<T, float>::value)
              out[idx] = o;
            else if constexpr (std::is_same<T, bf16>::value)
              out[idx] = __float2bfloat16_rn(o);
            else
              out[idx] = quant_int8(o, inv_out);
          }
        }
      }
}

template <typename T>
using GeneralS =
    std::conditional_t<std::is_same<T, float>::value, float, bf16>;

template <typename T>
int launch_general_t(const void* x, void* out, const void* dw, const void* ln,
                     const void* w2, const void* w3, const void* gain,
                     void* scratch, long long scratch_bytes, int B, int H,
                     int W, int C, int K, int E, float slope, float s_in,
                     float inv_out, cudaStream_t st) {
  using S = GeneralS<T>;
  const long long P = (long long)B * H * W;
  if (P == 0) return 0;
  const GeneralScratch g = general_scratch(P, C, E, (int)sizeof(S));
  if (scratch == nullptr || scratch_bytes < (long long)g.total ||
      reinterpret_cast<size_t>(scratch) % 256)
    return BID_ERR_BAD_ARGUMENT;
  const int G = dwln_group(C);
  const long long blocks1 = g.p_pad / (kGThreads / G);
  const long long ntile_h = (g.ldh + kGN - 1) / kGN;
  if (blocks1 > INT_MAX || g.p_pad / kGM > INT_MAX || ntile_h > 65535 ||
      (C + kGN - 1) / kGN > 65535)
    return BID_ERR_UNSUPPORTED;
  S* t = static_cast<S*>(scratch);
  S* h = reinterpret_cast<S*>(static_cast<unsigned char*>(scratch) + g.h_off);
  const T* xt = static_cast<const T*>(x);
  const size_t smem1 = dwln_smem(C);
  const int cached = smem1 > (G == kGThreads ? kGReduce : 0);
  if (G == 32)
    general_dwln_kernel<T, S, 32><<<(unsigned)blocks1, kGThreads, smem1, st>>>(
        xt, t, static_cast<const float*>(dw), static_cast<const float*>(ln),
        H, W, C, K, P, g.ldt, s_in, cached);
  else
    general_dwln_kernel<T, S, kGThreads>
        <<<(unsigned)blocks1, kGThreads, smem1, st>>>(
            xt, t, static_cast<const float*>(dw),
            static_cast<const float*>(ln), H, W, C, K, P, g.ldt, s_in,
            cached);
  general_gemm_kernel<T, S, false>
      <<<dim3((unsigned)(g.p_pad / kGM), (unsigned)ntile_h), kGThreads,
         kGGemmSmem, st>>>(t, g.ldt, static_cast<const S*>(w2), E, C, h,
                           g.ldh, nullptr, nullptr, nullptr, P, slope, s_in,
                           inv_out);
  general_gemm_kernel<T, S, true>
      <<<dim3((unsigned)(g.p_pad / kGM), (unsigned)((C + kGN - 1) / kGN)),
         kGThreads, kGGemmSmem, st>>>(
          h, g.ldh, static_cast<const S*>(w3), C, E, nullptr, 0, xt,
          static_cast<T*>(out), static_cast<const float*>(gain), P, slope,
          s_in, inv_out);
  return (int)cudaGetLastError();
}

// one kernel's part of the route's info: the largest shared memory,
// registers and spill bytes, the fewest resident blocks
template <typename Kern>
int general_kernel_info(Kern kern, size_t smem, int* v) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kGThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  v[0] = std::max(v[0], (int)(smem + a.sharedSizeBytes));
  v[1] = std::max(v[1], a.numRegs);
  v[2] = std::max(v[2], (int)a.localSizeBytes);
  v[4] = std::min(v[4], blocks);
  return 0;
}

template <typename T>
int info_general_t(int C, int* v) {
  using S = GeneralS<T>;
  v[0] = v[1] = v[2] = 0;
  v[4] = INT_MAX;
  const size_t smem1 = dwln_smem(C);
  int rc = dwln_group(C) == 32
               ? general_kernel_info(general_dwln_kernel<T, S, 32>, smem1, v)
               : general_kernel_info(general_dwln_kernel<T, S, kGThreads>,
                                     smem1, v);
  if (rc == 0)
    rc = general_kernel_info(general_gemm_kernel<T, S, false>, kGGemmSmem, v);
  if (rc == 0)
    rc = general_kernel_info(general_gemm_kernel<T, S, true>, kGGemmSmem, v);
  if (rc != 0) return rc;
  v[3] = kGThreads;
  v[5] = 1;
  v[6] = v[4] * bid::sm_count();
  v[7] = C;
  v[8] = 0;
  return 0;
}

}  // namespace
