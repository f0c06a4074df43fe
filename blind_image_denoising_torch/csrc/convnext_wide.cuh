// K1's wide class: one ConvNext residual unit for 128 < C <= 256 (width
// CW = 256, convnext_wide.cu) at K = 1, 3, 5 or 7 (E = 4C), in every I/O
// mode, the true C a launch argument and the weights padded to CW by the
// wrapper (wider units run on a thread-block cluster,
// convnext_cluster.cuh).
// The design is noted in convnext_block.cuh (its last bullets); the helpers
// the class shares with the narrower layouts are there too, the weight
// ring of bulk copies multicast over a cluster of two blocks in
// chunk_ring.cuh. At C = 256 the unit does 1,024 operations a byte of bf16
// I/O, far above the card's ridge: it is bound by its products and by the
// weight stream (1.3 MB of chunks a tile of 64 pixels, each read once for
// the cluster's two blocks).
#pragma once

#include "convnext_block.cuh"

namespace {

template <typename T, int CW, int K_>
struct WCfg {
  using S = std::conditional_t<std::is_same<T, float>::value, float, bf16>;
  static constexpr int C = CW, K = K_, E = 4 * C, PAD = K_ / 2;
  static constexpr bool kRagged = true;
  static constexpr bool kMma = std::is_same<S, bf16>::value;
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr bool kStream = true;
  static_assert(CW == 256, "the one wide class; wider units: the cluster");
  // NQ warps share an m16 tile, CO = 128 output channels each: the
  // projection's accumulators of 16 pixels x CO channels are 64 registers
  // a lane; tiles of 8 x 8 pixels
  static constexpr int NQ = C / 128, CO = C / NQ;
  static constexpr int TH = 8, TW = 8, P = TH * TW, NT = 256;
  static_assert(P / 16 * NQ == NT / 32, "NQ warps an m16 tile");
  // E channels a streamed chunk: the NQ warps of an m16 tile expand 8 of
  // them each
  static constexpr int ECH = 16, NCH = E / ECH;
  // bf16 depthwise work items, as in Cfg
  static constexpr int R = 4, CG = C / 8, RUNS_W = TW / R;
  static constexpr int IH = TH + 2 * PAD, IW = TW + 2 * PAD;
  static constexpr int V = 16 / sizeof(S), VIO = 16 / sizeof(T);
  // the depthwise by groups of GC channels, one halo tile each: f32 (12 x
  // 12 x 256 f32 alone would be 147,456 B) and every mode where a whole-C
  // tile does not fit (K = 7); a thread owns 4 channels of RG neighbouring
  // pixels of a row
  static constexpr int GC = 64, NG = C / GC, RG = P * (GC / 4) / NT;
  static constexpr bool kGrouped = K == 7 || !kMma;
  // whole-C tile rows (bf16, int8 at K <= 5), unpadded and swizzled
  static constexpr bool kSwizzle = kMma;
  static constexpr int LDX = C;
  // rows of t, of a W2 chunk [ECH][C], a W3 chunk [C][ECH] and of the
  // warps' h blocks [16][ECH], padded by 16 bytes (bf16) or 4 floats; the
  // raw depthwise sums (grouped; f32 in t itself) [P][LDR]
  static constexpr int ROWPAD = kMma ? 8 : 4;
  static constexpr int LDT = C + ROWPAD, LDW2 = C + ROWPAD;
  static constexpr int LDW3 = ECH + ROWPAD, LDH = ECH + ROWPAD;
  static constexpr int LDR = C + 4;
  static constexpr size_t XBUF = sizeof(S) * IH * IW * LDX;
  static constexpr size_t W2_BYTES = align16(sizeof(S) * ECH * LDW2);
  static constexpr size_t W3_BYTES = align16(sizeof(S) * C * LDW3);
  static constexpr size_t WBUF = W2_BYTES + W3_BYTES;
  // the t tile; int8 (whole-C tiles) stages the next tile's codes in its
  // room
  static constexpr size_t T_ROWS = sizeof(S) * P * LDT;
  static constexpr size_t T_BYTES =
      align16(kInt8 && !kGrouped && IH * IW * C > T_ROWS ? IH * IW * C
                                                          : T_ROWS);
  // the warps' h blocks of every m16 tile, twice: chunk c hands its h over
  // in set c % 2, so that one chunk's writes wait for no reader of the last
  static constexpr size_t HB1 = sizeof(S) * 16 * LDH * (P / 16);
  static constexpr size_t H_BYTES = 2 * HB1;
  // ---- whole-C tiles: the small weights, the tile buffers, the ring, t,
  // h, the ring's barriers
  static constexpr size_t OFF_DW = 0;
  static constexpr size_t OFF_LN =
      kGrouped ? 0 : align16(OFF_DW + 4 * K * K * C);
  static constexpr size_t OFF_GN = align16(OFF_LN + 4 * C);
  static constexpr size_t OFF_X = align16(OFF_GN + 4 * C);
  // two tile buffers where they fit beside three stages; int8 one
  static constexpr int NXBUF =
      kInt8 ? 1
      : OFF_X + 2 * XBUF + 3 * WBUF + T_BYTES + H_BYTES + kRingBars <=
              kMaxSmem
          ? 2
          : 1;
  // ---- grouped: LN scale, gain, t, h, then a region U that holds the
  // ring while the products run and, before them, the raw f32 depthwise
  // sums (bf16, int8) and NGB group slots: the group's input [IH * IW][GC]
  // in the I/O type and its depthwise weights [K * K][GC]
  static constexpr size_t RAW_BYTES = kMma ? 4 * P * LDR : 0;
  static constexpr size_t GBUF = align16(sizeof(T) * IH * IW * GC);
  static constexpr size_t GSLOT = GBUF + 4 * K * K * GC;
  static constexpr size_t OFF_GT = OFF_X;             // grouped t
  static constexpr size_t OFF_GH = OFF_GT + T_BYTES;  // grouped h
  static constexpr size_t OFF_U = align16(OFF_GH + H_BYTES);
  // ---- the layout in use: as many stages as fit, up to kRingStages
  static constexpr size_t OFF_W2 =
      kGrouped ? OFF_U : align16(OFF_X + NXBUF * XBUF);
  static constexpr size_t ROOM =
      kMaxSmem - kRingBars - (kGrouped ? OFF_U : OFF_W2 + T_BYTES + H_BYTES);
  static constexpr int NS =
      ROOM / WBUF < (size_t)kRingStages ? (int)(ROOM / WBUF) : kRingStages;
  static constexpr int NGB = RAW_BYTES + 2 * GSLOT <= ROOM ? 2 : 1;
  static constexpr size_t U =
      NS * WBUF > RAW_BYTES + NGB * GSLOT ? NS * WBUF
                                          : RAW_BYTES + NGB * GSLOT;
  static constexpr size_t OFF_T = kGrouped ? OFF_GT : OFF_W2 + NS * WBUF;
  static constexpr size_t OFF_H = kGrouped ? OFF_GH : OFF_T + T_BYTES;
  static constexpr size_t OFF_BAR = kGrouped ? OFF_U + U : OFF_H + H_BYTES;
  static constexpr size_t SMEM = OFF_BAR + kRingBars;
  static constexpr int NCL = kRingCluster;
  static_assert(XBUF % 16 == 0 && WBUF % 16 == 0 && GSLOT % 16 == 0 &&
                    HB1 % 16 == 0,
                "16-byte alignment");
  static_assert(NS >= 3, "a ring of three stages or more");
  static_assert(SMEM <= kMaxSmem, "one block's shared memory fits");
  static_assert(kMma || ECH / 8 <= NQ, "a warp a chunk's n8 tile at most");

  static __device__ __forceinline__ int xoff(int ix, int chunk) {
    if constexpr (kSwizzle) chunk ^= ix & 7;
    return ix * LDX + chunk * V;
  }
};

// the NQ warps sharing m16 tile mt: named barrier 1 + mt of 32 NQ threads
template <typename G>
__device__ __forceinline__ void pair_sync(int mt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mt), "n"(32 * G::NQ)
               : "memory");
}

// the value the residual adds: x itself, or int8's bf16(q * bf16(scale_in))
__device__ __forceinline__ float residual(float v, float) { return v; }
__device__ __forceinline__ float residual(bf16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float residual(int8_t v, float s_in) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)v, s_in)));
}

// four neighbouring channels of a group tile as float32 (int8: dequantized
// as the whole-C tile is, bf16(q * bf16(scale_in)))
__device__ __forceinline__ float4 load4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p, float) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p, float s_in) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  return make_float4(residual((int8_t)q.x, s_in), residual((int8_t)q.y, s_in),
                     residual((int8_t)q.z, s_in), residual((int8_t)q.w, s_in));
}

// bf16 and int8, whole-C t in registers (CW = 256): this warp's half of a
// chunk's expansion (its NTW n8 tiles: E rows 8 NTW half .. of the chunk,
// from its A fragments af of t), leaky-ReLU'd and rounded to bf16 into the
// pair's h block hb [16][LDH]
template <typename G>
__device__ __forceinline__ void expand_half(const uint32_t (&af)[G::C / 16][4],
                                            bf16* __restrict__ hb,
                                            uint32_t w2, float slope,
                                            int half, int lane) {
  constexpr int NTW = G::ECH / 8 / G::NQ;
  // each n8 tile's 16 k16 steps in KS chains of their own (step kt in
  // chain kt % KS), added in order at the end: four chains of dependent
  // products in flight
  constexpr int KS = 4 / NTW;
  float hacc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    float part[KS][4];
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < G::C / 16; kt += 2) {
      uint32_t b[4];  // B fragments of two k16 steps
      ldmatrix_x4(b, w2 + 2 * ((NTW * half + nt) * 8 * G::LDW2 + kt * 16));
      mma_bf16(part[kt % KS], af[kt], b[0], b[1]);
      mma_bf16(part[(kt + 1) % KS], af[kt + 1], b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hacc[nt][i] = part[0][i];
#pragma unroll
      for (int j = 1; j < KS; ++j) hacc[nt][i] += part[j][i];
    }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int e = 8 * (NTW * half + nt) + 2 * q;
    *reinterpret_cast<uint32_t*>(hb + g * G::LDH + e) =
        pack_bf16(leaky(hacc[nt][0], slope), leaky(hacc[nt][1], slope));
    *reinterpret_cast<uint32_t*>(hb + (g + 8) * G::LDH + e) =
        pack_bf16(leaky(hacc[nt][2], slope), leaky(hacc[nt][3], slope));
  }
}

// bf16 and int8: the chunk's h (A fragments from the warps' block, h_lane:
// this lane's ldmatrix row) onto the warp's CO output channels
template <typename G>
__device__ __forceinline__ void project_half(float (&pacc)[G::CO / 8][4],
                                             uint32_t h_lane, uint32_t w3,
                                             int part) {
  constexpr int KS = G::ECH / 16;  // k16 steps a chunk
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], h_lane + 2 * 16 * kk);
#pragma unroll
  for (int nt = 0; nt < G::CO / 8; nt += 2) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];  // B fragments of two n8 groups
      ldmatrix_x4(b, w3 + 2 * ((G::CO * part + nt * 8) * G::LDW3 + kk * 16));
      mma_bf16(pacc[nt], a[kk], b[0], b[1]);
      mma_bf16(pacc[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// bf16 and int8: out = x + gain * p of the warp's CO channels of the 16
// pixels at m0, x read back from device memory, staged in those rows of the
// t tile (int8: requantized codes at the row's start) and stored in units of
// `unit` bytes, the true cr channels only
template <typename G, typename T>
__device__ __forceinline__ void store_wide_rows(
    const T* __restrict__ x, bf16* __restrict__ ts,
    const float (&pacc)[G::CO / 8][4], const float* __restrict__ gns,
    T* __restrict__ out, Tile t, int H, int W, float s_in, float inv_out,
    int m0, int half, int lane, int cr, int unit) {
  constexpr int CH = G::CO;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < CH / 8; ++nt) {
    const int c = CH * half + nt * 8 + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + g + 8 * hf;
      const int gy = t.y0 + m / G::TW, gx = t.x0 + m % G::TW;
      float x0 = 0.f, x1 = 0.f;
      if (gy < H && gx < W) {
        const long long base = ((t.b * H + gy) * W + gx) * cr;
        if (c < cr) x0 = residual(x[base + c], s_in);
        if (c + 1 < cr) x1 = residual(x[base + c + 1], s_in);
      }
      const float o0 = __fadd_rn(x0, __fmul_rn(gns[c], pacc[nt][2 * hf]));
      const float o1 =
          __fadd_rn(x1, __fmul_rn(gns[c + 1], pacc[nt][2 * hf + 1]));
      if constexpr (G::kInt8) {
        char2 qv;
        qv.x = quant_int8(o0, inv_out);
        qv.y = quant_int8(o1, inv_out);
        *reinterpret_cast<char2*>(
            reinterpret_cast<signed char*>(ts + m * G::LDT) + c) = qv;
      } else {
        *reinterpret_cast<uint32_t*>(ts + m * G::LDT + c) = pack_bf16(o0, o1);
      }
    }
  }
  __syncwarp();
  const int b0 = CH * half * (int)sizeof(T);
  const int b1 = min(CH * (half + 1), cr) * (int)sizeof(T);
  if (b1 <= b0) return;
  // lane i's copies are (row, unit) i, i + 32, ..., stepped without division
  const int nu = (b1 - b0) / unit, dm = 32 / nu, du = 32 % nu;
  unsigned char* ob = reinterpret_cast<unsigned char*>(out);
  int m = m0 + lane / nu, u = lane % nu;
  for (int i = lane; i < 16 * nu; i += 32) {
    const int gy = t.y0 + m / G::TW, gx = t.x0 + m % G::TW;
    const int j = b0 + u * unit;
    if (gy < H && gx < W)
      store_unit(ob + ((t.b * H + gy) * W + gx) * cr * (long long)sizeof(T) + j,
                 reinterpret_cast<const unsigned char*>(ts + m * G::LDT) + j,
                 unit);
    m += dm;
    u += du;
    if (u >= nu) u -= nu, ++m;
  }
}

// Start the copies of channel group grp of a tile plus halo into the group
// buffer dst [IH * IW][GC] of T, zero outside the image and past cr; when
// dw is given (grouped), the group's depthwise weights [K * K][GC] follow
// the buffer, from the wrapper's [CW][K * K]
template <typename G, typename T>
__device__ __forceinline__ void load_group_async(
    const T* __restrict__ x, const float* __restrict__ dw, unsigned char* dst,
    Tile t, int grp, int H, int W, int tid, int cr, int unit) {
  constexpr int SZ = (int)sizeof(T);
  // copies per pixel of a group: a power of two
  const int upp = G::GC * SZ / unit, ush = __ffs(upp) - 1;
  const uint32_t d0 = shared_address(dst);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  for (int i = tid; i < G::IH * G::IW * upp; i += G::NT) {
    const int pix = i >> ush, j = i & (upp - 1);
    const int iy = pix / G::IW, ix = pix - iy * G::IW;
    const int gy = t.y0 - G::PAD + iy, gx = t.x0 - G::PAD + ix;
    const int c = grp * G::GC + j * unit / SZ;
    const bool inside = c < cr && (unsigned)gy < (unsigned)H &&
                        (unsigned)gx < (unsigned)W;
    const long long src =
        inside ? (((t.b * H + gy) * W + gx) * cr + c) * (long long)SZ : 0;
    const int d = pix * G::GC * SZ + j * unit;
    copy_unit(dst + d, d0 + d, xb + src, inside, unit);
  }
  if (dw != nullptr) {
    constexpr int KK = G::K * G::K;
    const uint32_t w0 = d0 + (uint32_t)G::GBUF;
    for (int i = tid; i < KK * G::GC; i += G::NT) {
      const int tap = i / G::GC, j = i - tap * G::GC;
      copy_unit(dst + G::GBUF + 4 * i, w0 + 4 * i,
                reinterpret_cast<const unsigned char*>(
                    dw + (grp * G::GC + j) * KK + tap),
                true, 4);
    }
  }
  cp_async_commit();
}

// The depthwise KxK sums of channel group grp for the whole tile, raw,
// into out [P][LDR] at channel c0 of the group: a thread owns 4 channels of
// RG neighbouring pixels of a row, loads each tap row's K weight and
// RG + K - 1 input vectors once and sums from registers, taps in (dy, dx)
// order per output. xs: the group tile [IH * IW][GC] of T; dw: the group's
// first channel of the weights [K * K][dw_ld]
template <typename G, typename T>
__device__ __forceinline__ void depthwise_group(
    const T* __restrict__ xs, const float* __restrict__ dw, int dw_ld,
    float* __restrict__ out, int c0, int tid, float s_in) {
  constexpr int K = G::K, RG = G::RG, GC = G::GC;
  static_assert(G::TH * (G::TW / RG) * (GC / 4) == G::NT, "an item a thread");
  const int cq = tid % (GC / 4), run = tid / (GC / 4);
  const int ry = run / (G::TW / RG), rx = run % (G::TW / RG) * RG;
  float4 acc[RG];
#pragma unroll
  for (int j = 0; j < RG; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto tap_row = [&](int dy) {
    const T* row = xs + ((ry + dy) * G::IW + rx) * GC + 4 * cq;
    float4 w[K];
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      w[dx] = *reinterpret_cast<const float4*>(dw + (dy * K + dx) * dw_ld +
                                               4 * cq);
#pragma unroll
    for (int i = 0; i < RG + K - 1; ++i) {
      const float4 v = load4(row + i * GC, s_in);
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int j = i - dx;  // the output pixel this tap feeds
        if (j >= 0 && j < RG) {
          acc[j].x = fmaf(v.x, w[dx].x, acc[j].x);
          acc[j].y = fmaf(v.y, w[dx].y, acc[j].y);
          acc[j].z = fmaf(v.z, w[dx].z, acc[j].z);
          acc[j].w = fmaf(v.w, w[dx].w, acc[j].w);
        }
      }
    }
  };
  if constexpr (K >= 7) {
    // the rows not unrolled into each other: K = 7's 49 taps unrolled
    // whole spill the int8 tile's dequantized inputs
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) tap_row(dy);
  } else {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) tap_row(dy);
  }
#pragma unroll
  for (int j = 0; j < RG; ++j)
    *reinterpret_cast<float4*>(out + (ry * G::TW + rx + j) * G::LDR + c0 +
                               4 * cq) = acc[j];
}

// The LayerNorm of the raw sums [P][LDR] into t [P][LDT] (f32: in place, a
// warp a pixel): mean and centred variance (two passes, f32) over the true
// cr channels, the padded ones masked; t = centred * rs * scale, rounded to
// t's type
template <typename G, typename S>
__device__ __forceinline__ void layernorm_rows(
    const float* raw, S* t, const float* __restrict__ lns, int cr,
    float inv_c, int warp, int lane) {
  constexpr int NV = G::C / 32;
  for (int p = warp; p < G::P; p += G::NT / 32) {
    const float* row = raw + p * G::LDR;
    float v[NV];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = row[lane + 32 * j];
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = lane + 32 * j < cr ? v[j] - mean : 0.f;
      sq = fmaf(v[j], v[j], sq);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rs = rsqrtf(sq * inv_c + kLnEps);
    S* out = t + p * G::LDT;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      out[lane + 32 * j] = bid::from_float<S>(v[j] * rs * lns[lane + 32 * j]);
  }
}

// f32: this warp's n8 tile of a chunk's expansion (E rows 8 half .. + 7 of
// the chunk) in 3xTF32 from t in shared memory, the k steps over four
// accumulators (so that the products' chains interleave), leaky-ReLU'd into
// the warps' h block hb [16][LDH]
template <typename G>
__device__ __forceinline__ void expand_half_f32(const float* __restrict__ ts,
                                                const float* __restrict__ w2c,
                                                float* __restrict__ hb,
                                                float slope, int mt, int half,
                                                int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* a0 = ts + (16 * mt + g) * G::LDT + q;  // row g; + 8 rows
  const float* bp = w2c + (8 * half + g) * G::LDW2 + q;
  float h[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) h[s][r] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < G::C; k0 += 32) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = k0 + 8 * s;
      uint32_t ab[4], as[4], bb[2], bs[2];
      split_a(a0[k], a0[8 * G::LDT + k], a0[k + 4], a0[8 * G::LDT + k + 4],
              ab, as);
      split_tf32(bp[k], bb[0], bs[0]);
      split_tf32(bp[k + 4], bb[1], bs[1]);
      mma_tf32(h[s], as, bb[0], bb[1]);
      mma_tf32(h[s], ab, bs[0], bs[1]);
      mma_tf32(h[s], ab, bb[0], bb[1]);
    }
  }
  float v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = (h[0][r] + h[1][r]) + (h[2][r] + h[3][r]);
  const int e = 8 * half + 2 * q;
  *reinterpret_cast<float2*>(hb + g * G::LDH + e) =
      make_float2(leaky(v[0], slope), leaky(v[1], slope));
  *reinterpret_cast<float2*>(hb + (g + 8) * G::LDH + e) =
      make_float2(leaky(v[2], slope), leaky(v[3], slope));
}

// f32: the chunk's h (A fragments from the warps' block) onto the warp's
// CO output channels in 3xTF32
template <typename G>
__device__ __forceinline__ void project_half_f32(float (&pacc)[G::CO / 8][4],
                                                 const float* __restrict__ hb,
                                                 const float* __restrict__ w3c,
                                                 int part, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < G::ECH / 8; ++kk) {
    const float* a0 = hb + g * G::LDH + 8 * kk + q;
    uint32_t ab[4], as[4];
    split_a(a0[0], a0[8 * G::LDH], a0[4], a0[8 * G::LDH + 4], ab, as);
#pragma unroll
    for (int o = 0; o < G::CO / 8; ++o) {
      const float* bp =
          w3c + (G::CO * part + 8 * o + g) * G::LDW3 + 8 * kk + q;
      uint32_t bb[2], bs[2];
      split_tf32(bp[0], bb[0], bs[0]);
      split_tf32(bp[4], bb[1], bs[1]);
      mma_tf32(pacc[o], as, bb[0], bb[1]);
      mma_tf32(pacc[o], ab, bs[0], bs[1]);
      mma_tf32(pacc[o], ab, bb[0], bb[1]);
    }
  }
}

// f32: out = x + gain * p of the warp's CO channels of the 16 pixels at
// m0, one float at a time, the true cr channels only
template <typename G>
__device__ __forceinline__ void store_wide_f32(
    const float* __restrict__ x, const float (&pacc)[G::CO / 8][4],
    const float* __restrict__ gns, float* __restrict__ out, Tile t, int H,
    int W, int m0, int part, int lane, int cr) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int o = 0; o < G::CO / 8; ++o) {
    const int c = G::CO * part + 8 * o + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + g + 8 * hf;
      const int gy = t.y0 + m / G::TW, gx = t.x0 + m % G::TW;
      if (gy < H && gx < W) {
        const long long base = ((t.b * H + gy) * W + gx) * cr;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (c + r < cr)
            out[base + c + r] = __fadd_rn(
                __ldg(x + base + c + r),
                __fmul_rn(gns[c + r], pacc[o][2 * hf + r]));
      }
    }
  }
}

// Both 1x1 products of the warp's m16 tile mt (its CO channels `part`)
// over round `round`'s E chunks of the ring (thread 0 issues them from
// `chunks`, below limit), then the epilogue. t is whole in ts. Of each
// chunk the warps of the m16 tile expand their n8 tiles into the h set of
// the chunk's parity and, past their named barrier, project the whole
// chunk's h. bf16 and int8 take their A fragments of t into registers.
template <typename G, typename T>
__device__ __forceinline__ void wide_products_store(
    const T* __restrict__ x, int round, int limit, const void* chunks,
    unsigned char* smem, typename G::S* ts,
    const float* __restrict__ gns,
    T* __restrict__ out, Tile t, int H, int W, float slope, float s_in,
    float inv_out, int tid, int cr, int unit) {
  using S = typename G::S;
  constexpr int C = G::C;
  const int warp = tid >> 5, lane = tid & 31;
  const int mt = warp / G::NQ, part = warp % G::NQ;
  const unsigned char* ring = smem + G::OFF_W2;
  // the warps' h block of m16 tile mt in set 0; set 1 HB1 bytes on
  S* hb0 = reinterpret_cast<S*>(smem + G::OFF_H) + mt * 16 * G::LDH;
  auto hb = [&](int par) {
    return reinterpret_cast<S*>(reinterpret_cast<unsigned char*>(hb0) +
                                par * G::HB1);
  };
  float pacc[G::CO / 8][4];
#pragma unroll
  for (int nt = 0; nt < G::CO / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
  if constexpr (G::kMma) {
    const LaneRows<G> rows(ts, reinterpret_cast<const bf16*>(ring),
                           reinterpret_cast<const bf16*>(ring + G::W2_BYTES),
                           lane);
    const uint32_t h_lane = shared_address(
        hb0 + ((lane & 7) + ((lane >> 3) & 1) * 8) * G::LDH + (lane >> 4) * 8);
    uint32_t af[C / 16][4];
    load_a<G>(af, rows.a, 16 * mt);
    StreamedWeights<G>::walk(smem, round, limit, tid, chunks,
                             [&](uint32_t b, int par) {
      expand_half<G>(af, hb(par), rows.w2 + b, slope, part, lane);
      pair_sync<G>(mt);
      project_half<G>(pacc, h_lane + (uint32_t)(par * G::HB1), rows.w3 + b,
                      part);
    });
    store_wide_rows<G, T>(x, ts, pacc, gns, out, t, H, W, s_in, inv_out,
                          16 * mt, part, lane, cr, unit);
  } else {
    StreamedWeights<G>::walk(smem, round, limit, tid, chunks,
                             [&](uint32_t b, int par) {
      const float* w2c = reinterpret_cast<const float*>(ring + b);
      // a chunk has ECH / 8 n8 tiles, one a warp of the pair
      if (part < G::ECH / 8)
        expand_half_f32<G>(ts, w2c, hb(par), slope, mt, part, lane);
      pair_sync<G>(mt);
      project_half_f32<G>(pacc, hb(par), w2c + G::W2_BYTES / 4, part, lane);
    });
    store_wide_f32<G>(x, pacc, gns, out, t, H, W, 16 * mt, part, lane, cr);
  }
}

template <typename T, int CW, int K>
__global__ void __launch_bounds__(256, 1)
convnext_wide_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const float* __restrict__ dw,
                     const float* __restrict__ ln,
                     const typename WCfg<T, CW, K>::S* __restrict__ w2,
                     const typename WCfg<T, CW, K>::S* __restrict__ w3,
                     const float* __restrict__ gain, int B, int H, int W,
                     int cr, float inv_cr, float slope, float s_in,
                     float inv_out) {
  using G = WCfg<T, CW, K>;
  using S = typename G::S;
  constexpr int C = G::C, NT = G::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dws = reinterpret_cast<float*>(smem + G::OFF_DW);
  float* lns = reinterpret_cast<float*>(smem + G::OFF_LN);
  float* gns = reinterpret_cast<float*>(smem + G::OFF_GN);
  S* ts = reinterpret_cast<S*>(smem + G::OFF_T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit = io_unit<T>(cr);

  const TileWalk<G> walk(B, H, W);
  auto xbuf = [&](int b) { return smem + G::OFF_X + b * G::XBUF; };
  // the ring, its barriers ready in every block of the cluster before any
  // block's copies or releases reach them
  using SW = StreamedWeights<G>;
  SW::init(smem, tid);
  bid_ring::sync_cluster<G::NCL>();

  if constexpr (G::kGrouped) {
    // ---- the depthwise by channel groups, each group's input and
    // weights in a slot of U; the raw sums to t (f32) or to U's head
    // (bf16, int8), then the LayerNorm into t; then the ring takes U for
    // the tile's chunks
    unsigned char* const u = smem + G::OFF_U;
    float* raw = G::kMma ? reinterpret_cast<float*>(u)
                         : reinterpret_cast<float*>(ts);
    auto slot = [&](int b) { return u + G::RAW_BYTES + b * G::GSLOT; };
    load_group_async<G>(x, dw, slot(0), walk.at(0, B, H, W), 0, H, W, tid, cr,
                        unit);
    for (int c = tid; c < C; c += NT) {
      lns[c] = ln[c];
      gns[c] = gain[c];
    }
    for (int round = 0; round < walk.rounds; ++round) {
      const Tile t = walk.at(round, B, H, W);
#pragma unroll 1
      for (int grp = 0; grp < G::NG; ++grp) {
        cp_async_wait_all();
        __syncthreads();
        if constexpr (G::NGB == 2) {
          if (grp + 1 < G::NG)
            load_group_async<G>(x, dw, slot((grp + 1) & 1), t, grp + 1, H, W,
                                tid, cr, unit);
        }
        unsigned char* sl = slot(G::NGB == 2 ? grp & 1 : 0);
        depthwise_group<G>(reinterpret_cast<const T*>(sl),
                           reinterpret_cast<const float*>(sl + G::GBUF),
                           G::GC, raw, grp * G::GC, tid, s_in);
        if constexpr (G::NGB == 1) {
          if (grp + 1 < G::NG) {
            __syncthreads();  // the only slot is free again
            load_group_async<G>(x, dw, slot(0), t, grp + 1, H, W, tid, cr,
                                unit);
          }
        }
      }
      __syncthreads();
      layernorm_rows<G>(raw, ts, lns, cr, inv_cr, warp, lane);
      // t is whole, and every block of the cluster is past its U: the
      // ring takes it for this tile's chunks
      bid_ring::sync_cluster<G::NCL>();
      SW::prime(smem, round, (round + 1) * G::NCH, tid, w2);
      wide_products_store<G, T>(x, round, (round + 1) * G::NCH, w2, smem, ts,
                                gns, out, t, H, W, slope, s_in, inv_out, tid,
                                cr, unit);
      if (round + 1 < walk.rounds) {
        __syncthreads();  // every warp is done with the ring and t
        load_group_async<G>(x, dw, slot(0), walk.at(round + 1, B, H, W), 0,
                            H, W, tid, cr, unit);
      }
    }
  } else {
    // ---- whole-C tiles (bf16, int8 at K <= 5): the first tile (int8: its
    // codes, in the t tile's room), then the first chunks; the chunks run
    // on from tile to tile
    load_tile_async<G>(x, G::kInt8 ? reinterpret_cast<unsigned char*>(ts)
                                   : xbuf(0),
                       walk.at(0, B, H, W), H, W, tid, cr, unit);
    SW::prime(smem, 0, walk.rounds * G::NCH, tid, w2);

    // ---- the small weights, once per block, while those are on their way
    for (int i = tid; i < C * K * K; i += NT) {
      const int c = i / (K * K), tap = i % (K * K);
      dws[((tap * 2 + c % 8 / 4) * G::CG + c / 8) * 4 + c % 4] = dw[i];
    }
    for (int c = tid; c < C; c += NT) {
      lns[c] = ln[c];
      gns[c] = gain[c];
    }

    int buf = 0;
    for (int round = 0; round < walk.rounds; ++round) {
      const Tile t = walk.at(round, B, H, W);
      const bool more = round + 1 < walk.rounds;
      bf16* xs = reinterpret_cast<bf16*>(xbuf(buf));
      cp_async_wait_all();
      // this tile (or its codes) has landed and the weights are staged;
      // every warp is done with the previous tile
      __syncthreads();
      if constexpr (G::kInt8) {
        dequantize_tile<G>(reinterpret_cast<unsigned char*>(ts), xs, s_in,
                           tid);
        __syncthreads();
      }
      if constexpr (G::NXBUF == 2) {
        buf ^= 1;
        if (more)
          load_tile_async<G>(x, xbuf(buf), walk.at(round + 1, B, H, W), H, W,
                             tid, cr, unit);
      }
      depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, inv_cr);
      __syncthreads();
      if constexpr (!G::kInt8 && G::NXBUF == 1) {
        // every depthwise is done: the only tile buffer takes the next
        // tile (the residual is read from device memory)
        if (more)
          load_tile_async<G>(x, xbuf(0), walk.at(round + 1, B, H, W), H, W, tid,
                             cr, unit);
      }
      wide_products_store<G, T>(x, round, walk.rounds * G::NCH, w2, smem,
                                ts, gns, out, t, H, W, slope, s_in, inv_out,
                                tid, cr, unit);
      if constexpr (G::kInt8) {
        if (more) {
          __syncthreads();  // every epilogue is done with the t tile
          load_tile_async<G>(x, reinterpret_cast<unsigned char*>(ts),
                             walk.at(round + 1, B, H, W), H, W, tid, cr, unit);
        }
      }
    }
  }
  // no block leaves while the cluster's others may still arrive on its
  // barriers
  bid_ring::sync_cluster<G::NCL>();
}

template <typename T, int CW, int K>
int launch_t(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int cr, float slope, float s_in, float inv_out,
             cudaStream_t s) {
  return launch_kernel<WCfg<T, CW, K>, T>(convnext_wide_kernel<T, CW, K>, x,
                                          out, dw, ln, w2, w3, gain, B, H, W,
                                          cr, slope, s_in, inv_out, s);
}

template <typename T, int CW>
int dispatch_wide(const void* x, void* out, const void* dw, const void* ln,
                  const void* w2, const void* w3, const void* gain, int B,
                  int H, int W, int C, int K, float slope, float s_in,
                  float inv_out, cudaStream_t s) {
#define BID_WIDE(KK)                                                      \
  if (K == KK)                                                            \
    return launch_t<T, CW, KK>(x, out, dw, ln, w2, w3, gain, B, H, W, C,  \
                               slope, s_in, inv_out, s);
  BID_WIDE(1)
  BID_WIDE(3)
  BID_WIDE(5)
  BID_WIDE(7)
#undef BID_WIDE
  return BID_ERR_UNSUPPORTED;
}

template <typename T, int CW>
int dispatch_wide_info(int K, int* v) {
#define BID_WIDE_INFO(KK) \
  if (K == KK)            \
    return kernel_info<WCfg<T, CW, KK>>(convnext_wide_kernel<T, CW, KK>, v);
  BID_WIDE_INFO(1)
  BID_WIDE_INFO(3)
  BID_WIDE_INFO(5)
  BID_WIDE_INFO(7)
#undef BID_WIDE_INFO
  return BID_ERR_UNSUPPORTED;
}

// by dtype code (0 float32, 1 bfloat16, 2 int8)
template <int CW>
int launch_wide_class(int dtype, const void* x, void* out, const void* dw,
                      const void* ln, const void* w2, const void* w3,
                      const void* gain, int B, int H, int W, int C, int K,
                      float slope, float s_in, float inv_out,
                      cudaStream_t s) {
  if (C <= CW / 2 || C > CW) return BID_ERR_UNSUPPORTED;
  if (dtype == 0)
    return dispatch_wide<float, CW>(x, out, dw, ln, w2, w3, gain, B, H, W, C,
                                    K, slope, s_in, inv_out, s);
  if (dtype == 1)
    return dispatch_wide<bf16, CW>(x, out, dw, ln, w2, w3, gain, B, H, W, C,
                                   K, slope, s_in, inv_out, s);
  if (dtype == 2)
    return dispatch_wide<int8_t, CW>(x, out, dw, ln, w2, w3, gain, B, H, W,
                                     C, K, slope, s_in, inv_out, s);
  return BID_ERR_UNSUPPORTED;
}

template <int CW>
int info_wide_class(int dtype, int C, int K, int* v) {
  if (C <= CW / 2 || C > CW) return BID_ERR_UNSUPPORTED;
  if (dtype == 0) return dispatch_wide_info<float, CW>(K, v);
  if (dtype == 1) return dispatch_wide_info<bf16, CW>(K, v);
  if (dtype == 2) return dispatch_wide_info<int8_t, CW>(K, v);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace
