// K1 on a thread-block cluster, in every I/O mode (convnext_cluster.cu
// bf16, convnext_cluster_int8.cu int8, convnext_cluster_f32.cu float32).
// The kernel takes every C from 129 to 1024; convnext_block.cu sends it
// every C from 257 on (at C = 256 the one-block class of
// convnext_wide.cuh measured faster, PERF.md §6). Above C = 256 the unit
// does 1,024 to 4,096 operations a byte of bf16 I/O: it is bound by its
// two products and by how often W2 and W3 (up to 16 MB in bf16, 32 MB in
// float32) are read for each pixel. Design:
// * a cluster of n = ceil(C / 128) blocks (up to 8, the portable cluster
//   size; cudaLaunchKernelEx with a cluster attribute) owns one tile of 64
//   pixels (8 x 8; float32 32, 4 x 8) at a time (persistent: the cluster
//   walks over tiles).
//   The channels are padded to C' = 128 n (the wrapper pads the weights
//   with zeros to C'), and block r owns output channels [128 r, 128 r +
//   128) and E channels [512 r, 512 r + 512). No sum crosses blocks but the
//   LayerNorm statistics', taken in rank order, so two launches give the
//   same bits;
// * depthwise and LayerNorm, split over the cluster: block r copies the
//   tile's halo of its 128 channels into t's room (cp.async) and sums the
//   K x K depthwise into registers (a warp a run of 4 pixels of a row, a
//   lane 4 channels; the weights transposed by the wrapper to [K * K][C'],
//   int8 codes dequantized as bf16(q * bf16(scale_in)) as they are read).
//   A pixel's part of the sum over the block's channels is a warp sum;
//   after a cluster barrier lane l reads block l's part through
//   distributed shared memory (DSMEM) and the parts add in rank order: the
//   mean; the same for the centred squares: the variance (two passes, f32,
//   over the true C). Each block writes its slice of t (bf16) into the t
//   tile of every block (DSMEM stores), so each holds the whole t [64][C'];
// * the expansion, once a tile: warp w owns E columns [64 w, 64 w + 64) of
//   the block's 512 over all four m16 tiles, its accumulators 4 x 8 n8
//   tiles (128 registers), and W2's rows of the block's slice stream by
//   columns of t, KC of them an item [512][KC + 8]: a W2 fragment serves
//   four m16 tiles and a t fragment eight n8 tiles (the ldmatrix bytes a
//   product are a quarter of a chunked expansion's, which re-read t for
//   every E chunk). h, leaky-ReLU'd and rounded to bf16, takes t's room in
//   "fragment order" (a lane's A fragment of a k16 step is 16 contiguous
//   bytes);
// * the projection, after one cluster barrier: warp (m16 tile, 64 output
//   channels) reads block rr's h through DSMEM with 16-byte loads and
//   accumulates it against W3's rows of its channels, which stream by KC3
//   of block rr's E columns an item [128][KC3 + 8]; a cluster barrier ends
//   the tile (the next tile's halo overwrites h);
// * W2's and W3's items share one ring of three slots fed by 16-byte
//   cp.async, each slot an mbarrier the copies arrive on
//   (cp.async.mbarrier.arrive.noinc): a tile's NA = C' / KC W2 items,
//   then its NB = n 512 / KC3 W3 items, then the next tile's, two items
//   in flight behind the one in use, across the phases and the tiles. KC =
//   32, KC3 = 128 for n <= 4 (slots of 40,960 B; C' = 512: 189,984 B in
//   all), KC = 16, KC3 = 64 above (C' = 1024: 206,368 B);
// * float32 keeps t, h and the weights in float32 and runs both products
//   as error-compensated 3xTF32 on m16n8k8 (each operand split into a
//   TF32 big part and the rest; small.big, big.small, then big.big, as
//   convnext_block.cuh's float32 layouts). Its t tile of 64 pixels would
//   be 264,192 B at C' = 1024, so its tiles are 32 pixels (4 x 8; a warp
//   64 E columns over two m16 tiles, the projection a warp an m16 tile and
//   32 output channels), its ring two slots of a W2 item [512][16 + 8] or
//   a W3 item [128][64 + 8] (49,152 B each): C' = 1024 takes 230,688 B of
//   the 232,448. A k8 step's columns are taken in the order 0, 2, 4, 6 |
//   1, 3, 5, 7, the same in A and B, so that a lane's A and B fragments
//   are float2 loads (rows padded by 8 floats: a half-warp's on distinct
//   banks) and the expansion's accumulators of an n8 tile, as c0, c2, c1,
//   c3, are the projection's A fragment of that k8 step, kept in
//   fragment order (16 bytes a lane). Each item's products sum into
//   accumulators of their own, added to the running sums with __fadd_rn
//   (add_rn);
// * the rounding points are the plain version's: t, h and the weights in
//   bf16 (float32: in float32), f32 sums, x + gain * p in f32 with
//   __fadd_rn and __fmul_rn; int8 requantizes with f32(1 / scale_out), half
//   to even, clamped to +-127. The output is stored from the accumulators,
//   the true C channels only.
#pragma once

#include <cooperative_groups.h>

#include "convnext_block.cuh"

namespace {

namespace cg = cooperative_groups;

// output channels of one block of a cluster, and the most blocks a cluster
constexpr int kSlice = 128;
constexpr int kMaxCluster = 8;

// I/O type T, depthwise K; tiles of M = 16 MT pixels, NW warps; the ring's
// S slots hold a W2 item [512][KC + 8] (the block's 512 E rows, KC of
// the C' columns) or a W3 item [128][KC3 + 8] (its 128 output rows, KC3
// of one block's 512 E columns)
template <typename T, int K_, int MT_, int NW_, int KC_, int KC3_, int S_>
struct CCfg {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // float32: t, h and the weights in float32, the products 3xTF32 on
  // m16n8k8; else in bf16 on m16n8k16
  static constexpr bool kF32 = std::is_same<T, float>::value;
  using S = std::conditional_t<kF32, float, bf16>;
  // bytes of an element of S, elements of a 16-byte vector, k of a product
  static constexpr int SB = (int)sizeof(S), VE = 16 / SB;
  static constexpr int KSTEP = kF32 ? 8 : 16;
  static constexpr int K = K_, PAD = K_ / 2;
  static constexpr int MT = MT_, M = 16 * MT_, NW = NW_, NT = 32 * NW_;
  static constexpr int CS = kSlice, ES = 4 * kSlice;
  // expansion: warp w owns E columns [EW w, EW w + EW) of the block's ES
  // over all MT m16 tiles (ENA n8 tiles of them)
  static constexpr int EW = ES / NW, ENA = EW / 8;
  // projection: warp w owns MB m16 tiles and CO output channels (the
  // NW / (MT / MB) warps of a tile group split the 128; two m16 tiles a
  // warp halve the W3 reads but double the DSMEM reads of h, which cost
  // more: PERF.md §6)
  static constexpr int MB = 1, CO = CS * MT / MB / NW;
  static constexpr int KC = KC_, KC3 = KC3_, NSLOT = S_;
  static constexpr int LDA = KC + 8, LD3 = KC3 + 8;
  static constexpr int SLOT = (ES * LDA > CS * LD3 ? ES * LDA : CS * LD3) * SB;
  // W3 items a block's E slice; h's k steps an m16 tile
  static constexpr int JB = ES / KC3, HK = ES / KSTEP;
  static constexpr int TW = 8, TH = M / TW;
  // runs of 4 pixels of a row a warp (depthwise and LayerNorm), the halo
  // tile and its bytes of the block's 128 channels
  static constexpr int RPW = TH * (TW / 4) / NW;
  static constexpr int IH = TH + 2 * PAD, IW = TW + 2 * PAD;
  static constexpr int HALO_BYTES = IH * IW * CS * (int)sizeof(T);
  static_assert(MT % MB == 0 && CO % 16 == 0 && ENA % 2 == 0,
                "whole n8 pairs a warp");
  static_assert(KC % KSTEP == 0 && KC3 % KSTEP == 0 && NSLOT <= 4,
                "whole k steps");
  static_assert(TH * (TW / 4) % NW == 0, "whole runs a warp");
};

// one block's shared memory for a cluster of n blocks (C' = 128 n), bytes:
// NSLOT mbarriers (32 B), the LayerNorm's partial sums [2][M] f32, the
// ring's NSLOT slots, then one region that holds the staged halo, then t
// [M][C' + 8], then (after the expansion) the block's h [M][512] in
// fragment order (t and h in bf16, float32 in float32)
struct CLayout {
  int cp, ldt, na, nb;
  unsigned off_st, off_ring, off_t, smem;
};

template <typename G>
__host__ __device__ __forceinline__ CLayout clayout(int n) {
  CLayout L;
  L.cp = kSlice * n;
  L.ldt = L.cp + 8;
  L.na = L.cp / G::KC;
  L.nb = n * G::JB;
  L.off_st = 32;
  L.off_ring = (L.off_st + 8 * G::M + 15) & ~15u;
  L.off_t = L.off_ring + G::NSLOT * G::SLOT;
  unsigned region = G::M * L.ldt * G::SB;
  if (region < (unsigned)G::M * G::ES * G::SB) region = G::M * G::ES * G::SB;
  if (region < (unsigned)G::HALO_BYTES) region = G::HALO_BYTES;
  L.smem = L.off_t + region;
  return L;
}

// ---- mbarriers fed by cp.async
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on the mbarrier once every cp.async this thread started has landed
// (the arrival counts against the mbarrier's count)
__device__ __forceinline__ void mbar_arrive_cp(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
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

__device__ __forceinline__ void fma4(float4& acc, float4 v, float4 w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

// four neighbouring channels of the staged halo as float32 (int8:
// dequantized as the device-memory path does)
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

// Start the copies of the tile plus its K/2 halo, the block's 128 channels
// from c0, into the halo buffer [IH * IW][128] of T at dst (t's room), in
// units of `unit` bytes, zeros outside the image and past cr
template <typename G, typename T>
__device__ __forceinline__ void load_halo_async(
    const T* __restrict__ x, unsigned char* dst, Tile t, int H, int W,
    int cr, int c0, int unit, int tid) {
  constexpr int SZ = (int)sizeof(T);
  const int upp = G::CS * SZ / unit, ush = __ffs(upp) - 1;
  const uint32_t d0 = shared_address(dst);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  for (int i = tid; i < G::IH * G::IW * upp; i += G::NT) {
    const int pix = i >> ush, j = i & (upp - 1);
    const int iy = pix / G::IW, ix = pix - iy * G::IW;
    const int gy = t.y0 - G::PAD + iy, gx = t.x0 - G::PAD + ix;
    const int c = c0 + j * unit / SZ;
    const bool inside = c < cr && (unsigned)gy < (unsigned)H &&
                        (unsigned)gx < (unsigned)W;
    const long long src =
        inside ? (((t.b * H + gy) * W + gx) * cr + c) * (long long)SZ : 0;
    const int d = pix * G::CS * SZ + j * unit;
    copy_unit(dst + d, d0 + d, xb + src, inside, unit);
  }
  cp_async_commit();
}

// The depthwise K x K sums of the block's 128 channels (from c0) over the
// tile into registers, from the staged halo xs [IH * IW][128]: warp w owns
// the runs of 4 neighbouring pixels of a row w, w + NW, ..., lane l
// channels c0 + 4l .. + 3. Per tap row the K weights are loaded once for
// all of the warp's runs and each run's K + 3 input vectors once; the taps
// are summed in (dy, dx) order per output. dwt: [K * K][cp]
template <typename G, typename T>
__device__ __forceinline__ void depthwise_runs(
    const T* xs, const float* __restrict__ dwt, float4 (&acc)[G::RPW][4],
    int cp, int c0, int warp, int lane, float s_in) {
  constexpr int K = G::K, RUNS_W = G::TW / 4;
  const int c = c0 + 4 * lane;
#pragma unroll
  for (int i = 0; i < G::RPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // K = 3, 5: a tap row's weights serve every run; K = 7 (and K = 1, one
  // tap row): a run's tap rows one after the other (the runs' inputs and 7
  // weights a row side by side would spill)
  auto tap_row = [&](int dy, int i_first, int i_last) {
    float4 w[K];
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      w[dx] = __ldg(reinterpret_cast<const float4*>(
          dwt + (dy * K + dx) * cp + c));
#pragma unroll
    for (int i = 0; i < G::RPW; ++i) {
      if (i < i_first || i > i_last) continue;
      const int run = warp + i * G::NW;
      const int ry = run / RUNS_W, rx = run % RUNS_W * 4;
      float4 v[4 + K - 1];
      const T* row = xs + ((ry + dy) * G::IW + rx) * G::CS + 4 * lane;
#pragma unroll
      for (int k = 0; k < 4 + K - 1; ++k) v[k] = load4(row + k * G::CS, s_in);
#pragma unroll
      for (int k = 0; k < 4 + K - 1; ++k)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int j = k - dx;  // the output pixel this tap feeds
          if (j >= 0 && j < 4) fma4(acc[i][j], v[k], w[dx]);
        }
    }
  };
  if constexpr (K >= 7 || K == 1) {
#pragma unroll
    for (int i = 0; i < G::RPW; ++i) {
#pragma unroll 1
      for (int dy = 0; dy < K; ++dy) tap_row(dy, i, i);
    }
  } else {
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) tap_row(dy, 0, G::RPW - 1);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// h lives in "fragment order": for m16 tile mt and k step ks of the
// projection lane l's A fragment is the 16 bytes at ((mt * HK + ks) * 32
// + l) * 16, so that a consumer reads it with one 16-byte load, through
// DSMEM: in bf16 the expansion's accumulators of n8 tiles 2 ks and
// 2 ks + 1 are that fragment as they stand (words 0, 1 and 2, 3); in
// float32 those of n8 tile ks, as c0, c2, c1, c3 (a k8 step's columns in
// the order 0, 2, 4, 6 | 1, 3, 5, 7)

// The expansion's part of W2 item kc (columns KC kc .. of t) for the
// warp's E columns over every m16 tile: A (t) and B (the item) by
// ldmatrix, a B fragment pair for every m16 tile
template <typename G>
__device__ __forceinline__ void expand_item(
    float (&acc)[G::MT][G::ENA][4], uint32_t t_lane, uint32_t b_lane, int kc,
    const CLayout& L) {
  // the k16 steps one after the other: the t fragments of two side by
  // side with the 128 accumulators spill
#pragma unroll 1
  for (int ks = 0; ks < G::KC / 16; ++ks) {
    uint32_t a[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
      ldmatrix_x4(a[mt], t_lane + 2 * (16 * mt * L.ldt + kc * G::KC +
                                       ks * 16));
#pragma unroll
    for (int np = 0; np < G::ENA / 2; ++np) {
      uint32_t b[4];  // B fragments of n8 tiles 2 np and 2 np + 1
      ldmatrix_x4(b, b_lane + 2 * (16 * np * G::LDA + ks * 16));
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The projection's part of W3 item (rank rr, columns KC3 jj ..): block
// rr's h fragments of those k16 steps for the warp's MB m16 tiles from
// mt0 through DSMEM (all in flight together), B from the item, onto the
// warp's CO output channels
template <typename G>
__device__ __forceinline__ void project_item(
    float (&pacc)[G::MB][G::CO / 8][4], const uint4* hr, uint32_t b_lane,
    int jj, int mt0) {
  constexpr int KS = G::KC3 / 16;
  const int lane = threadIdx.x & 31;
  uint4 a[G::MB][KS];
#pragma unroll
  for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      a[mb][ks] = hr[((mt0 + mb) * G::HK + jj * KS + ks) * 32 + lane];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int np = 0; np < G::CO / 16; ++np) {
      uint32_t b[4];  // B fragments of n8 tiles 2 np and 2 np + 1
      ldmatrix_x4(b, b_lane + 2 * (16 * np * G::LD3 + ks * 16));
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) {
        const uint32_t af[4] = {a[mb][ks].x, a[mb][ks].y, a[mb][ks].z,
                                a[mb][ks].w};
        mma_bf16(pacc[mb][2 * np], af, b[0], b[1]);
        mma_bf16(pacc[mb][2 * np + 1], af, b[2], b[3]);
      }
    }
  }
}

// float32 sums: the tensor core does not round each sum of a product into
// its accumulator to nearest, and the error grows with the chain of
// products into one accumulator (at C = 1024, 1,536 into each output put
// it 2.0e-5 of max |out| from the plain version, PERF.md §6). So each
// item's products go into accumulators of their own, started at zero, and
// are added to the running sums with __fadd_rn: a chain is one item long
// (6 products in the expansion, 24 in the projection; 8.2e-7)
__device__ __forceinline__ void add_rn(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// float32: the expansion's part of W2 item kc in 3xTF32, as expand_item,
// into sums of the item's own (add_rn). t_lane: t at row g, column 2q; b_lane: the item at the warp's first E
// row + g, column 2q. A k8 step's columns go 0, 2, 4, 6 | 1, 3, 5, 7 in A
// and B alike, so that each fragment is a float2
template <typename G>
__device__ __forceinline__ void expand_item_f32(
    float (&acc)[G::MT][G::ENA][4], const float* t_lane, const float* b_lane,
    int kc, int ldt) {
  constexpr int KS = G::KC / 8;
  uint32_t ab[KS][G::MT][4], as[KS][G::MT][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const float* tp = t_lane + 16 * mt * ldt + kc * G::KC + 8 * ks;
      const float2 lo = *reinterpret_cast<const float2*>(tp);
      const float2 hi = *reinterpret_cast<const float2*>(tp + 8 * ldt);
      split_a(lo.x, hi.x, lo.y, hi.y, ab[ks][mt], as[ks][mt]);
    }
#pragma unroll
  for (int e = 0; e < G::ENA; ++e) {
    float d[G::MT][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 b =
          *reinterpret_cast<const float2*>(b_lane + 8 * e * G::LDA + 8 * ks);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b.x, bb0, bs0);
      split_tf32(b.y, bb1, bs1);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        mma_tf32(d[mt], as[ks][mt], bb0, bb1);
        mma_tf32(d[mt], ab[ks][mt], bs0, bs1);
        mma_tf32(d[mt], ab[ks][mt], bb0, bb1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) add_rn(acc[mt][e], d[mt]);
  }
}

// float32: the projection's part of W3 item (rank rr, columns KC3 jj ..)
// in 3xTF32, as project_item, into sums of the item's own (add_rn);
// b_lane: the item at the warp's first output row + g, column 2q
template <typename G>
__device__ __forceinline__ void project_item_f32(
    float (&pacc)[G::MB][G::CO / 8][4], const float4* hr, const float* b_lane,
    int jj, int mt0) {
  constexpr int KS = G::KC3 / 8;
  const int lane = threadIdx.x & 31;
  float4 a[G::MB][KS];
#pragma unroll
  for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      a[mb][ks] = hr[((mt0 + mb) * G::HK + jj * KS + ks) * 32 + lane];
  float d[G::MB][G::CO / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ab[G::MB][4], as[G::MB][4];
#pragma unroll
    for (int mb = 0; mb < G::MB; ++mb)
      split_a(a[mb][ks].x, a[mb][ks].y, a[mb][ks].z, a[mb][ks].w, ab[mb],
              as[mb]);
#pragma unroll
    for (int o = 0; o < G::CO / 8; ++o) {
      const float2 b =
          *reinterpret_cast<const float2*>(b_lane + 8 * o * G::LD3 + 8 * ks);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b.x, bb0, bs0);
      split_tf32(b.y, bb1, bs1);
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) {
        mma_tf32(d[mb][o], as[mb], bb0, bb1);
        mma_tf32(d[mb][o], ab[mb], bs0, bs1);
        mma_tf32(d[mb][o], ab[mb], bb0, bb1);
      }
    }
  }
#pragma unroll
  for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
    for (int o = 0; o < G::CO / 8; ++o) add_rn(pacc[mb][o], d[mb][o]);
}

// out = x + gain * p of CO channels from cb of m16 tile mt, x read back
// from device memory, stored from the accumulators (int8: the
// requantized codes), the true cr channels only
template <typename G, typename T>
__device__ __forceinline__ void store_slice(
    const T* __restrict__ x, T* __restrict__ out,
    const float (&pacc)[G::CO / 8][4], const float* __restrict__ gain,
    Tile t, int H, int W, int cr, int cb, float s_in, float inv_out, int mt,
    int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int o = 0; o < G::CO / 8; ++o) {
    const int c = cb + 8 * o + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = 16 * mt + g + 8 * hf;
      const int gy = t.y0 + m / G::TW, gx = t.x0 + m % G::TW;
      if (gy >= H || gx >= W) continue;
      const long long base = ((t.b * H + gy) * W + gx) * cr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (c + j >= cr) continue;
        const float v = __fadd_rn(residual(x[base + c + j], s_in),
                                  __fmul_rn(__ldg(gain + c + j),
                                            pacc[o][2 * hf + j]));
        if constexpr (G::kInt8)
          out[base + c + j] = (int8_t)quant_int8(v, inv_out);
        else
          out[base + c + j] = bid::from_float<T>(v);
      }
    }
  }
}

template <typename G, typename T>
__global__ void __launch_bounds__(G::NT, 1)
convnext_cluster_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const float* __restrict__ dwt,
                        const float* __restrict__ ln,
                        const typename G::S* __restrict__ w2,
                        const typename G::S* __restrict__ w3,
                        const float* __restrict__ gain, int B, int H, int W,
                        int cr, float inv_cr, float slope, float s_in,
                        float inv_out) {
  using S = typename G::S;
  constexpr int M = G::M, NT = G::NT, NS = G::NSLOT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const CLayout L = clayout<G>(n);
  const int cp = L.cp, c0 = r * G::CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t bars = shared_address(smem);  // a full mbarrier a slot
  float* part_sum = reinterpret_cast<float*>(smem + L.off_st);
  float* part_sq = part_sum + M;
  unsigned char* ring = smem + L.off_ring;
  S* ts = reinterpret_cast<S*>(smem + L.off_t);
  // the block's h, in fragment order, in t's room once the expansion is
  // done with t
  uint4* hbuf = reinterpret_cast<uint4*>(smem + L.off_t);
  // the tile's halo of the block's channels is staged in t's room too
  const T* xs = reinterpret_cast<const T*>(ts);
  const int unit = io_unit<T>(cr);

  const int tiles_w = (W + G::TW - 1) / G::TW;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const int ntiles = B * tiles_h * tiles_w;  // the launcher checks the range
  auto tile_at = [&](int i) {
    const int rest = i / tiles_w;
    return Tile{rest / tiles_h, rest % tiles_h * G::TH, i % tiles_w * G::TW};
  };
  // the cluster walks tiles cid, cid + ncl, ...; a tile streams NA W2
  // items, then NB W3 items, through the ring: item g (of the running
  // count over the block's tiles) lands in slot g % NSLOT
  const int cid = blockIdx.x / n, ncl = gridDim.x / n;
  const int per_tile = L.na + L.nb;
  const int total = ((ntiles - 1 - cid) / ncl + 1) * per_tile;
  // a thread's 16-byte copies of an item: vectors tid, tid + NT, ... of
  // its rows (a power of two of vectors a row). One bulk copy (TMA) a row
  // instead, from one warp, ran 4x slower (PERF.md §6): the rows
  // are 32 to 256 bytes
  auto issue = [&](int g) {
    const int i = g % per_tile, s = g % NS;
    const uint32_t dst = shared_address(ring + s * G::SLOT);
    // this block's rows of W2 [4 cp][cp] (its E slice) and of W3 [cp][4 cp]
    // (its output channels)
    const S* w2b = w2 + (size_t)r * G::ES * cp;
    const S* w3b = w3 + (size_t)c0 * 4 * cp;
    constexpr int SB = G::SB, VE = G::VE;
    if (i < L.na) {
      constexpr int RV = G::KC / VE;
      for (int v = tid; v < G::ES * RV; v += NT) {
        const int row = v / RV, p = v % RV;
        cp_async_16(dst + SB * (row * G::LDA + VE * p),
                    w2b + (size_t)row * cp + i * G::KC + VE * p, true);
      }
    } else {
      constexpr int RV = G::KC3 / VE;
      const int j = i - L.na, rr = j / G::JB, jj = j - rr * G::JB;
      const S* src = w3b + rr * G::ES + jj * G::KC3;
      for (int v = tid; v < G::CS * RV; v += NT) {
        const int row = v / RV, p = v % RV;
        cp_async_16(dst + SB * (row * G::LD3 + VE * p),
                    src + (size_t)row * 4 * cp + VE * p, true);
      }
    }
    mbar_arrive_cp(bars + 8 * s);
  };
  // wait for item g; after `use` (given the slot's shared-memory address
  // and pointer), every warp is past it and its slot takes item g + NSLOT
  int g = 0;
  auto consume = [&](auto use) {
    const int s = g % NS;
    mbar_wait(bars + 8 * s, (uint32_t)((g / NS) & 1));
    use(shared_address(ring + s * G::SLOT),
        reinterpret_cast<const S*>(ring + s * G::SLOT));
    __syncthreads();
    if (g + NS < total) issue(g + NS);
    ++g;
  };

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(bars + 8 * i, NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < NS && i < total; ++i) issue(i);

  const int cl = c0 + 4 * lane;  // the lane's 4 channels
  // the projection's warp: m16 tiles MB pm .., output channels CO pq ..
  constexpr int GROUPS = G::MT / G::MB;
  const int pm = warp % GROUPS, pq = warp / GROUPS;
  for (int tile = cid; tile < ntiles; tile += ncl) {
    const Tile t = tile_at(tile);
    // ---- depthwise of the block's channels from the halo staged in t's
    // room (every block is past its reads of this block's h: the barrier
    // that ends the last tile), then the LayerNorm's statistics over the
    // cluster; t's slices go to every block
    load_halo_async<G>(x, reinterpret_cast<unsigned char*>(ts), t, H, W, cr,
                       c0, unit, tid);
    cp_async_wait_all();
    __syncthreads();
    float4 acc[G::RPW][4];
    depthwise_runs<G, T>(xs, dwt, acc, cp, c0, warp, lane, s_in);
    auto pix = [&](int i, int j) {
      const int run = warp + i * G::NW;
      return run / (G::TW / 4) * G::TW + run % (G::TW / 4) * 4 + j;
    };
#pragma unroll
    for (int i = 0; i < G::RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = warp_sum((acc[i][j].x + acc[i][j].y) +
                                 (acc[i][j].z + acc[i][j].w));
        if (lane == 0) part_sum[pix(i, j)] = s;
      }
    cluster.sync();
    // lane l < n reads block l's part of a run's four pixels' sums (the
    // loads in flight together); the parts add in rank order
    auto parts = [&](const float* a, int i, float (&part)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[j] = lane < n ? *cluster.map_shared_rank(a + pix(i, j), lane)
                           : 0.f;
    };
#pragma unroll
    for (int i = 0; i < G::RPW; ++i) {
      float part[4];
      parts(part_sum, i, part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = 0.f;
        for (int rr = 0; rr < n; ++rr)
          s += __shfl_sync(0xffffffffu, part[j], rr);
        const float mean = s * inv_cr;
        float4& v = acc[i][j];
        v.x = cl < cr ? v.x - mean : 0.f;
        v.y = cl + 1 < cr ? v.y - mean : 0.f;
        v.z = cl + 2 < cr ? v.z - mean : 0.f;
        v.w = cl + 3 < cr ? v.w - mean : 0.f;
        const float sq = warp_sum(
            fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, v.x * v.x))));
        if (lane == 0) part_sq[pix(i, j)] = sq;
      }
    }
    // every block's part of every centred square is written, and every
    // block is past its depthwise: the t slices may overwrite the halos
    cluster.sync();
    const float4 lns = __ldg(reinterpret_cast<const float4*>(ln + cl));
#pragma unroll
    for (int i = 0; i < G::RPW; ++i) {
      float part[4];
      parts(part_sq, i, part);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = 0.f;
        for (int rr = 0; rr < n; ++rr)
          s += __shfl_sync(0xffffffffu, part[j], rr);
        const float rs = rsqrtf(s * inv_cr + kLnEps);
        const float4 v = acc[i][j];
        const float4 tf = make_float4(v.x * rs * lns.x, v.y * rs * lns.y,
                                      v.z * rs * lns.z, v.w * rs * lns.w);
        if constexpr (G::kF32) {
          for (int rr = 0; rr < n; ++rr)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(ts, rr) +
                                       pix(i, j) * L.ldt + cl) = tf;
        } else {
          const uint2 tv = make_uint2(pack_bf16(tf.x, tf.y),
                                      pack_bf16(tf.z, tf.w));
          for (int rr = 0; rr < n; ++rr)
            *reinterpret_cast<uint2*>(cluster.map_shared_rank(ts, rr) +
                                      pix(i, j) * L.ldt + cl) = tv;
        }
      }
    }
    // t is whole in every block
    cluster.sync();

    // ---- the expansion of the block's 512 E channels, W2 streamed by
    // columns of t: warp w's E columns over every m16 tile
    {
      float hacc[G::MT][G::ENA][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int e = 0; e < G::ENA; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) hacc[mt][e][i] = 0.f;
      if constexpr (G::kF32) {
        const int gq = lane >> 2, q = lane & 3;
        const float* t_lane = ts + gq * L.ldt + 2 * q;
        const int b_off = (warp * G::EW + gq) * G::LDA + 2 * q;
#pragma unroll 1
        for (int kc = 0; kc < L.na; ++kc)
          consume([&](uint32_t, const S* slot) {
            expand_item_f32<G>(hacc, t_lane, slot + b_off, kc, L.ldt);
          });
      } else {
        const uint32_t t_lane = shared_address(
            ts + (lr + (lm & 1) * 8) * L.ldt + (lm >> 1) * 8);
        const uint32_t b_off =
            2 * ((warp * G::EW + (lm >> 1) * 8 + lr) * G::LDA + (lm & 1) * 8);
#pragma unroll 1
        for (int kc = 0; kc < L.na; ++kc)
          consume([&](uint32_t slot, const S*) {
            expand_item<G>(hacc, t_lane, slot + b_off, kc, L);
          });
      }
      // every warp is past t (the last item's barrier): h takes its room
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int e = 0; e < G::ENA; ++e) {
          const int e8 = warp * G::ENA + e;  // the n8 tile of the E slice
          const float h0 = leaky(hacc[mt][e][0], slope);
          const float h1 = leaky(hacc[mt][e][1], slope);
          const float h2 = leaky(hacc[mt][e][2], slope);
          const float h3 = leaky(hacc[mt][e][3], slope);
          if constexpr (G::kF32) {
            reinterpret_cast<float4*>(hbuf)[(mt * G::HK + e8) * 32 + lane] =
                make_float4(h0, h2, h1, h3);
          } else {
            uint32_t* dst = reinterpret_cast<uint32_t*>(
                hbuf + (mt * G::HK + e8 / 2) * 32 + lane) + 2 * (e8 & 1);
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(pack_bf16(h0, h1), pack_bf16(h2, h3));
          }
        }
    }
    // every block's h is whole
    cluster.sync();

    // ---- the projection: every block's h (through DSMEM) against W3's
    // rows of this block's output channels, streamed by E columns
    float pacc[G::MB][G::CO / 8][4];
#pragma unroll
    for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
      for (int o = 0; o < G::CO / 8; ++o)
#pragma unroll
        for (int i = 0; i < 4; ++i) pacc[mb][o][i] = 0.f;
#pragma unroll 1
    for (int rr = 0; rr < n; ++rr) {
      const uint4* hr = cluster.map_shared_rank(hbuf, rr);
      if constexpr (G::kF32) {
        const int b3_off =
            (pq * G::CO + (lane >> 2)) * G::LD3 + 2 * (lane & 3);
#pragma unroll 1
        for (int jj = 0; jj < G::JB; ++jj)
          consume([&](uint32_t, const S* slot) {
            project_item_f32<G>(pacc, reinterpret_cast<const float4*>(hr),
                                slot + b3_off, jj, G::MB * pm);
          });
      } else {
        const uint32_t b3_off =
            2 * ((pq * G::CO + (lm >> 1) * 8 + lr) * G::LD3 + (lm & 1) * 8);
#pragma unroll 1
        for (int jj = 0; jj < G::JB; ++jj)
          consume([&](uint32_t slot, const S*) {
            project_item<G>(pacc, hr, slot + b3_off, jj, G::MB * pm);
          });
      }
    }
#pragma unroll
    for (int mb = 0; mb < G::MB; ++mb)
      store_slice<G, T>(x, out, pacc[mb], gain, t, H, W, cr,
                        c0 + pq * G::CO, s_in, inv_out, G::MB * pm + mb,
                        lane);
    // every block is past its reads of this block's h, which the next
    // tile's halo overwrites
    cluster.sync();
  }
}

// the clusters of n blocks of `kern` that the card holds at once
template <typename G, typename Kern>
int active_clusters(Kern kern, int n, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = clayout<G>(n).smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

template <typename G, typename T>
int launch_cluster(const void* x, void* out, const void* dw, const void* ln,
                   const void* w2, const void* w3, const void* gain, int B,
                   int H, int W, int cr, float slope, float s_in,
                   float inv_out, cudaStream_t stream) {
  auto kern = convnext_cluster_kernel<G, T>;
  const int n = (cr + kSlice - 1) / kSlice;
  static int clusters_by_device[kMaxDevices][kMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev < 0 || dev >= kMaxDevices) return BID_ERR_UNSUPPORTED;
  int& act = clusters_by_device[dev][n];
  if (act == 0) {
    const int e = active_clusters<G>(kern, n, &act);
    if (e != 0) return e;
    if (act < 1) return BID_ERR_UNSUPPORTED;
  }
  const long long tiles = (long long)B * ((H + G::TH - 1) / G::TH) *
                          ((W + G::TW - 1) / G::TW);
  if (tiles == 0) return 0;
  // the kernel counts tiles and a block's ring items in 32 bits
  const long long per_tile = n * (kSlice / G::KC + G::JB);
  if (tiles > INT_MAX - act || (tiles / act + 1) * per_tile > INT_MAX)
    return BID_ERR_UNSUPPORTED;
  const int grid = (int)(tiles < act ? tiles : act);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid * n, 1, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = clayout<G>(n).smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const float*>(dw), static_cast<const float*>(ln),
      static_cast<const typename G::S*>(w2),
      static_cast<const typename G::S*>(w3),
      static_cast<const float*>(gain), B, H, W, cr, 1.f / (float)cr, slope,
      s_in, inv_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// v[0..8]: shared memory, registers, local (spill) bytes, threads per
// block, resident blocks per SM, cluster size, the clusters the card holds
// at once, the layout's width (128 n) and 0 (no bulk-copy weight ring:
// chunk_ring.cuh), of the kernel that runs C channels
template <typename G, typename T>
int info_cluster(int cr, int* v) {
  auto kern = convnext_cluster_kernel<G, T>;
  const int n = (cr + kSlice - 1) / kSlice;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  const int rc = active_clusters<G>(kern, n, &v[6]);
  if (rc != 0) return rc;
  v[0] = (int)clayout<G>(n).smem;
  v[1] = a.numRegs;
  v[2] = (int)a.localSizeBytes;
  v[3] = G::NT;
  v[5] = n;
  v[7] = n * kSlice;
  v[8] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v[4], kern,
                                                            G::NT, v[0]);
}

// the layout that runs C channels at K in I/O type T: a callable on CCfg
// (nullptr-free dispatch), BID_ERR_UNSUPPORTED where none fits. float32:
// tiles of 32 pixels and two ring slots at every n (C' = 1024: 230,688 B)
template <typename T, int K, typename F>
int with_layout(int C, F f) {
  const int n = (C + kSlice - 1) / kSlice;
  if (C <= kSlice || n > kMaxCluster) return BID_ERR_UNSUPPORTED;
  if constexpr (std::is_same<T, float>::value)
    return f(CCfg<T, K, 2, 8, 16, 64, 2>());
  else if (n <= 4)
    return f(CCfg<T, K, 4, 8, 32, 128, 3>());
  else
    return f(CCfg<T, K, 4, 8, 16, 64, 3>());
}

template <typename T, int K>
int launch_k(const void* x, void* out, const void* dw, const void* ln,
             const void* w2, const void* w3, const void* gain, int B, int H,
             int W, int C, float slope, float s_in, float inv_out,
             cudaStream_t s) {
  return with_layout<T, K>(C, [&](auto cfg) {
    using G = decltype(cfg);
    return launch_cluster<G, T>(x, out, dw, ln, w2, w3, gain, B, H, W, C,
                                slope, s_in, inv_out, s);
  });
}

template <typename T, int K>
int info_k(int C, int* v) {
  return with_layout<T, K>(C, [&](auto cfg) {
    using G = decltype(cfg);
    return info_cluster<G, T>(C, v);
  });
}

}  // namespace

namespace bid_k1 {

template <typename T>
int launch_cluster_unit(const void* x, void* out, const void* dw,
                        const void* ln, const void* w2, const void* w3,
                        const void* gain, int B, int H, int W, int C, int K,
                        float slope, float s_in, float inv_out,
                        cudaStream_t s) {
#define BID_WIDE(KK)                                                       \
  if (K == KK)                                                             \
    return launch_k<T, KK>(x, out, dw, ln, w2, w3, gain, B, H, W, C, slope, \
                           s_in, inv_out, s);
  BID_WIDE(1)
  BID_WIDE(3)
  BID_WIDE(5)
  BID_WIDE(7)
#undef BID_WIDE
  return BID_ERR_UNSUPPORTED;
}

template <typename T>
int info_cluster_unit(int C, int K, int* v) {
  if (K == 1) return info_k<T, 1>(C, v);
  if (K == 3) return info_k<T, 3>(C, v);
  if (K == 5) return info_k<T, 5>(C, v);
  if (K == 7) return info_k<T, 7>(C, v);
  return BID_ERR_UNSUPPORTED;
}

}  // namespace bid_k1
