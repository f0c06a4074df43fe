// Laplacian band split, band = x - A x and smooth = A x, where A is the
// count-aware SAME k x k stride-1 box mean (the extra row/column of an
// even window on the HIGH side, divide by the in-image tap count).
//
// Replaces blind_image_denoising_tpu/ops/pallas_pyramid.py
// laplacian_band_smooth_pallas (body _band_smooth_kernel). Memory-bound:
// one read of x and one write each of band and smooth. One thread per
// 16-byte vector of channels of one NHWC pixel (a C that is no multiple of
// it: band_smooth_narrow_kernel, 8, 4, 2 or 1 bytes); the tap sum is float32
// in row-major tap order, then multiplied by 1/count computed from the
// index (the plain PyTorch version, band_smooth_plain, does the same
// arithmetic in the same order).
//
// The split with decimation, band = x - A x and down = (A x)[::2, ::2]
// into [B, H/2, W/2, C], replaces laplacian_band_split_pallas (body
// _band_split_kernel). Bound by bytes too: x read once, band written
// once, down a quarter of that, 2.25 B H W C elements against 3.35 TB/s.
// Its first version was the pooling loop above with the smooth stored
// only at even (y, x): half its bound, and a copy of it with the index
// math, the k^2 loads of every vector, the reciprocal, the grid cap and
// the idle down-store lanes all cut out still read 0.63-0.70 of it: the
// rest was the memory pipeline. This one, band_split_kernel: persistent
// blocks walk 2-D tiles of rows x pixels x all C; the tile and its k - 1
// halo go into shared memory by 16-byte cp.async copies (zero-filled
// outside the image, as the plain version pads), and the next tile's
// copies are in flight while this one sums. The copies and the sums use
// 32-bit offsets within an image and no division per pixel (a few per
// tile, for its origin and its halo). A thread owns even
// 2 x 2 quads of one channel vector down a
// column strip: it reads each staged row of its strip once (three
// vectors at k = 2, the vertical taps reused from registers), sums every
// output's taps in band_smooth_plain's order (rows outer, columns inner,
// from 0.0), multiplies by the IEEE reciprocal of the in-image tap count,
// stores four 16-byte band vectors and one down vector a quad:
// bit-exact. split_plan below gives the tile; ops/pallas_pyramid.py
// split_tile_plan mirrors it. A C that is no whole number of 16-byte
// vectors (C = 108 in bf16) runs the same kernel with N channels a thread,
// N the largest power of two that divides C (8-, 4- or 2-byte copies and
// stores; cp.async of 8 and 4 bytes, a plain load of 2); a C of more
// vectors than a block has threads runs as slices of the channels, a
// launch each.
//
// The backward, dx = g_band + A^T (g_smooth - g_band), replaces the JAX
// custom VJP _band_smooth_bwd / _pool_transpose (XLA there; a kernel here
// because autograd cannot see through the forward kernel). A^T z sums
// z * inv_count over the k^2 windows that cover a pixel: the transposed
// padding (k-1-lo, lo). On the H100 it is bound by memory: one read each
// of g_band and g_smooth and one write of dx, 3 B H W C bytes against
// 3.35 TB/s, and 3k^2 + 1 float operations per element. The first
// version (one thread per 16-byte vector over a flat index) ran at half
// that bound: five 64-bit % and / per vector, an IEEE reciprocal per
// tap, and k^2 loads of each vector, those of the rows above from L2.
// This one: the work is 2-D tiles of rows x pixels x all C, walked by
// persistent blocks (as many as fit on the SMs at once); a block loads
// both grads of its tile and the tile's halo once (16 bytes a thread,
// 32-bit offsets within an image, no division in the loop), forms z once
// per staged pixel in float32 into shared memory, and sums each output's
// k^2 taps from there in band_smooth_bwd_plain's order (rows outer,
// columns inner, from 0.0, out-of-image taps adding 0.0 as its padding
// does), adds g_band kept beside z and stores 16 bytes: bit-exact.
// While it sums one tile, the loads of its next tile are in flight, so
// the block does not leave the memory system idle across its barriers.
// bwd_plan below gives the tile; ops/pallas_pyramid.py bwd_tile_plan
// mirrors it. Any C: as the split's, a C of no whole 16-byte vectors moves
// N channels a thread (z staged as float4, float2 or float), and a C of
// more vectors than a block has threads runs as slices.
#include <climits>

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

// N channels of one pixel moved as one N * sizeof(T)-byte load or store
template <int BYTES> struct RawBytes;
template <> struct RawBytes<16> { using type = uint4; };
template <> struct RawBytes<8> { using type = uint2; };
template <> struct RawBytes<4> { using type = uint32_t; };
template <> struct RawBytes<2> { using type = uint16_t; };

template <typename T, int N>
struct VecN {
  using Raw = typename RawBytes<N * sizeof(T)>::type;
  Raw raw;
  __device__ __forceinline__ T& operator[](int j) {
    return reinterpret_cast<T*>(&raw)[j];
  }
};

// band_smooth_kernel for a C that is no multiple of a 16-byte vector
// (C = 108 in bf16: a band split of a unet_laplacian_v6 whose
// filters_level_multiplier is 1.5): the same sums in the same order, N
// channels a thread, N the largest power of two below a vector that
// divides C
template <typename T, int N>
__global__ void __launch_bounds__(256) band_smooth_narrow_kernel(
    const T* __restrict__ x, T* __restrict__ band, T* __restrict__ smooth,
    int B, int H, int W, int C, int k) {
  using Vec = VecN<T, N>;
  using Raw = typename Vec::Raw;
  const int cv_n = C / N;
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
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < k; ++dy) {
      const int y = y0 + dy;
      if (y < 0 || y >= H) continue;
      for (int dx = 0; dx < k; ++dx) {
        const int xx = x0 + dx;
        if (xx < 0 || xx >= W) continue;
        Vec t;
        t.raw = *reinterpret_cast<const Raw*>(
            x + ((b * H + y) * W + xx) * C + cv * N);
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = __fadd_rn(acc[j], bid::to_float(t[j]));
      }
    }
    const int rows = min(y0 + k, H) - max(y0, 0);
    const int cols = min(x0 + k, W) - max(x0, 0);
    const float inv = __fdiv_rn(1.f, (float)(rows * cols));
    const long long off = ((b * H + h) * W + w) * C + cv * N;
    Vec xc, sb, ss;
    xc.raw = *reinterpret_cast<const Raw*>(x + off);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float s = __fmul_rn(acc[j], inv);
      ss[j] = bid::from_float<T>(s);
      sb[j] = bid::from_float<T>(__fsub_rn(bid::to_float(xc[j]), s));
    }
    *reinterpret_cast<Raw*>(band + off) = sb.raw;
    *reinterpret_cast<Raw*>(smooth + off) = ss.raw;
  }
}

// channels of a pixel a thread moves: a 16-byte vector of V where C is a
// whole number of them, else the largest power of two that divides C (8, 4
// or 2 bytes: C = 108 in bf16 moves 4 channels, C = 3 one)
inline int chans_per_thread(int C, int V) {
  const int low = C & -C;
  return low < V ? low : V;
}

template <typename T>
int launch(const void* x, void* band, void* smooth, int B, int H, int W,
           int C, int k, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (C < 1 || k < 1 || B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  const int n_chans = chans_per_thread(C, V);
  const long long n = (long long)B * H * W * (C / n_chans);
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)bid::sm_count() * 16;
  if (blocks > cap) blocks = cap;
  const T* xt = static_cast<const T*>(x);
  T* bt = static_cast<T*>(band);
  T* st = static_cast<T*>(smooth);
  if (n_chans == V)
    band_smooth_kernel<T><<<(int)blocks, threads, 0, stream>>>(
        xt, bt, st, B, H, W, C, k);
  else if (n_chans >= 4)
    band_smooth_narrow_kernel<T, 4><<<(int)blocks, threads, 0, stream>>>(
        xt, bt, st, B, H, W, C, k);
  else if (n_chans == 2)
    band_smooth_narrow_kernel<T, 2><<<(int)blocks, threads, 0, stream>>>(
        xt, bt, st, B, H, W, C, k);
  else
    band_smooth_narrow_kernel<T, 1><<<(int)blocks, threads, 0, stream>>>(
        xt, bt, st, B, H, W, C, k);
  return (int)cudaGetLastError();
}

// The backward and the decimating split move N channels of a pixel a
// thread, as the forward does (chans_per_thread above). VecN is those N
// channels as one load or store, FloatN (ZN) of their float32 values one
// shared-memory access: a float4 plane each 4 channels (two at N = 8 in
// bf16), else a float2 or a float.

template <int N> struct FloatN;
template <> struct FloatN<4> { using type = float4; };
template <> struct FloatN<2> { using type = float2; };
template <> struct FloatN<1> { using type = float; };

// Tile plan of the backward for one shape: a block owns th rows x tw
// pixels x all C channels; its threads form bdx x bdy with bdx = tw * C/N
// (one vector of N channels each across a tile row) and own
// kRowsPerThread rows each. tw aims at kRowVectors vectors per tile row;
// th and then tw halve until the staged tile, (th + k - 1) x (tw + k - 1)
// pixels of float32 z, and the tile's own g_band fit kMaxSmem. A C of more
// than kBwdThreads vectors runs as slices of kBwdThreads vectors (the last
// one narrower), a launch each, planned at the slice's width.
// ops/pallas_pyramid.py bwd_tile_plan mirrors it.
constexpr int kBwdThreads = 256;
constexpr int kRowVectors = 128;
constexpr int kRowsPerThread = 2;
// resident blocks per SM the register budget must allow, and halo
// vectors a thread loads ahead with its own
constexpr int kBwdMinBlocks = 3;
constexpr int kHaloSlots = 1;
constexpr int kMaxSmem = 232448;

struct BwdPlan {
  int tw, th, bdx, bdy, smem;
};

// C: the channels of one slice, N of them a thread, elt bytes each
inline int bwd_plan(int H, int W, int C, int k, int N, int elt, BwdPlan* p) {
  const int cv = C / N;
  if (cv > kBwdThreads) return BID_ERR_UNSUPPORTED;
  int tw = max(1, min(W, kRowVectors / cv));
  int th = -1;
  for (;;) {
    const int bdx = tw * cv;
    const int bdy = max(1, min(kBwdThreads / bdx, H));
    if (th < 0) th = max(1, min(H, bdy * kRowsPerThread));
    const long long smem = 4ll * (th + k - 1) * (tw + k - 1) * C +
                           (long long)elt * th * tw * C;
    if (smem <= kMaxSmem) {
      *p = BwdPlan{tw, th, bdx, bdy, (int)smem};
      return 0;
    }
    if (th > 1) {
      th = (th + 1) / 2;
    } else if (tw > 1) {
      tw = (tw + 1) / 2;
    } else {
      return BID_ERR_UNSUPPORTED;
    }
  }
}

// dx = g_band + A^T z with z = (g_smooth - g_band) * inv_count, over
// tiles. A block is persistent: it walks the tiles t, t + gridDim.x, ...
// and, while it sums tile t from shared memory, the loads of tile t +
// gridDim.x are already in flight into registers, so they overlap the
// block's barriers and its sum. Per tile:
//   commit: z of each thread's own kRowsPerThread output vectors and of
//     its kHaloSlots halo vectors (the k - 1 wide border, hl rows and
//     columns above and left, lo below and right) goes from the loaded
//     registers to shared memory as float32, zero outside the image;
//     halo vectors beyond the slots (large k only) load there and then;
//   sum: each thread adds the k^2 staged z of its outputs in the plain
//     version's tap order (rows outer, columns inner, from 0.0), adds its
//     g_band (kept in shared memory by the commit, which frees its
//     registers for the next tile's loads) and stores its vector.
// Shared memory holds z in V/ZN planes of FloatN<ZN>, so a thread's vector
// is one access per plane and a warp's accesses are conflict-free.
//
// V: channels a thread (N above; 16 bytes for every C of whole vectors).
// ld: elements from one pixel to the next (C, or the whole C of a slice).
// KK: the window size when it is known at compile time (2, the flagship's
// gaussian_kernel_size, whose taps unroll), 0 for any k.
template <typename T, int V>
struct BwdStage {
  static constexpr int R = kRowsPerThread, S = kHaloSlots;
  VecN<T, V> b[R], s[R];        // own output vectors: g_band, g_smooth
  VecN<T, V> hb[S], hs[S];      // halo vectors
  int hz[S], hy[S], hx[S];      // their staged index (-1: none), pixel
  int h0, w0;                   // the tile's first row and column
  size_t img;                   // its image's first element
};

template <typename T, int V, int KK>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    band_smooth_bwd_kernel(const T* __restrict__ g_band,
                           const T* __restrict__ g_smooth,
                           T* __restrict__ dx, int B, int H, int W, int C,
                           int ld, int k_arg, int tw, int th) {
  using Vec = VecN<T, V>;
  using Raw = typename Vec::Raw;
  constexpr int ZN = V < 4 ? V : 4;               // floats a plane access
  constexpr int NP = V / ZN;                      // planes
  using Z = typename FloatN<ZN>::type;
  constexpr int R = kRowsPerThread, S = kHaloSlots;
  extern __shared__ float4 zs4[];
  Z* const zs = reinterpret_cast<Z*>(zs4);
  const int k = KK > 0 ? KK : k_arg;
  const int cv_n = C / V;
  const int lo = (k - 1) / 2, hl = k - 1 - lo;    // reach above / below
  const int rv = tw * cv_n;                       // vectors per tile row
  const int erv = (tw + k - 1) * cv_n;            // per staged row
  const int plane = (th + k - 1) * erv;           // Z per plane
  Raw* const gc = reinterpret_cast<Raw*>(zs + NP * plane);  // centres
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int n_tiles = tiles_x * tiles_y * B;
  const int n_rows = (k - 1) * erv, side = (k - 1) * cv_n;
  const int n_halo = n_rows + th * side;
  const float inv_full = __fdiv_rn(1.f, (float)(k * k));
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nt = blockDim.x * blockDim.y, tl = ty * blockDim.x + tx;
  // this thread's column: pixel p of the tile, channel vector c
  const int p = tx / cv_n, c = tx - p * cv_n;

  // staged (er, ev) of halo vector q
  auto halo_at = [&](int q, int& er, int& ev) {
    if (q < n_rows) {
      er = q / erv;
      ev = q - er * erv;
      if (er >= hl) er += th;
    } else {
      const int r = (q - n_rows) / side, s = q - n_rows - r * side;
      er = hl + r;
      ev = s < hl * cv_n ? s : s + rv;
    }
  };
  auto load = [&](const T* base, int y, int x, int cc) {
    Vec v;
    v.raw = *reinterpret_cast<const Raw*>(base + (y * W + x) * ld + cc * V);
    return v;
  };
  // issue every load of tile t into st (no use yet)
  auto issue = [&](int t, BwdStage<T, V>& st) {
    const int bx = t % tiles_x, rest = t / tiles_x;
    st.h0 = (rest % tiles_y) * th;
    st.w0 = bx * tw;
    st.img = (size_t)(rest / tiles_y) * H * W * ld;
    const T* gb = g_band + st.img;
    const T* gs = g_smooth + st.img;
    const int x = st.w0 + p;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + i * blockDim.y, y = st.h0 + r;
      st.b[i].raw = st.s[i].raw = Raw{};
      if (r < th && y < H && x < W) {
        st.b[i] = load(gb, y, x, c);
        st.s[i] = load(gs, y, x, c);
      }
    }
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int q = tl + m * nt;
      st.hz[m] = -1;
      if (q < n_halo) {
        int er, ev;
        halo_at(q, er, ev);
        const int pe = ev / cv_n, ce = ev - pe * cv_n;
        const int y = st.h0 - hl + er, xx = st.w0 - hl + pe;
        st.hz[m] = er * erv + ev;
        st.hy[m] = -1;
        if (y >= 0 && y < H && xx >= 0 && xx < W) {
          st.hy[m] = y;
          st.hx[m] = xx;
          st.hb[m] = load(gb, y, xx, ce);
          st.hs[m] = load(gs, y, xx, ce);
        }
      }
    }
  };
  // z of one staged vector (pixel (y, xx) in the image) into shared memory
  auto put_z = [&](int zi, int y, int xx, Vec tb, Vec ts) {
    const int rows = min(y - lo + k, H) - max(y - lo, 0);
    const int cols = min(xx - lo + k, W) - max(xx - lo, 0);
    const int cnt = rows * cols;
    const float inv = cnt == k * k ? inv_full : __fdiv_rn(1.f, (float)cnt);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      Z z;
      float* zf = reinterpret_cast<float*>(&z);
#pragma unroll
      for (int r = 0; r < ZN; ++r)
        zf[r] = __fmul_rn(__fsub_rn(bid::to_float(ts[ZN * q + r]),
                                    bid::to_float(tb[ZN * q + r])),
                          inv);
      zs[q * plane + zi] = z;
    }
  };
  auto put_zero = [&](int zi) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      Z z;
      float* zf = reinterpret_cast<float*>(&z);
#pragma unroll
      for (int r = 0; r < ZN; ++r) zf[r] = 0.f;
      zs[q * plane + zi] = z;
    }
  };

  BwdStage<T, V> st;
  int t = blockIdx.x;
  if (t < n_tiles) issue(t, st);
  for (; t < n_tiles; t += gridDim.x) {
    // commit tile t
    const int h0 = st.h0, w0 = st.w0, x = w0 + p;
    const size_t img = st.img;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + i * blockDim.y, y = h0 + r;
      if (r >= th) continue;
      gc[r * rv + tx] = st.b[i].raw;
      const int zi = (r + hl) * erv + tx + hl * cv_n;
      if (y < H && x < W) {
        put_z(zi, y, x, st.b[i], st.s[i]);
      } else {
        put_zero(zi);
      }
    }
#pragma unroll
    for (int m = 0; m < S; ++m) {
      if (st.hz[m] < 0) continue;
      if (st.hy[m] >= 0) {
        put_z(st.hz[m], st.hy[m], st.hx[m], st.hb[m], st.hs[m]);
      } else {
        put_zero(st.hz[m]);
      }
    }
    for (int q = tl + S * nt; q < n_halo; q += nt) {
      int er, ev;
      halo_at(q, er, ev);
      const int pe = ev / cv_n, ce = ev - pe * cv_n;
      const int y = h0 - hl + er, xx = w0 - hl + pe;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        put_z(er * erv + ev, y, xx, load(g_band + img, y, xx, ce),
              load(g_smooth + img, y, xx, ce));
      } else {
        put_zero(er * erv + ev);
      }
    }
    __syncthreads();
    // the next tile's loads go out before this tile's sum
    if (t + (int)gridDim.x < n_tiles) issue(t + gridDim.x, st);
    T* __restrict__ out = dx + img;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + i * blockDim.y, y = h0 + r;
      if (r >= th || y >= H || x >= W) continue;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
      auto tap = [&](int dy, int dxx) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const Z z = zs[q * plane + (r + dy) * erv + tx + dxx * cv_n];
          const float* zf = reinterpret_cast<const float*>(&z);
#pragma unroll
          for (int j = 0; j < ZN; ++j)
            acc[ZN * q + j] = __fadd_rn(acc[ZN * q + j], zf[j]);
        }
      };
      if constexpr (KK > 0) {
#pragma unroll
        for (int dy = 0; dy < KK; ++dy)
#pragma unroll
          for (int dxx = 0; dxx < KK; ++dxx) tap(dy, dxx);
      } else {
#pragma unroll 1
        for (int dy = 0; dy < k; ++dy)
#pragma unroll 1
          for (int dxx = 0; dxx < k; ++dxx) tap(dy, dxx);
      }
      Vec cen, o;
      cen.raw = gc[r * rv + tx];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = bid::from_float<T>(__fadd_rn(bid::to_float(cen[j]), acc[j]));
      *reinterpret_cast<Raw*>(out + (y * W + x) * ld + c * V) = o.raw;
    }
    __syncthreads();                  // the sum is done with shared memory
  }
}

template <typename T, int V>
auto bwd_kernel(int k) {
  return k == 2 ? band_smooth_bwd_kernel<T, V, 2>
                : band_smooth_bwd_kernel<T, V, 0>;
}

// resident blocks per SM of kernel kern launched with plan p (a BwdPlan
// or a SplitPlan: bdx x bdy threads, smem bytes)
template <typename K, typename P>
int resident(K kern, const P& p, int* blocks) {
  if (p.smem > 48 * 1024) {          // above the default, per device
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (a != cudaSuccess) return (int)a;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, p.bdx * p.bdy, p.smem);
}

// one slice of C channels (ld apart from pixel to pixel), N a thread
template <typename T, int N>
int launch_bwd_slice(const T* g_band, const T* g_smooth, T* dx, int B, int H,
                     int W, int C, int ld, int k, cudaStream_t stream) {
  BwdPlan p;
  int e = bwd_plan(H, W, C, k, N, (int)sizeof(T), &p);
  if (e != 0) return e;
  const long long tiles = (long long)((W + p.tw - 1) / p.tw) *
                          ((H + p.th - 1) / p.th) * B;
  if (tiles > INT_MAX) return BID_ERR_UNSUPPORTED;
  const auto kern = bwd_kernel<T, N>(k);
  int per_sm = 0;
  e = resident(kern, p, &per_sm);
  if (e != 0) return e;
  if (per_sm < 1) return BID_ERR_UNSUPPORTED;
  const long long cap = (long long)bid::sm_count() * per_sm;
  kern<<<(int)(tiles < cap ? tiles : cap), dim3(p.bdx, p.bdy), p.smem,
         stream>>>(g_band, g_smooth, dx, B, H, W, C, ld, k, p.tw, p.th);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_bwd_n(const void* g_band, const void* g_smooth, void* dx, int B,
                 int H, int W, int C, int k, cudaStream_t stream) {
  const T* gb = static_cast<const T*>(g_band);
  const T* gs = static_cast<const T*>(g_smooth);
  T* d = static_cast<T*>(dx);
  for (int c0 = 0; c0 < C; c0 += kBwdThreads * N) {
    const int e = launch_bwd_slice<T, N>(gb + c0, gs + c0, d + c0, B, H, W,
                                         min(C - c0, kBwdThreads * N), C, k,
                                         stream);
    if (e != 0) return e;
  }
  return 0;
}

template <typename T>
int launch_bwd(const void* g_band, const void* g_smooth, void* dx, int B,
               int H, int W, int C, int k, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (C < 1 || k < 1 || B < 0 || H < 0 || W < 0) return BID_ERR_BAD_ARGUMENT;
  if ((long long)B * H * W * C == 0) return 0;
  if ((long long)H * W * C > INT_MAX) return BID_ERR_UNSUPPORTED;
  const int n = chans_per_thread(C, V);
  if (n == V)
    return launch_bwd_n<T, V>(g_band, g_smooth, dx, B, H, W, C, k, stream);
  if (n == 4)
    return launch_bwd_n<T, 4>(g_band, g_smooth, dx, B, H, W, C, k, stream);
  if (n == 2)
    return launch_bwd_n<T, 2>(g_band, g_smooth, dx, B, H, W, C, k, stream);
  return launch_bwd_n<T, 1>(g_band, g_smooth, dx, B, H, W, C, k, stream);
}

// plan, registers, spill bytes and resident blocks per SM of the first
// slice's launch, as v[0..7]: tile width, tile height, threads x, threads
// y, shared bytes, registers, local (spill) bytes per thread, blocks per SM
template <typename T, int N>
int bwd_info_n(int H, int W, int C, int k, int* v) {
  BwdPlan p;
  int e = bwd_plan(H, W, min(C, kBwdThreads * N), k, N, (int)sizeof(T), &p);
  if (e != 0) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, bwd_kernel<T, N>(k));
  if (e != 0) return e;
  v[0] = p.tw; v[1] = p.th; v[2] = p.bdx; v[3] = p.bdy; v[4] = p.smem;
  v[5] = a.numRegs; v[6] = (int)a.localSizeBytes;
  return resident(bwd_kernel<T, N>(k), p, &v[7]);
}

template <typename T>
int bwd_info(int H, int W, int C, int k, int* v) {
  constexpr int V = Vec16<T>::N;
  if (C < 1 || k < 1 || H < 1 || W < 1) return BID_ERR_BAD_ARGUMENT;
  const int n = chans_per_thread(C, V);
  if (n == V) return bwd_info_n<T, V>(H, W, C, k, v);
  if (n == 4) return bwd_info_n<T, 4>(H, W, C, k, v);
  if (n == 2) return bwd_info_n<T, 2>(H, W, C, k, v);
  return bwd_info_n<T, 1>(H, W, C, k, v);
}

// ---- K4: the decimating split, band_split_kernel

// 16 bytes global -> shared (a shared-memory address), asynchronously; 16
// zero bytes when !valid (src must be a valid address all the same)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(g), "r"(valid ? 16 : 0)
               : "memory");
}

// BYTES (16, 8, 4 or 2) global -> shared, zeros when !valid: cp.async
// where it takes the size, else a plain load and store (2 bytes: one bf16
// channel)
template <int BYTES>
__device__ __forceinline__ void copy_vec(uint32_t dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    cp_async_16(dst, src, valid);
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    const size_t g = __cvta_generic_to_global(src);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(g), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  } else {
    static_assert(BYTES == 2, "a vector is 16, 8, 4 or 2 bytes");
    const uint16_t v =
        valid ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Tile plan of the split for one shape: a block owns th rows x tw pixels x
// all C channels (th, tw even); its threads form bdx x bdy with bdx =
// tw / 2 * C/N (one vector of N channels of one quad column each) and
// own kSplitQuadRows quads each, down a column strip. tw aims at
// kSplitRowVectors vectors per tile row; th and then tw halve (by whole
// quads) until kSplitStages staged tiles fit kMaxSmem. A staged tile is
// (th + k - 1) rows x (tw + k - 1) pixels in two planes, the even and the
// odd staged columns, so that a warp's reads of one tap are contiguous.
// A C of more than kSplitThreads vectors runs as slices of kSplitThreads
// vectors, as the backward's. ops/pallas_pyramid.py split_tile_plan
// mirrors it.
constexpr int kSplitThreads = 128;
constexpr int kSplitRowVectors = 128;
constexpr int kSplitQuadRows = 1;
constexpr int kSplitStages = 2;
// resident blocks per SM the register budget must allow
constexpr int kSplitMinBlocks = 6;

struct SplitPlan {
  int tw, th, bdx, bdy, smem;
};

// C: the channels of one slice, N of them a thread, elt bytes each
inline int split_plan(int H, int W, int C, int k, int N, int elt,
                      SplitPlan* p) {
  const int cv = C / N;
  if (cv > kSplitThreads) return BID_ERR_UNSUPPORTED;
  int quads = max(1, min(W / 2, kSplitRowVectors / (2 * cv)));
  int rows = -1;                      // quad rows per tile
  for (;;) {
    const int bdx = quads * cv;
    const int bdy = max(1, min(kSplitThreads / bdx,
                               (H / 2 + kSplitQuadRows - 1) / kSplitQuadRows));
    if (rows < 0) rows = max(1, min(H / 2, bdy * kSplitQuadRows));
    const long long smem = (long long)kSplitStages * 2 * (2 * rows + k - 1) *
                           ((2 * quads + k) / 2) * C * elt;
    if (smem <= kMaxSmem) {
      *p = SplitPlan{2 * quads, 2 * rows, bdx, bdy, (int)smem};
      return 0;
    }
    if (rows > 1) {
      rows = (rows + 1) / 2;
    } else if (quads > 1) {
      quads = (quads + 1) / 2;
    } else {
      return BID_ERR_UNSUPPORTED;
    }
  }
}

// band = x - A x, down = (A x)[::2, ::2] over tiles. A block is
// persistent: it walks the tiles t, t + gridDim.x, ...; the copies of
// tile t + gridDim.x into the other stage go out before it sums tile t, so
// they overlap its barriers and its sum. Per tile a thread copies its own
// quads' 4 vectors each and its share of the halo (the k - 1 wide border:
// lo rows and columns above and left, k - 1 - lo below and right),
// zero-filled outside the image, so every tap reads a staged value and the
// out-of-image ones add 0.0 as the plain version's padding does.
//
// V: channels a thread (16 bytes for every C of whole vectors). ld:
// elements from one pixel to the next (C, or the whole C of a slice). KK:
// the window size when it is known at compile time (2, the flagship's
// gaussian_kernel_size: a thread reads each staged row of its strip once,
// three vectors, and keeps the partial sums of the row above in
// registers), 0 for any k (each output sums its k^2 taps from shared
// memory).
template <typename T, int V, int KK>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    band_split_kernel(const T* __restrict__ x, T* __restrict__ band,
                      T* __restrict__ down, int B, int H, int W, int C,
                      int ld, int k_arg, int tw, int th) {
  using Vec = VecN<T, V>;
  using Raw = typename Vec::Raw;
  constexpr int R = kSplitQuadRows;
  extern __shared__ uint4 stage4[];
  const Raw* const stage = reinterpret_cast<const Raw*>(stage4);
  const int k = KK > 0 ? KK : k_arg;
  const int cv_n = C / V;
  const int lo = (k - 1) / 2;
  const int eh = th + k - 1, ew = tw + k - 1;   // staged rows, columns
  const int hw = (ew + 1) / 2;                  // pixels per plane row
  const int rs = hw * cv_n;                     // vectors per plane row
  const int plane = eh * rs;                    // vectors per plane
  const int tiles_x = W / tw + (W % tw != 0), tiles_y = H / th + (H % th != 0);
  const int n_tiles = tiles_x * tiles_y * B;
  const int n_rows = (k - 1) * ew * cv_n, side = (k - 1) * cv_n;
  const int n_halo = n_rows + th * side;
  const float inv_full = __fdiv_rn(1.f, (float)(k * k));
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nt = blockDim.x * blockDim.y, tl = ty * blockDim.x + tx;
  // this thread's quad column q (tile pixels 2q, 2q + 1), channel vector c
  const int q = tx / cv_n, c = tx - q * cv_n;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(stage4));

  // shared address of staged vector (sr, e) of channel vector cc in stage st
  auto staged = [&](int st, int sr, int e, int cc) {
    return s0 + (uint32_t)sizeof(Raw) *
                    (uint32_t)(st * 2 * plane + (e & 1) * plane + sr * rs +
                               (e >> 1) * cv_n + cc);
  };
  auto tile_origin = [&](int t, int& h0, int& w0, size_t& img) {
    const int bx = t % tiles_x, rest = t / tiles_x;
    h0 = (rest % tiles_y) * th;
    w0 = bx * tw;
    img = (size_t)(rest / tiles_y) * H * W * ld;
  };
  // start the copies of tile t into stage st
  auto issue = [&](int t, int st) {
    int h0, w0;
    size_t img;
    tile_origin(t, h0, w0, img);
    const T* xin = x + img;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = 2 * (ty * R + r);
      if (row >= th) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int y = h0 + row + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int xx = w0 + 2 * q + j;
          const bool in = y < H && xx < W;
          copy_vec<sizeof(Raw)>(staged(st, lo + row + i, lo + 2 * q + j, c),
                                in ? xin + (y * W + xx) * ld + c * V : x, in);
        }
      }
    }
    for (int m = tl; m < n_halo; m += nt) {
      int sr, e, cc;
      if (m < n_rows) {
        const int r = m / (ew * cv_n), rem = m - r * ew * cv_n;
        sr = r < lo ? r : r + th;
        e = rem / cv_n;
        cc = rem - e * cv_n;
      } else {
        const int r = (m - n_rows) / side, rem = m - n_rows - r * side;
        const int ce = rem / cv_n;
        sr = lo + r;
        e = ce < lo ? ce : ce + tw;
        cc = rem - ce * cv_n;
      }
      const int y = h0 - lo + sr, xx = w0 - lo + e;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
      copy_vec<sizeof(Raw)>(staged(st, sr, e, cc),
                            in ? xin + (y * W + xx) * ld + cc * V : x, in);
    }
  };
  // 1 / (in-image taps) of the window at (y, xx)
  auto inv_count = [&](int y, int xx) {
    const int rows = min(y - lo + k, H) - max(y - lo, 0);
    const int cols = min(xx - lo + k, W) - max(xx - lo, 0);
    const int cnt = rows * cols;
    return cnt == k * k ? inv_full : __fdiv_rn(1.f, (float)cnt);
  };
  // band (and, for the quad's top-left pixel, down) of output (y, xx) from
  // its tap sum and its own value
  auto emit = [&](const float (&acc)[V], Vec own, int y, int xx,
                  T* __restrict__ bo, T* __restrict__ dn) {
    const float inv = inv_count(y, xx);
    Vec sb, ss;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float s = __fmul_rn(acc[j], inv);
      ss[j] = bid::from_float<T>(s);
      sb[j] = bid::from_float<T>(__fsub_rn(bid::to_float(own[j]), s));
    }
    *reinterpret_cast<Raw*>(bo + (y * W + xx) * ld + c * V) = sb.raw;
    if (dn != nullptr)
      *reinterpret_cast<Raw*>(dn + ((y >> 1) * (W >> 1) + (xx >> 1)) * ld +
                              c * V) = ss.raw;
  };
  auto tap = [&](const Raw* base, int sr, int e) {
    Vec v;
    v.raw = base[(e & 1) * plane + sr * rs + (e >> 1) * cv_n];
    return v;
  };

  int t = blockIdx.x, st = 0;
  if (t < n_tiles) issue(t, 0);
  cp_async_commit();
  for (; t < n_tiles; t += gridDim.x, st ^= 1) {
    if (t + (int)gridDim.x < n_tiles) issue(t + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    int h0, w0;
    size_t img;
    tile_origin(t, h0, w0, img);
    T* __restrict__ bo = band + img;
    T* __restrict__ dn = down + img / 4;
    const int xq = w0 + 2 * q;              // the quad's left column
    const Raw* base = stage + st * 2 * plane + q * cv_n + c;
    if (xq < W) {
      if constexpr (KK == 2) {
        // staged row sr of the strip: A, B, Cc are staged columns 2q,
        // 2q + 1, 2q + 2; the top output row's partial sums (0 + A) + B
        // and (0 + B) + Cc wait in p0, p1 for the row below
        float p0[V], p1[V];
        Vec own0, own1;
        auto start = [&](int sr) {
          own0 = tap(base, sr, 0);
          own1 = tap(base, sr, 1);
          Vec cc = tap(base, sr, 2);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float a = bid::to_float(own0[j]), b = bid::to_float(own1[j]);
            p0[j] = __fadd_rn(__fadd_rn(0.f, a), b);
            p1[j] = __fadd_rn(__fadd_rn(0.f, b), bid::to_float(cc[j]));
          }
        };
        // add staged row sr to p0, p1 and emit output row y; then start
        // the next output row from sr
        auto finish = [&](int sr, int y, bool top) {
          Vec a = tap(base, sr, 0), b = tap(base, sr, 1),
              cc = tap(base, sr, 2);
          float o0[V], o1[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float fb = bid::to_float(b[j]);
            o0[j] = __fadd_rn(__fadd_rn(p0[j], bid::to_float(a[j])), fb);
            o1[j] = __fadd_rn(__fadd_rn(p1[j], fb), bid::to_float(cc[j]));
          }
          emit(o0, own0, y, xq, bo, top ? dn : nullptr);
          emit(o1, own1, y, xq + 1, bo, nullptr);
          own0 = a;
          own1 = b;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float fa = bid::to_float(a[j]), fb = bid::to_float(b[j]);
            p0[j] = __fadd_rn(__fadd_rn(0.f, fa), fb);
            p1[j] = __fadd_rn(__fadd_rn(0.f, fb), bid::to_float(cc[j]));
          }
        };
        const int row0 = 2 * ty * R;
        if (row0 < th && h0 + row0 < H) start(row0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + 2 * r, y = h0 + row;
          if (row >= th || y >= H) break;
          finish(row + 1, y, true);
          finish(row + 2, y + 1, false);
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
          const int row = 2 * (ty * R + r), y = h0 + row;
          if (row >= th || y >= H) break;
#pragma unroll 1
          for (int i = 0; i < 2; ++i) {
#pragma unroll 1
            for (int jx = 0; jx < 2; ++jx) {
              float acc[V];
#pragma unroll
              for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 1
              for (int dy = 0; dy < k; ++dy) {
#pragma unroll 1
                for (int dx = 0; dx < k; ++dx) {
                  Vec v = tap(base, row + i + dy, jx + dx);
#pragma unroll
                  for (int j = 0; j < V; ++j)
                    acc[j] = __fadd_rn(acc[j], bid::to_float(v[j]));
                }
              }
              emit(acc, tap(base, row + i + lo, jx + lo), y + i, xq + jx, bo,
                   i == 0 && jx == 0 ? dn : nullptr);
            }
          }
        }
      }
    }
    __syncthreads();                  // the sum is done with this stage
  }
}

template <typename T, int V>
auto split_kernel(int k) {
  return k == 2 ? band_split_kernel<T, V, 2> : band_split_kernel<T, V, 0>;
}

// one slice of C channels (ld apart from pixel to pixel), N a thread
template <typename T, int N>
int launch_split_slice(const T* x, T* band, T* down, int B, int H, int W,
                       int C, int ld, int k, cudaStream_t stream) {
  SplitPlan p;
  int e = split_plan(H, W, C, k, N, (int)sizeof(T), &p);
  if (e != 0) return e;
  const long long tiles = (long long)((W + p.tw - 1) / p.tw) *
                          ((H + p.th - 1) / p.th) * B;
  if (tiles > INT_MAX) return BID_ERR_UNSUPPORTED;
  const auto kern = split_kernel<T, N>(k);
  int per_sm = 0;
  e = resident(kern, p, &per_sm);
  if (e != 0) return e;
  if (per_sm < 1) return BID_ERR_UNSUPPORTED;
  const long long cap = (long long)bid::sm_count() * per_sm;
  kern<<<(int)(tiles < cap ? tiles : cap), dim3(p.bdx, p.bdy), p.smem,
         stream>>>(x, band, down, B, H, W, C, ld, k, p.tw, p.th);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_split_n(const void* x, void* band, void* down, int B, int H, int W,
                   int C, int k, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* bt = static_cast<T*>(band);
  T* dt = static_cast<T*>(down);
  for (int c0 = 0; c0 < C; c0 += kSplitThreads * N) {
    const int e = launch_split_slice<T, N>(
        xt + c0, bt + c0, dt + c0, B, H, W, min(C - c0, kSplitThreads * N),
        C, k, stream);
    if (e != 0) return e;
  }
  return 0;
}

template <typename T>
int launch_split(const void* x, void* band, void* down, int B, int H, int W,
                 int C, int k, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (C < 1 || k < 1 || B < 0 || H < 0 || W < 0 || ((H | W) & 1))
    return BID_ERR_BAD_ARGUMENT;
  if ((long long)B * H * W * C == 0) return 0;
  if ((long long)H * W * C > INT_MAX) return BID_ERR_UNSUPPORTED;
  const int n = chans_per_thread(C, V);
  if (n == V) return launch_split_n<T, V>(x, band, down, B, H, W, C, k, stream);
  if (n == 4) return launch_split_n<T, 4>(x, band, down, B, H, W, C, k, stream);
  if (n == 2) return launch_split_n<T, 2>(x, band, down, B, H, W, C, k, stream);
  return launch_split_n<T, 1>(x, band, down, B, H, W, C, k, stream);
}

// plan, registers, spill bytes and resident blocks per SM of the first
// slice's launch, as v[0..7]: tile width, tile height, threads x, threads
// y, shared bytes, registers, local (spill) bytes per thread, blocks per SM
template <typename T, int N>
int split_info_n(int H, int W, int C, int k, int* v) {
  SplitPlan p;
  int e = split_plan(H, W, min(C, kSplitThreads * N), k, N, (int)sizeof(T),
                     &p);
  if (e != 0) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, split_kernel<T, N>(k));
  if (e != 0) return e;
  v[0] = p.tw; v[1] = p.th; v[2] = p.bdx; v[3] = p.bdy; v[4] = p.smem;
  v[5] = a.numRegs; v[6] = (int)a.localSizeBytes;
  return resident(split_kernel<T, N>(k), p, &v[7]);
}

template <typename T>
int split_info(int H, int W, int C, int k, int* v) {
  constexpr int V = Vec16<T>::N;
  if (C < 1 || k < 1 || H < 2 || W < 2 || ((H | W) & 1))
    return BID_ERR_BAD_ARGUMENT;
  const int n = chans_per_thread(C, V);
  if (n == V) return split_info_n<T, V>(H, W, C, k, v);
  if (n == 4) return split_info_n<T, 4>(H, W, C, k, v);
  if (n == 2) return split_info_n<T, 2>(H, W, C, k, v);
  return split_info_n<T, 1>(H, W, C, k, v);
}

}  // namespace

extern "C" int bid_band_smooth_bwd(const void* g_band, const void* g_smooth,
                                   void* dx, int B, int H, int W, int C,
                                   int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(g_band, g_smooth, dx, B, H, W, C, k, s);
  if (dtype == 1) return launch_bwd<bid::bf16>(g_band, g_smooth, dx, B, H, W, C, k, s);
  return BID_ERR_UNSUPPORTED;
}

extern "C" int bid_band_smooth_bwd_info(int H, int W, int C, int k,
                                        int dtype, int* info) {
  if (dtype == 0) return bwd_info<float>(H, W, C, k, info);
  if (dtype == 1) return bwd_info<bid::bf16>(H, W, C, k, info);
  return BID_ERR_UNSUPPORTED;
}

extern "C" int bid_band_smooth(const void* x, void* band, void* smooth,
                               int B, int H, int W, int C, int k, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, band, smooth, B, H, W, C, k, s);
  if (dtype == 1) return launch<bid::bf16>(x, band, smooth, B, H, W, C, k, s);
  return BID_ERR_UNSUPPORTED;
}

extern "C" int bid_band_split(const void* x, void* band, void* down, int B,
                              int H, int W, int C, int k, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_split<float>(x, band, down, B, H, W, C, k, s);
  if (dtype == 1) return launch_split<bid::bf16>(x, band, down, B, H, W, C, k, s);
  return BID_ERR_UNSUPPORTED;
}

extern "C" int bid_band_split_info(int H, int W, int C, int k, int dtype,
                                   int* info) {
  if (dtype == 0) return split_info<float>(H, W, C, k, info);
  if (dtype == 1) return split_info<bid::bf16>(H, W, C, k, info);
  return BID_ERR_UNSUPPORTED;
}

extern "C" const char* bid_error_string(int code) {
  if (code == BID_ERR_UNSUPPORTED) return "unsupported dtype or shape";
  if (code == BID_ERR_BAD_ARGUMENT) return "bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
