// Fused training-noise corruption: per sample, multiplicative noise
// x(1 + s z) with probability 0.5 and s ~ U[mlo, mhi], then additive
// noise + s z with probability 0.5 and s ~ U[alo, ahi], then rounding
// half to even; z is a Box-Muller normal redrawn once beyond +-2, then
// clipped to +-2.
//
// Replaces blind_image_denoising_tpu/ops/pallas_noise.py
// corrupt_batch_pallas (body _corrupt_kernel). One pass over [B, n] f32
// (n = H W C): one read and one write per element. The TPU kernel drew
// from the core's PRNG; here a counter-based Philox4x32-10 written out
// below gives every draw from (seed, sample, element index, stream)
// alone, never from the grid, so the plain PyTorch version
// (ops/pallas_noise.py corrupt_batch_plain) reproduces every draw:
//   stream 0, counter (e, b, 0, 0): the four words of element e, two
//     Box-Muller pairs (multiplicative, additive);
//   stream 1, counter (0, b, 1, 0): sample b's flags and stds;
// b is the sample's row in the global batch: the local row plus the
// launch's sample offset, so a data-parallel rank holding rows
// offset .. offset + B - 1 of the global batch draws exactly those rows
// of the single-process draw (offset 0 is the local batch).
// What bounds it on the H100: at the train step's 16 x 128^2 x 3 the
// 6.3 MB cross memory in 1.9 us, above the 40 Philox multiplies per
// element (integer rate) and the four special functions per Box-Muller
// pair (MUFU rate); the kernel itself issues ~240 instructions per
// element of a sample with both noises on, 155 with one and 27 with
// none, so it is bound by instruction issue and latency in practice.
// The first version gave each thread one or two elements, each a long
// dependent chain, behind a block barrier while one thread computed the
// header, with 4-byte accesses. This one: each thread takes a quad of 4
// consecutive elements (one 16-byte load and store where n % 4 == 0 and
// the pointers are aligned; masked scalars else) and runs their four
// Philox chains unrolled side by side, so they hide each other's
// latency; every thread derives its sample's header from warp-uniform
// values (block index, arguments), with no barrier; blocks of one sample
// are small (512 elements), so the block scheduler spreads samples with
// both noises and samples with none over the SMs. Built without
// --use_fast_math, so logf and sincosf are the accurate ones, and the
// float steps the plain version repeats use explicitly rounded
// intrinsics (no FMA contraction).
#include "common.cuh"

namespace {

struct Header {
  float mul_on, mul_std, add_on, add_std;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// 23 mantissa bits -> [0, 1), exactly as the TPU kernel's _bits_to_uniform
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
}

__device__ __forceinline__ float truncated_normal(uint32_t a, uint32_t b) {
  const float u1 = bits_to_uniform(a), u2 = bits_to_uniform(b);
  const float r = __fsqrt_rn(__fmul_rn(-2.f, logf(fmaxf(u1, 1e-12f))));
  float s, c;
  sincosf(__fmul_rn(6.2831855f, u2), &s, &c);
  const float z0 = __fmul_rn(r, c), z1 = __fmul_rn(r, s);
  const float z = fabsf(z0) <= 2.f ? z0 : z1;
  return fminf(fmaxf(z, -2.f), 2.f);
}

__device__ __forceinline__ Header sample_header(uint2 key, uint32_t b,
                                                float mlo, float mhi,
                                                float alo, float ahi) {
  const uint4 w = philox4x32_10(make_uint4(0u, b, 1u, 0u), key);
  Header h;
  h.mul_on = bits_to_uniform(w.x) > 0.5f ? 1.f : 0.f;
  h.mul_std = __fadd_rn(mlo, __fmul_rn(bits_to_uniform(w.y), __fsub_rn(mhi, mlo)));
  h.add_on = bits_to_uniform(w.z) > 0.5f ? 1.f : 0.f;
  h.add_std = __fadd_rn(alo, __fmul_rn(bits_to_uniform(w.w), __fsub_rn(ahi, alo)));
  return h;
}

constexpr int kNoiseThreads = 128;

// grid: (blocks over a sample's quads, B); block: kNoiseThreads threads,
// each one quad (4 consecutive elements) of sample blockIdx.y. kVec: n is
// a multiple of 4 and both pointers 16-byte aligned, so a quad is one
// 16-byte load and store; else four masked scalar ones.
template <bool kVec>
__global__ void __launch_bounds__(kNoiseThreads) corrupt_noise_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    float* __restrict__ params, uint32_t n, uint32_t seed, uint32_t offset,
    float mlo, float mhi, float alo, float ahi, int use_mul, int use_add,
    int do_round) {
  const uint32_t b = blockIdx.y;          // the local row
  const uint32_t row = b + offset;        // the counter's sample word
  const uint2 key = make_uint2(seed, 0u);
  // every thread derives the header from the block index and the
  // arguments alone: warp-uniform values, so no barrier and no shared copy
  const Header hdr = sample_header(key, row, mlo, mhi, alo, ahi);
  if (params != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    float* p = params + 4 * (size_t)b;
    p[0] = hdr.mul_on; p[1] = hdr.mul_std; p[2] = hdr.add_on; p[3] = hdr.add_std;
  }
  const bool mul = use_mul && hdr.mul_on != 0.f;
  const bool add = use_add && hdr.add_on != 0.f;
  const unsigned long long first =
      4ull * ((unsigned long long)blockIdx.x * kNoiseThreads + threadIdx.x);
  if (first >= n) return;
  const uint32_t e0 = (uint32_t)first;
  const float* xs = x + (size_t)b * n + e0;
  float* os = out + (size_t)b * n + e0;
  float v[4];
  if (kVec) {
    const float4 t = *reinterpret_cast<const float4*>(xs);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e0 + j < n ? xs[j] : 0.f;
  }
  if (mul || add) {
    // four independent Philox chains, interleaved by the compiler
    uint4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = philox4x32_10(make_uint4(e0 + j, row, 0u, 0u), key);
    if (mul) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = truncated_normal(w[j].x, w[j].y);
        v[j] = __fmul_rn(v[j], __fadd_rn(1.f, __fmul_rn(hdr.mul_std, z)));
      }
    }
    if (add) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = truncated_normal(w[j].z, w[j].w);
        v[j] = __fadd_rn(v[j], __fmul_rn(hdr.add_std, z));
      }
    }
  }
  if (do_round) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = rintf(v[j]);
  }
  if (kVec) {
    *reinterpret_cast<float4*>(os) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < n) os[j] = v[j];
  }
}

}  // namespace

extern "C" int bid_corrupt_noise(const void* x, void* out, void* params,
                                 int B, long long n, uint32_t seed,
                                 uint32_t offset, float mlo, float mhi,
                                 float alo, float ahi, int use_mul,
                                 int use_add, int do_round, void* stream) {
  if (B < 0 || n < 0 || n > 0xFFFFFFFFll || B > 65535 ||
      (unsigned long long)offset + (unsigned long long)B > 0x100000000ull)
    return BID_ERR_BAD_ARGUMENT;
  if (B == 0 || n == 0) return 0;
  const long long quads = (n + 3) / 4;
  const dim3 grid((unsigned)((quads + kNoiseThreads - 1) / kNoiseThreads),
                  (unsigned)B);
  const bool vec = n % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    corrupt_noise_kernel<true><<<grid, kNoiseThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(params), (uint32_t)n, seed, offset, mlo, mhi,
        alo, ahi, use_mul, use_add, do_round);
  } else {
    corrupt_noise_kernel<false><<<grid, kNoiseThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(params), (uint32_t)n, seed, offset, mlo, mhi,
        alo, ahi, use_mul, use_add, do_round);
  }
  return (int)cudaGetLastError();
}
