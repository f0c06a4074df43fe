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
//   stream 1, counter (0, b, 1, 0): sample b's flags and stds, computed
//     by one thread of each block and shared, so every block of a sample
//     agrees (what the TPU kernel's per-sample reseed ensured).
// Philox's ten rounds (their key schedule, the same for every element,
// runs once per warp on the uniform datapath) and the two Box-Muller
// pairs (logf, sqrtf, sincosf) issue about 240 instructions per element
// of a sample with both noises on, 155 with one and 27 with none
// (chip_smoke.py counts them from this kernel's SASS), against 8 bytes of
// traffic: the kernel is bound by instruction issue, not bytes. Built
// without --use_fast_math, so logf and sincosf are the accurate ones, and
// the float steps the plain version repeats use explicitly rounded
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

// grid: (blocks over a sample's n elements, B); block: 256 threads
__global__ void __launch_bounds__(256) corrupt_noise_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    float* __restrict__ params, long long n, uint32_t seed, float mlo,
    float mhi, float alo, float ahi, int use_mul, int use_add, int do_round) {
  const uint32_t b = blockIdx.y;
  const uint2 key = make_uint2(seed, 0u);
  __shared__ Header hdr;
  if (threadIdx.x == 0) {
    hdr = sample_header(key, b, mlo, mhi, alo, ahi);
    if (params != nullptr && blockIdx.x == 0) {
      float* p = params + 4 * (long long)b;
      p[0] = hdr.mul_on; p[1] = hdr.mul_std; p[2] = hdr.add_on; p[3] = hdr.add_std;
    }
  }
  __syncthreads();
  const bool mul = use_mul && hdr.mul_on != 0.f;
  const bool add = use_add && hdr.add_on != 0.f;
  const float* xs = x + (long long)b * n;
  float* os = out + (long long)b * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float y = xs[e];
    if (mul || add) {
      const uint4 w = philox4x32_10(make_uint4((uint32_t)e, b, 0u, 0u), key);
      if (mul) {
        const float z = truncated_normal(w.x, w.y);
        y = __fmul_rn(y, __fadd_rn(1.f, __fmul_rn(hdr.mul_std, z)));
      }
      if (add) {
        const float z = truncated_normal(w.z, w.w);
        y = __fadd_rn(y, __fmul_rn(hdr.add_std, z));
      }
    }
    os[e] = do_round ? rintf(y) : y;
  }
}

}  // namespace

extern "C" int bid_corrupt_noise(const void* x, void* out, void* params,
                                 int B, long long n, uint32_t seed, float mlo,
                                 float mhi, float alo, float ahi, int use_mul,
                                 int use_add, int do_round, void* stream) {
  if (B < 0 || n < 0 || n > 0xFFFFFFFFll || B > 65535) return BID_ERR_BAD_ARGUMENT;
  if (B == 0 || n == 0) return 0;
  const int threads = 256;
  long long per_sample = (n + threads - 1) / threads;
  const long long cap = ((long long)bid::sm_count() * 16 + B - 1) / B;
  if (per_sample > cap) per_sample = cap;
  corrupt_noise_kernel<<<dim3((unsigned)per_sample, (unsigned)B), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(params), n, seed, mlo, mhi, alo, ahi, use_mul,
      use_add, do_round);
  return (int)cudaGetLastError();
}
