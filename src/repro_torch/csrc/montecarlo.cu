// Hit-and-miss Monte Carlo: pi or poly, with the LCG or xoshiro128+.
//
// Replaces src/repro/kernels/montecarlo.py:_mc_kernel (via
// mc_partial_sums).  Each of n_lanes = n_blocks * 1024 lanes is one
// sequential stream.  Global lane g = block*1024 + lane seeds its state from
// splitmix32 (prng.cuh):
//   LCG          state = splitmix32(g + seed);
//   xoshiro128+  word k = splitmix32(g + seed + k*0x9e3779b9), k = 0..3;
// every add wrapping mod 2^32.  Step i draws x then u (two generator steps),
// tests x*x + u*u < 1 (pi) or u < f(x) (poly, Horner in fp32) and adds the
// hit to accumulator i % 3; the lane writes (a0 + a1) + a2.  The three fp32
// accumulators saturate past 2^24 hits exactly as the TPU kernel's do, so no
// integer counter stands in for them.
//
// Bit-exactness: nvcc contracts a*b + c into one fused multiply-add by
// default, and one rounding fewer can flip a rare hit.  The hit tests
// therefore use __fmul_rn / __fadd_rn, which nvcc never contracts: each
// product and each sum is rounded on its own, as the JAX package and the
// plain PyTorch version round them.  The rest of the file is exact (integer
// work, an exact conversion and power-of-two scale, adds of 0 or 1).
//
// Geometry: the TPU kernel's grid step of 1024 lanes is not carried over.
// Lanes are independent, so one thread runs one lane, in blocks of 128
// threads: the 8192 lanes of the default n_blocks = 8 spread over 64 SMs, one
// warp on each of their four schedulers.
//
// Bound on the H100: instruction dispatch; the bytes (4 written per lane)
// do not count.  nvcc turns xoshiro128+'s five xors into three-input LOP3s
// and moves its shift and add onto the multiply-add pipe (IMAD), so a pi
// sample takes about 26 instructions, 13 of them on the integer pipe: the
// dispatch slots (128 lanes per SM) and the INT32 lanes (64) run out
// together.  At n_blocks = 8 only one warp runs on each scheduler, and each
// lane's samples are sequential, so the kernel is bound there by one lane's
// instructions at one per clock and by its generator's dependency chain.
#include "common.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 128;

struct Lcg {
  uint32_t s;
  __device__ explicit Lcg(uint32_t base) : s(copift::splitmix32(base)) {}
  __device__ __forceinline__ uint32_t next() {
    s = s * copift::kLcgA + copift::kLcgC;
    return (s >> 9) ^ s;
  }
};

struct Xoshiro128p {
  uint32_t s0, s1, s2, s3;
  __device__ explicit Xoshiro128p(uint32_t base)
      : s0(copift::splitmix32(base)),
        s1(copift::splitmix32(base + copift::kPhi)),
        s2(copift::splitmix32(base + 2u * copift::kPhi)),
        s3(copift::splitmix32(base + 3u * copift::kPhi)) {}
  __device__ __forceinline__ uint32_t next() {
    const uint32_t out = s0 + s3;
    const uint32_t t = s1 << 9;
    s2 ^= s0;
    s3 ^= s1;
    s1 ^= s2;
    s0 ^= s3;
    s2 ^= t;
    s3 = (s3 << 11) | (s3 >> 21);
    return out;
  }
};

// f(x) = ((0.4x + 0.3)x + 0.2)x + 0.1, coefficients as fp32 values.
__device__ __forceinline__ float poly(float x) {
  float p = 0x1.99999ap-2f;
  p = __fadd_rn(__fmul_rn(p, x), 0x1.333334p-2f);
  p = __fadd_rn(__fmul_rn(p, x), 0x1.99999ap-3f);
  p = __fadd_rn(__fmul_rn(p, x), 0x1.99999ap-4f);
  return p;
}

// One sample: 1.0 for a hit, else 0.0.
template <bool kPi, typename Gen>
__device__ __forceinline__ float sample(Gen& gen) {
  const float x = copift::uniform_from_bits(gen.next());
  const float u = copift::uniform_from_bits(gen.next());
  const bool hit =
      kPi ? __fadd_rn(__fmul_rn(x, x), __fmul_rn(u, u)) < 1.f : u < poly(x);
  return hit ? 1.f : 0.f;
}

template <bool kPi, typename Gen>
__global__ void mc_kernel(float* __restrict__ out, int64_t n_lanes,
                          uint32_t seed, int64_t iters) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n_lanes) return;
  Gen gen(static_cast<uint32_t>(g) + seed);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  int64_t i = 0;
  for (; i + 3 <= iters; i += 3) {
    a0 += sample<kPi>(gen);
    a1 += sample<kPi>(gen);
    a2 += sample<kPi>(gen);
  }
  if (i < iters) a0 += sample<kPi>(gen);
  if (i + 1 < iters) a1 += sample<kPi>(gen);
  out[g] = (a0 + a1) + a2;
}

template <bool kPi, typename Gen>
void launch(float* out, int64_t n_lanes, uint32_t seed, int64_t iters,
            cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n_lanes + kThreads - 1) / kThreads);
  mc_kernel<kPi, Gen><<<blocks, kThreads, 0, stream>>>(out, n_lanes, seed,
                                                       iters);
}

}  // namespace

// out[g] = the hit count of lane g < n_lanes after iters samples, on the
// given stream; kind 0 is the LCG, 1 xoshiro128+; problem 0 is pi, 1 poly.
// n_lanes must be below 2^32 (the wrapper checks).  Returns the launch's
// cudaError_t as an int (0 on success).
extern "C" int copift_mc_f32(float* out, int64_t n_lanes, uint32_t seed,
                             int kind, int problem, int64_t iters,
                             cudaStream_t stream) {
  if (n_lanes > 0) {
    if (kind == 0 && problem == 0) {
      launch<true, Lcg>(out, n_lanes, seed, iters, stream);
    } else if (kind == 0) {
      launch<false, Lcg>(out, n_lanes, seed, iters, stream);
    } else if (problem == 0) {
      launch<true, Xoshiro128p>(out, n_lanes, seed, iters, stream);
    } else {
      launch<false, Xoshiro128p>(out, n_lanes, seed, iters, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
