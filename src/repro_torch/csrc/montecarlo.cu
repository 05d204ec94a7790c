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
// hit to accumulator i % 3; the lane writes (a0 + a1) + a2.
//
// Bit-exactness: nvcc contracts a*b + c into one fused multiply-add by
// default, and one rounding fewer can flip a rare hit.  The hit tests
// therefore use __fmul_rn / __fadd_rn, which nvcc never contracts: each
// product and each sum is rounded on its own, as the JAX package and the
// plain PyTorch version round them.  The rest of the file is exact (integer
// work, an exact conversion and power-of-two scale, adds of 0 or 1).
//
// Bound on the H100: instruction dispatch; the bytes (4 written per lane)
// do not count.  nvcc turns xoshiro128+'s five xors into three-input LOP3s
// and moves its shift and add onto the multiply-add pipe (IMAD), so a pi
// sample takes about 26 instructions, 13 of them on the integer pipe: the
// dispatch slots (128 lanes per SM) and the INT32 lanes (64) run out
// together.
//
// Two paths, chosen by shape in the wrapper
// (repro_torch/kernels/montecarlo.py:mc_plan), which passes each launcher
// its parameters:
//
// (a) A lane per thread (mc_kernel), in blocks of 128 threads, from
//     132 x 128 lanes on, where every scheduler of every SM holds a warp.
//     The three fp32 accumulators saturate past 2^24 hits exactly as the
//     TPU kernel's do.  Below that some SMs idle: at the facade's default
//     n_blocks = 8 this path has 8192 threads, one warp on each scheduler
//     of 64 SMs, and each lane's samples are sequential.
//
// (b) A lane's samples split over S segments (mc_segment_kernel), S a power
//     of two up to 32, for fewer lanes: the smallest S with about 2^16
//     threads, four warps a scheduler.  Segment s takes samples
//     [s*L, min((s+1)*L, iters)), L = ceil(iters / S); it starts from the
//     lane's state advanced 2*s*L generator steps (two draws a sample) by a
//     jump table built on the host: for the LCG the pair (A, C) of
//     state <- A*state + C mod 2^32, for xoshiro128+ the 128x128 GF(2)
//     matrix of the state transition raised to that power (the new state
//     is the xor of the matrix's columns at the old state's set bits).  The
//     matrix comes as 32 tables of 16 entries, one for each 4-bit nibble of
//     the state, each entry the xor of the 4 columns its bits select (8 KB
//     a segment): a jump is 32 table loads and 128 xors, where the 128
//     columns cost 128 loads, 512 xors and 128 bit tests, and the xors hold
//     the integer pipe, which the generator needs too.  A block is 32 lanes
//     x S segments: warp s runs segment s of all 32 lanes, so its table
//     loads fall in one 256-byte table at a time.  Each segment counts its
//     hits in three counters by the global sample index mod 3 (fp32, exact
//     below 2^24); the block adds the S counts of a lane in shared memory
//     in a fixed order, and the lane writes (a0 + a1) + a2 with
//     a_j = min(count_j, 2^24) as fp32.  That equals the lane path bit for
//     bit: every increment of an fp32 accumulator is 0 or 1, so after the
//     loop it holds exactly min(count, 2^24) (at 2^24, adding 1 rounds back
//     to 2^24, ties to even), and integer counts do not depend on the order
//     of the samples.
#include "common.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSegments = 32;

struct Lcg {
  // A jump: (A, C), state <- A*state + C mod 2^32.
  static constexpr int kJumpWords = 2;
  uint32_t s;
  __device__ explicit Lcg(uint32_t base) : s(copift::splitmix32(base)) {}
  __device__ __forceinline__ uint32_t next() {
    s = s * copift::kLcgA + copift::kLcgC;
    return (s >> 9) ^ s;
  }
  __device__ __forceinline__ void jump(const uint32_t* __restrict__ t) {
    s = __ldg(t) * s + __ldg(t + 1);
  }
};

struct Xoshiro128p {
  // A jump: the transition matrix's power M as 32 tables of 16 entries of
  // 4 words, entry v of table p the xor of M's columns 4p .. 4p + 3 that v's
  // bits select (column 32*w + b is the image of bit b of word w).
  static constexpr int kJumpWords = 32 * 16 * 4;
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
  // The new state is the xor of M's columns at the old state's set bits:
  // one table entry for each of its 32 nibbles.
  __device__ __forceinline__ void jump(const uint32_t* __restrict__ t) {
    const uint4* __restrict__ tables = reinterpret_cast<const uint4*>(t);
    const uint32_t w[4] = {s0, s1, s2, s3};
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 c =
            __ldg(tables + 16 * (8 * k + q) + ((w[k] >> (4 * q)) & 15u));
        r0 ^= c.x;
        r1 ^= c.y;
        r2 ^= c.z;
        r3 ^= c.w;
      }
    }
    s0 = r0;
    s1 = r1;
    s2 = r2;
    s3 = r3;
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

// Block b holds lanes 32b .. 32b + 31 and S = blockDim.x / 32 segments of
// each; jump holds S entries of Gen::kJumpWords words, entry s the jump of
// 2*s*seg_len steps.  counts (dynamic shared memory) is [3][S][32].
template <bool kPi, typename Gen>
__global__ void __launch_bounds__(32 * kMaxSegments)
    mc_segment_kernel(float* __restrict__ out, uint32_t seed, int64_t iters,
                      int64_t seg_len, const uint32_t* __restrict__ jump) {
  extern __shared__ uint32_t counts[];
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int segments = blockDim.x >> 5;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  Gen gen(static_cast<uint32_t>(g) + seed);
  gen.jump(jump + s * Gen::kJumpWords);
  const int64_t lo = s * seg_len < iters ? s * seg_len : iters;
  const int64_t hi = lo + seg_len < iters ? lo + seg_len : iters;
  const uint32_t len = static_cast<uint32_t>(hi - lo);
  // A segment's counts stay below 2^24 (seg_len <= 2^24), so fp32 holds
  // them exactly; the adds run on the FMA pipe, as the lane kernel's do,
  // and leave the integer pipe to the generator.
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  uint32_t t = 0;
  for (; t + 3 <= len; t += 3) {
    f0 += sample<kPi>(gen);
    f1 += sample<kPi>(gen);
    f2 += sample<kPi>(gen);
  }
  if (t < len) f0 += sample<kPi>(gen);
  if (t + 1 < len) f1 += sample<kPi>(gen);
  const uint32_t q0 = static_cast<uint32_t>(f0);
  const uint32_t q1 = static_cast<uint32_t>(f1);
  const uint32_t q2 = static_cast<uint32_t>(f2);
  // Local sample t is global sample lo + t: rotate the counts so that c_j
  // counts the samples i = j mod 3.
  const int r = static_cast<int>(lo % 3);
  const uint32_t c0 = r == 0 ? q0 : r == 1 ? q2 : q1;
  const uint32_t c1 = r == 0 ? q1 : r == 1 ? q0 : q2;
  const uint32_t c2 = r == 0 ? q2 : r == 1 ? q1 : q0;
  counts[(0 * segments + s) * 32 + lane] = c0;
  counts[(1 * segments + s) * 32 + lane] = c1;
  counts[(2 * segments + s) * 32 + lane] = c2;
  __syncthreads();
  if (s == 0) {
    uint64_t n0 = 0, n1 = 0, n2 = 0;
    for (int k = 0; k < segments; ++k) {
      n0 += counts[(0 * segments + k) * 32 + lane];
      n1 += counts[(1 * segments + k) * 32 + lane];
      n2 += counts[(2 * segments + k) * 32 + lane];
    }
    constexpr uint64_t kSat = 1u << 24;  // where an fp32 count stops at
    const float a0 = static_cast<float>(n0 < kSat ? n0 : kSat);
    const float a1 = static_cast<float>(n1 < kSat ? n1 : kSat);
    const float a2 = static_cast<float>(n2 < kSat ? n2 : kSat);
    out[g] = (a0 + a1) + a2;
  }
}

template <bool kPi, typename Gen>
void launch(float* out, int64_t n_lanes, uint32_t seed, int64_t iters,
            cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n_lanes + kThreads - 1) / kThreads);
  mc_kernel<kPi, Gen><<<blocks, kThreads, 0, stream>>>(out, n_lanes, seed,
                                                       iters);
}

template <bool kPi, typename Gen>
void launch_segments(float* out, int64_t n_lanes, uint32_t seed,
                     int64_t iters, int segments, int64_t seg_len,
                     const uint32_t* jump, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>(n_lanes / 32);
  const size_t smem = 3 * sizeof(uint32_t) * 32 * segments;
  mc_segment_kernel<kPi, Gen><<<blocks, 32 * segments, smem, stream>>>(
      out, seed, iters, seg_len, jump);
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

// The same with the segment path: S = segments in {1, 2, 4, 8, 16, 32},
// seg_len = ceil(iters / S) at most 2^24, jump the S entries of the table
// (2 words an entry for the LCG, 512 for xoshiro128+, 16-byte aligned).
// n_lanes must be a positive multiple of 32, at most 2^32.  Refuses other
// arguments with cudaErrorInvalidValue.
extern "C" int copift_mc_seg_f32(float* out, int64_t n_lanes, uint32_t seed,
                                 int kind, int problem, int64_t iters,
                                 int segments, int64_t seg_len,
                                 const uint32_t* jump, cudaStream_t stream) {
  const bool pow2 = segments > 0 && (segments & (segments - 1)) == 0;
  if (n_lanes <= 0 || n_lanes % 32 || n_lanes > (int64_t{1} << 32) ||
      (kind != 0 && kind != 1) || (problem != 0 && problem != 1) ||
      !pow2 || segments > kMaxSegments || iters < 0 ||
      seg_len != (iters + segments - 1) / segments ||
      seg_len > (int64_t{1} << 24) || jump == nullptr ||
      reinterpret_cast<uintptr_t>(jump) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind == 0 && problem == 0) {
    launch_segments<true, Lcg>(out, n_lanes, seed, iters, segments, seg_len,
                               jump, stream);
  } else if (kind == 0) {
    launch_segments<false, Lcg>(out, n_lanes, seed, iters, segments, seg_len,
                                jump, stream);
  } else if (problem == 0) {
    launch_segments<true, Xoshiro128p>(out, n_lanes, seed, iters, segments,
                                       seg_len, jump, stream);
  } else {
    launch_segments<false, Xoshiro128p>(out, n_lanes, seed, iters, segments,
                                        seg_len, jump, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
