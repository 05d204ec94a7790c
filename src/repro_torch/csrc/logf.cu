// COPIFT log (glibc-logf style) over n fp32 values.
//
// Replaces src/repro/kernels/logf.py:_log_kernel (via log_2d), phase by
// phase:
//   INT phase 0  tmp = ix - 0x3f330000 (signed), the 4-bit table index
//                i = (tmp >> 19) & 15, the exponent k = tmp >> 23
//                (arithmetic shift) and the mantissa
//                z = ix - (tmp & 0xff800000);
//   gather       invc[i] and logc[i] from the 16-entry tables (the paper's
//                ISSR, the TPU kernel's one-vreg jnp.take);
//   FP phase 1   r = z*invc - 1, the degree-4 log1p Horner, + logc + k*ln2.
// Lanes with x <= 0 are mapped to 1.0 first (ln 1 = 0), as
// src/repro/kernels/ops.py:log does before the TPU kernel.  NaN and +inf do not
// pass through: their bits go through the same phases and give a finite value
// (about 89), as in the plain version and the TPU kernel.  Denormals are not
// flushed (no -ftz), so a positive denormal gives a finite value that is not
// its log: the kernel's domain is positive normals, as the TPU kernel's is.
//
// FMA contraction is left on (nvcc's default): r = z*invc - 1, the Horner
// steps and k*ln2 may fuse.  The plain version rounds every product; the two
// agree within the rtol 1e-5 / atol 1e-6 of the JAX package's kernel tests.
//
// Bound on the H100: device-memory bytes.  Each element is read once and
// written once (8 bytes) for about 18 instructions, 6 of them on the integer
// pipe.  As for exp (expf.cu), the card needs ~18 KB of loads in flight an
// SM to reach 3.35 TB/s, and a scalar loop with one 4-byte load a thread
// keeps 8 KB in flight.  So the vector kernel, which takes every input whose
// x and y are 16-byte aligned:
//   - loads float4s, kUnroll = 2 of them a thread before any compute (32
//     bytes in flight a thread, 64 KB an SM);
//   - gives each block one chunk of kUnroll float4s a thread (at the
//     default 256 threads, 512 float4s, 8 KB), so the grid is
//     n / (4 * kUnroll * threads) blocks and the block scheduler keeps every
//     SM full to the end;
//   - gives the last n % 4 elements (at most 3) to a scalar tail, which
//     reads the tables from device memory.
// Tiling.  The threads a block (a multiple of 32, 32 to 1024) are a launch
// argument of both kernels, the port's counterpart of the TPU kernel's
// block_rows: the wrapper (logf.py:log_plan) takes 256 x block_rows / 64
// threads, so the default 64 rows give 256.  Every Tables policy holds at
// any such size: SharedTables needs 16 threads to copy the tables,
// ShuffleTables one whole warp.  No value depends on the tiling.  Both
// kernels are built with __launch_bounds__(1024); ptxas gives them 32
// registers a thread, as at a bound of 256 (sm_90a, CUDA 12.8).
// The table gather is a policy of the vector kernel (Tables below).  With
// one chunk a block, a copy of the tables into shared memory behind a
// __syncthreads would happen once per 8 KB.  The vector kernel ships
// ShuffleTables: lane l of each warp loads entry l & 15 of both tables into
// registers once, and the gather is a __shfl_sync, with no barrier and no
// memory access.  tools/logf_variants.py times it beside the shared-memory
// copy (SharedTables) and __ldg from the device tables (LdgTables) on the
// same input in one run (PERF.md has the times).
//
// An input that is not 16-byte aligned takes the scalar grid-stride kernel
// (the port's first design), with the tables in shared memory: a warp's 32
// lanes read at most 16 distinct words, in 16 distinct banks, so the gather
// costs one shared-memory access without conflicts.  The wrapper
// (repro_torch/kernels/logf.py:log_plan) chooses by alignment alone.
#include "common.cuh"

namespace {

constexpr int kUnroll = 2;
constexpr int kTable = 16;
constexpr uint32_t kOff = 0x3f330000u;
constexpr float kLn2 = 0x1.62e43p-1f;
constexpr float kC4 = -0x1p-2f;        // -1/4
constexpr float kC3 = 0x1.555556p-2f;  // 1/3 in fp32
constexpr float kC2 = -0x1p-1f;        // -1/2

// The tables in shared memory: the block's first 16 threads copy them, and
// every thread waits at one barrier.  Every thread of the block must
// construct it; a block of 32 threads or more has the 16 copiers.
struct SharedTables {
  const float* invc;
  const float* logc;
  __device__ SharedTables(const float* __restrict__ invc_g,
                          const float* __restrict__ logc_g) {
    __shared__ float invc_s[kTable];
    __shared__ float logc_s[kTable];
    if (threadIdx.x < kTable) {
      invc_s[threadIdx.x] = invc_g[threadIdx.x];
      logc_s[threadIdx.x] = logc_g[threadIdx.x];
    }
    __syncthreads();
    invc = invc_s;
    logc = logc_s;
  }
  __device__ __forceinline__ float2 operator()(int i) const {
    return make_float2(invc[i], logc[i]);
  }
};

// The tables read from device memory through the read-only cache: a warp's
// gather touches at most 16 distinct words of one 64-byte line each.
struct LdgTables {
  const float* invc;
  const float* logc;
  __device__ LdgTables(const float* __restrict__ invc_g,
                       const float* __restrict__ logc_g)
      : invc(invc_g), logc(logc_g) {}
  __device__ __forceinline__ float2 operator()(int i) const {
    return make_float2(__ldg(invc + i), __ldg(logc + i));
  }
};

// Lane l holds invc[l & 15] and logc[l & 15]; the gather reads lane i.
// Every lane of the warp must reach each gather.
struct ShuffleTables {
  float invc;
  float logc;
  __device__ ShuffleTables(const float* __restrict__ invc_g,
                           const float* __restrict__ logc_g)
      : invc(__ldg(invc_g + (threadIdx.x & (kTable - 1)))),
        logc(__ldg(logc_g + (threadIdx.x & (kTable - 1)))) {}
  __device__ __forceinline__ float2 operator()(int i) const {
    return make_float2(__shfl_sync(0xffffffffu, invc, i),
                       __shfl_sync(0xffffffffu, logc, i));
  }
};

template <typename Tables>
__device__ __forceinline__ float log_phases(float x, const Tables& tables) {
  if (x <= 0.f) x = 1.f;
  // --- INT phase 0.  The subtractions are done in uint32 (no signed
  // overflow for any input); tmp is read back as int32, so k's shift is
  // arithmetic.
  const uint32_t ix = __float_as_uint(x);
  const int32_t tmp = static_cast<int32_t>(ix - kOff);
  const int i = (tmp >> 19) & (kTable - 1);
  const int k = tmp >> 23;
  const float z =
      __uint_as_float(ix - (static_cast<uint32_t>(tmp) & 0xff800000u));
  // --- gather.
  const float2 c = tables(i);
  // --- FP phase 1.
  const float r = z * c.x - 1.f;
  float p = kC4;
  p = p * r + kC3;
  p = p * r + kC2;
  const float y = (p * r + 1.f) * r;
  return (y + c.y) + static_cast<float>(k) * kLn2;
}

template <typename Tables>
__device__ __forceinline__ float4 log4(float4 v, const Tables& tables) {
  v.x = log_phases(v.x, tables);
  v.y = log_phases(v.y, tables);
  v.z = log_phases(v.z, tables);
  v.w = log_phases(v.w, tables);
  return v;
}

// y[i] = log(x[i]) over the n4 float4s of x, then the n - 4 * n4 scalars
// after them.  Every thread of a block reaches the Tables constructor and
// every gather (lanes past the end compute on 1.0), so a policy may hold a
// barrier or a warp shuffle.
template <typename Tables>
__global__ void __launch_bounds__(kMaxBlockThreads)
    log_vec_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int64_t n4, int64_t n, const float* __restrict__ invc,
                   const float* __restrict__ logc) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  const int64_t threads = blockDim.x;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kUnroll * threads + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    v[u] = base + u * threads < n4 ? x4[base + u * threads]
                                   : make_float4(1.f, 1.f, 1.f, 1.f);
  }
  const Tables tables(invc, logc);  // after the chunk's loads are issued
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) v[u] = log4(v[u], tables);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (base + u * threads < n4) y4[base + u * threads] = v[u];
  }
  const int64_t t =
      4 * n4 + static_cast<int64_t>(blockIdx.x) * threads + threadIdx.x;
  if (t < n) y[t] = log_phases(x[t], LdgTables(invc, logc));
}

__global__ void __launch_bounds__(kMaxBlockThreads)
    log_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n,
               const float* __restrict__ invc,
               const float* __restrict__ logc) {
  const SharedTables tables(invc, logc);
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    y[j] = log_phases(x[j], tables);
  }
}

// The vector kernel's launch with the Tables policy given; the checks of
// copift_log_vec_f32.
template <typename Tables>
int launch_vec(const float* x, float* y, int64_t n4, int64_t n, int threads,
               const float* invc, const float* logc, cudaStream_t stream) {
  if (!valid_block_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = static_cast<int64_t>(kUnroll) * threads;
  const int64_t grid = n4 > 0 ? (n4 + chunk - 1) / chunk : 1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 ||
      n4 < 0 || n - 4 * n4 < 0 || n - 4 * n4 > 3 || grid > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    log_vec_kernel<Tables><<<static_cast<unsigned int>(grid), threads, 0,
                             stream>>>(x, y, n4, n, invc, logc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y[j] = log(x[j]) for j < n, on the given stream: the scalar kernel, for
// any alignment, with `threads` a block (a multiple of 32, 32 to 1024;
// others are refused with cudaErrorInvalidValue); invc and logc are the two
// 16-entry fp32 tables on the device.  Returns the launch's cudaError_t as
// an int (0 on success).
extern "C" int copift_log_f32(const float* x, float* y, int64_t n,
                              int threads, const float* invc,
                              const float* logc, cudaStream_t stream) {
  if (!valid_block_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    log_kernel<<<grid_stride_blocks(n, threads), threads, 0, stream>>>(
        x, y, n, invc, logc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with the vector kernel: x and y 16-byte aligned, n4 = n / 4
// float4s, then the scalar tail, `threads` a block.  Refuses other
// arguments, and a grid beyond 2^31 - 1 blocks, with cudaErrorInvalidValue.
extern "C" int copift_log_vec_f32(const float* x, float* y, int64_t n4,
                                  int64_t n, int threads, const float* invc,
                                  const float* logc, cudaStream_t stream) {
  return launch_vec<ShuffleTables>(x, y, n4, n, threads, invc, logc, stream);
}
