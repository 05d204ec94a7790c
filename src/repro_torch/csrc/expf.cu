// COPIFT exp over n fp32 values.
//
// Replaces src/repro/kernels/expf.py:_exp_kernel (via exp_2d).  The TPU
// kernel works on (rows, 1024) vreg tiles and needs its input padded to
// them; here any n runs, with no padding.
//
// Bound on the H100: device-memory bytes.  Each element is read once and
// written once (8 bytes) for about 25 floating-point and integer
// operations, far below the ~20 operations per byte at which the fp32
// units would become the limit.  To reach 3.35 TB/s the card needs about
// 3.35 TB/s x 0.7 us of latency = 2.3 MB of loads in flight, ~18 KB an SM
// (Little's law).  A scalar loop with one 4-byte load in flight per thread,
// 2,048 threads an SM, keeps only 8 KB in flight.  So the vector kernel,
// which takes every input whose x and y are 16-byte aligned:
//   - loads float4s, 16 bytes a thread and load instruction;
//   - issues kUnroll = 2 of them before any compute, then stores 2 float4s:
//     32 bytes in flight a thread, 64 KB an SM;
//   - gives each 256-thread block one chunk of 512 float4s (8 KB), so the
//     grid is n / 2048 blocks and the block scheduler keeps every SM full
//     to the end;
//   - gives the last n % 4 elements (at most 3) to a scalar tail.
// A warp's loads and stores cover 512 contiguous bytes, so they coalesce.
// Two other designs measured slower at 16 M values on the H100
// (tools/exp_variants.py compares them with this one and torch.exp in one
// run): a grid sized from occupancy (resident blocks an SM x the SM count)
// with a grid-stride loop of 4 float4s, and a persistent ring of TMA bulk
// copies (cp.async.bulk into 4 shared-memory stages behind mbarriers).
//
// An input that is not 16-byte aligned (a contiguous view at an odd
// offset) takes the scalar grid-stride kernel.  The wrapper
// (repro_torch/kernels/expf.py:exp_plan) chooses by alignment alone.
#include "common.cuh"
#include "copift_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int64_t kChunk = kThreads * kUnroll;  // float4s a block takes

__device__ __forceinline__ float4 exp4(float4 v) {
  v.x = copift::exp_phases(v.x, /*clamp_hi=*/true);
  v.y = copift::exp_phases(v.y, /*clamp_hi=*/true);
  v.z = copift::exp_phases(v.z, /*clamp_hi=*/true);
  v.w = copift::exp_phases(v.w, /*clamp_hi=*/true);
  return v;
}

// y[i] = exp(x[i]) over the n4 float4s of x, then the n - 4 * n4 scalars
// after them.
__global__ void __launch_bounds__(kThreads)
    exp_vec_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int64_t n4, int64_t n) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  const int64_t base = blockIdx.x * kChunk + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (base + u * kThreads < n4) v[u] = x4[base + u * kThreads];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) v[u] = exp4(v[u]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (base + u * kThreads < n4) y4[base + u * kThreads] = v[u];
  }
  const int64_t t = 4 * n4 + static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (t < n) y[t] = copift::exp_phases(x[t], /*clamp_hi=*/true);
}

__global__ void exp_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = copift::exp_phases(x[i], /*clamp_hi=*/true);
  }
}

}  // namespace

// y[i] = exp(x[i]) for i < n, on the given stream: the scalar kernel, for
// any alignment.  Returns the launch's cudaError_t as an int (0 on
// success).
extern "C" int copift_exp_f32(const float* x, float* y, int64_t n,
                              cudaStream_t stream) {
  if (n > 0) {
    exp_kernel<<<grid_stride_blocks(n, kThreads), kThreads, 0, stream>>>(x, y,
                                                                          n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with the vector kernel: x and y 16-byte aligned, n4 = n / 4
// float4s, then the scalar tail.  Refuses other arguments, and a grid
// beyond 2^31 - 1 blocks (n beyond 2^42), with cudaErrorInvalidValue.
extern "C" int copift_exp_vec_f32(const float* x, float* y, int64_t n4,
                                  int64_t n, cudaStream_t stream) {
  const int64_t grid = n4 > 0 ? (n4 + kChunk - 1) / kChunk : 1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 ||
      n4 < 0 || n - 4 * n4 < 0 || n - 4 * n4 > 3 || grid > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    exp_vec_kernel<<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
        x, y, n4, n);
  }
  return static_cast<int>(cudaGetLastError());
}
