// Two designs of the COPIFT exp kernel that src/repro_torch/csrc/expf.cu
// does not ship, kept so that tools/exp_variants.py can time them beside
// the shipped kernel and torch.exp on the same card in one run.
//
// - occupancy: a grid of (resident blocks an SM x the SM count) 256-thread
//   blocks, each thread striding over the float4s with 4 loads in flight.
// - tma: the same grid size, each block a persistent ring of kStages
//   shared-memory stages of 16 KB, filled by cp.async.bulk (TMA) behind one
//   mbarrier each; the block's threads compute from a full stage and store
//   to device memory, then thread 0 refills the stage.
//
// Both take x and y 16-byte aligned and n a multiple of 4 (n4 float4s).
#include <cstdint>

#include <cuda_runtime.h>

#include "copift_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kStages = 4;
constexpr int kStageF4 = 1024;  // float4s a stage: 16 KB

__device__ __forceinline__ float4 exp4(float4 v) {
  v.x = copift::exp_phases(v.x, true);
  v.y = copift::exp_phases(v.y, true);
  v.z = copift::exp_phases(v.z, true);
  v.w = copift::exp_phases(v.w, true);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    exp_occupancy(const float4* __restrict__ x, float4* __restrict__ y,
                  int64_t n4) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = exp4(v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = v[u];
  }
  for (; i < n4; i += stride) y[i] = exp4(x[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kThreads)
    exp_tma(const float4* __restrict__ x, float4* __restrict__ y, int64_t n4) {
  extern __shared__ float4 stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int64_t chunks = (n4 + kStageF4 - 1) / kStageF4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int64_t c, int s) {
    const int64_t count =
        min(static_cast<int64_t>(kStageF4), n4 - c * kStageF4);
    const uint32_t bytes = static_cast<uint32_t>(count * 16);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(&full[s])), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(stage + s * kStageF4)), "l"(x + c * kStageF4),
           "r"(bytes), "r"(smem_addr(&full[s])) : "memory");
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int64_t c = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (c < chunks) fill(c, s);
    }
  }
  int s = 0;
  uint32_t phase = 0;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(&full[s])), "r"(phase) : "memory");
    }
    const int64_t count =
        min(static_cast<int64_t>(kStageF4), n4 - c * kStageF4);
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      y[c * kStageF4 + i] = exp4(stage[s * kStageF4 + i]);
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int64_t next = c + static_cast<int64_t>(kStages) * gridDim.x;
      if (next < chunks) fill(next, s);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <typename K>
int resident_grid(K kernel, int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  }
  *grid = sms * per_sm;
  return static_cast<int>(e);
}

}  // namespace

extern "C" int exp_variant_occupancy(const float* x, float* y, int64_t n4,
                                     cudaStream_t stream) {
  int grid = 0;
  if (int e = resident_grid(exp_occupancy, 0, &grid)) return e;
  exp_occupancy<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int exp_variant_tma(const float* x, float* y, int64_t n4,
                               cudaStream_t stream) {
  const int smem = kStages * kStageF4 * 16;
  cudaError_t e = cudaFuncSetAttribute(
      exp_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = 0;
  if (int r = resident_grid(exp_tma, smem, &grid)) return r;
  exp_tma<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}
