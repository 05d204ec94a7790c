// COPIFT row softmax over a (rows, cols) fp32 or bf16 matrix.
//
// Replaces src/repro/kernels/softmax_tpu.py:_softmax_kernel (via
// softmax_2d).  The TPU kernel holds a (block_rows, cols) block in VMEM,
// takes the row max and sum on the VPU and so limits cols to what VMEM
// holds.  On the H100 the limit is device-memory bytes: the function reads
// each element once and writes it once (8 bytes an element in fp32, 4 in
// bf16) for about 30 instructions, far below the ~20 instructions per byte
// at which the fp32 units would bind.  A kernel reaches that bound only if
// it reads the row once, keeps the card's 132 SMs busy, and does not spend
// its time on barriers and block turnover.  Three paths, chosen by shape in
// the wrapper (repro_torch/kernels/softmax.py:softmax_plan), which passes
// each launcher its parameters:
//
// (a) Warp per row, cols <= 1024 (every serving softmax of short requests:
//     prefill 8192x161, decode 64x161).  A 256-thread block holds 8 rows,
//     one per warp.  Lane l reads columns l, l+32, ... once into registers
//     (kPer values a lane, kPer in {1, 2, 4, 8, 16, 32}); the max and the
//     sum are __shfl_xor_sync butterflies, so there is no shared memory and
//     no __syncthreads.  Rows of 161 fp32 are not 16-byte aligned, so the
//     loads are 4-byte, coalesced across the warp.
//
// (b) A thread block cluster per row, 1024 < cols <= 464,384: 8 slices of
//     58,048 fp32 values, what a block's 232,448 bytes of shared memory hold
//     beside kSlotBytes of reduction slots.  k blocks (k in {1, 2, 4, 8},
//     the cluster size, set at launch with cudaLaunchKernelEx) each copy one
//     slice of the row into dynamic shared memory, as fp32, with kLoads
//     loads a thread in flight.  They exchange partial maxima and then
//     partial sums through distributed shared memory (cluster.sync, then
//     lane r of warp 0 reads block r's slot with map_shared_rank); every
//     block combines the k partials itself, in rank order, so the row sum
//     is the same in every block and from run to run.  Each block writes
//     exp(x - max) over its slice in shared memory once, then e / sum to
//     device memory: the row is read from device memory once and written
//     once.  The last cluster barrier is split (arrive before the writes,
//     wait after them).  The slice is copied with 16-byte vector loads
//     through registers where cols and both pointers allow it (4-byte loads
//     otherwise), not with a TMA bulk copy: the max is taken on the way in
//     and bf16 is widened to fp32 there, and a TMA copy would need a second
//     pass over shared memory for both.
//
// (c) Three sweeps, one 256-thread block per row, for rows longer than (b)
//     holds in shared memory: the row max, the sum of exp(x - max), then
//     exp(x - max) / sum, each sweep over device memory (the L2 serves
//     sweeps 2 and 3 for rows of a few MB).  No shared memory is spent per
//     column, so rows of any length run; a few rows use only as many SMs.  This path, chosen by shape and
//     never after a failure, is the port's answer to the "two-pass
//     fallback" for long rows that the TPU kernel's docstring promises.
//
// Compute is fp32 whatever the input type, and the output has the input's
// type, as in the TPU kernel.  exp(x - max) is computed once an element in
// (a) and (b) and kept in fp32, so a bf16 output is rounded once, from
// fp32.  The division is IEEE (__fdiv_rn), not a multiply by 1/sum.  NaN
// inputs are outside the contract: fmaxf drops a NaN where the TPU kernel's
// max would keep it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "copift_exp.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

// 16 bytes of T as fp32 values, and back.
template <typename T>
constexpr int kVecElems = 16 / sizeof(T);

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  }
  *reinterpret_cast<uint4*>(p) = q;
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// Butterfly over the warp.  At each step the two lanes of a pair add the
// same two values, so every lane ends with the same bits.
template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// ---------------------------------------------------------------------------
// (a) warp per row
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 256;
constexpr int kRowsPerBlock = kWarpThreads / 32;

template <typename T, int kPer>
__global__ void __launch_bounds__(kWarpThreads)
    softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int64_t rows, int cols) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp leaves: no shuffle is left short
  const int lane = threadIdx.x % 32;
  const T* in = x + row * cols;
  T* out = y + row * cols;

  float v[kPer];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cols ? to_f32(in[c]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = warp_reduce<true>(m);

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < cols ? copift::exp_phases(v[i] - m, /*clamp_hi=*/false) : 0.f;
    sum += v[i];
  }
  sum = warp_reduce<false>(sum);

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) store(out + c, __fdiv_rn(v[i], sum));
  }
}

template <typename T, int kPer>
int launch_warp_as(const T* x, T* y, int64_t rows, int cols,
                   cudaStream_t stream) {
  const unsigned int grid =
      static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  softmax_warp_kernel<T, kPer><<<grid, kWarpThreads, 0, stream>>>(x, y, rows,
                                                                  cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_warp(const T* x, T* y, int64_t rows, int64_t cols, int per_lane,
                cudaStream_t stream) {
  if (cols > 32 * static_cast<int64_t>(per_lane)) return cudaErrorInvalidValue;
  const int c = static_cast<int>(cols);
  switch (per_lane) {
    case 1: return launch_warp_as<T, 1>(x, y, rows, c, stream);
    case 2: return launch_warp_as<T, 2>(x, y, rows, c, stream);
    case 4: return launch_warp_as<T, 4>(x, y, rows, c, stream);
    case 8: return launch_warp_as<T, 8>(x, y, rows, c, stream);
    case 16: return launch_warp_as<T, 16>(x, y, rows, c, stream);
    case 32: return launch_warp_as<T, 32>(x, y, rows, c, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// (b) a thread block cluster per row
// ---------------------------------------------------------------------------

constexpr int kMaxClusterThreads = 1024;
// Shared memory a block may use on the H100 (static and dynamic together),
// and the part of it this kernel keeps for its reduction slots.
constexpr int kSmemPerBlock = 232448;
constexpr int kSlotBytes = 256;
// 16-byte loads a thread issues before it uses any (scalar loads: that many
// times 16 / sizeof(T)).
constexpr int kLoads = 4;

// Reduces v over the block into *slot.  The caller's next barrier (a
// cluster.sync) publishes it.  The order is fixed, so the result repeats.
template <bool kMax>
__device__ void block_reduce_into(float v, float* part, float* slot) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = warp_reduce<kMax>(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    v = lane < warps ? part[lane] : (kMax ? -INFINITY : 0.f);
    v = warp_reduce<kMax>(v);
    if (lane == 0) *slot = v;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxClusterThreads)
    softmax_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                           int64_t cols, int slice, int k) {
  extern __shared__ float4 smem[];
  float* buf = reinterpret_cast<float*>(smem);
  __shared__ float part[32];
  __shared__ float partial[2];  // this block's max and sum, read by the cluster
  __shared__ float total[2];    // the row's max and sum
  static_assert(sizeof(float) * (32 + 2 + 2) <= kSlotBytes, "slots");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / k;
  const int64_t lo = static_cast<int64_t>(rank) * slice;
  const int64_t left = cols - lo;
  const int n = left <= 0 ? 0 : (left < slice ? static_cast<int>(left) : slice);
  const T* in = x + row * cols + lo;
  T* out = y + row * cols + lo;
  constexpr int V = kVecElems<T>;

  // Copy the slice into shared memory as fp32, taking its max on the way.
  // A thread issues kLoads loads before it uses any of them.
  float m = -INFINITY;
  if (kVec) {
    const int step = blockDim.x * V;
    for (int base = threadIdx.x * V; base < n; base += kLoads * step) {
      float v[kLoads][V];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (base + u * step < n) load16(in + base + u * step, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * step;
        if (i < n) {
#pragma unroll
          for (int j = 0; j < V; ++j) m = fmaxf(m, v[u][j]);
#pragma unroll
          for (int j = 0; j < V; j += 4) store16(buf + i + j, v[u] + j);
        }
      }
    }
  } else {
    const int step = blockDim.x;
    for (int base = threadIdx.x; base < n; base += kLoads * V * step) {
      float v[kLoads * V];
#pragma unroll
      for (int u = 0; u < kLoads * V; ++u) {
        const int i = base + u * step;
        v[u] = i < n ? to_f32(in[i]) : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kLoads * V; ++u) {
        const int i = base + u * step;
        if (i < n) buf[i] = v[u];
        m = fmaxf(m, v[u]);
      }
    }
  }
  block_reduce_into<true>(m, part, &partial[0]);
  cluster.sync();
  // Lane r of warp 0 reads block r's partial: the k reads of distributed
  // shared memory are in flight together.
  if (threadIdx.x < 32) {
    float v = threadIdx.x < k
                  ? *cluster.map_shared_rank(&partial[0], threadIdx.x)
                  : -INFINITY;
    v = warp_reduce<true>(v);
    if (threadIdx.x == 0) total[0] = v;
  }
  __syncthreads();
  m = total[0];

  // exp(x - max) over the slice, once, kept in shared memory in fp32.
  float s = 0.f;
  if (kVec) {  // n is a multiple of 4
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
      float4 q = *reinterpret_cast<const float4*>(buf + i);
      q.x = copift::exp_phases(q.x - m, /*clamp_hi=*/false);
      q.y = copift::exp_phases(q.y - m, /*clamp_hi=*/false);
      q.z = copift::exp_phases(q.z - m, /*clamp_hi=*/false);
      q.w = copift::exp_phases(q.w - m, /*clamp_hi=*/false);
      *reinterpret_cast<float4*>(buf + i) = q;
      s += q.x;
      s += q.y;
      s += q.z;
      s += q.w;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float e = copift::exp_phases(buf[i] - m, /*clamp_hi=*/false);
      buf[i] = e;
      s += e;
    }
  }
  block_reduce_into<false>(s, part, &partial[1]);
  cluster.sync();
  if (threadIdx.x < 32) {
    const float v = threadIdx.x < k
                        ? *cluster.map_shared_rank(&partial[1], threadIdx.x)
                        : 0.f;
    float ss = 0.f;
    for (int r = 0; r < k; ++r) ss += __shfl_sync(0xffffffffu, v, r);
    if (threadIdx.x == 0) total[1] = ss;  // the partials added in rank order
  }
  __syncthreads();
  // This block reads no other block's shared memory from here on.  It
  // arrives at the cluster barrier now and waits at the end, so that no
  // block leaves while another still reads its partial sum, and the
  // writes below do not wait for the slowest block's reads.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  s = total[1];

  if (kVec) {
    for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = __fdiv_rn(buf[i + j], s);
      store16(out + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      store(out + i, __fdiv_rn(buf[i], s));
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
int launch_cluster(const T* x, T* y, int64_t rows, int64_t cols, int cluster,
                   int slice, int threads, int smem_bytes, int vec,
                   cudaStream_t stream) {
  const bool sizes_ok =
      (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
      static_cast<int64_t>(cluster) * slice >= cols && slice % 8 == 0 &&
      smem_bytes >= 4 * slice && smem_bytes + kSlotBytes <= kSmemPerBlock &&
      threads % 32 == 0 && threads > 0 && threads <= kMaxClusterThreads;
  const bool vec_ok =
      !vec || (cols % kVecElems<T> == 0 &&
               (reinterpret_cast<uintptr_t>(x) |
                reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  if (!sizes_ok || !vec_ok) return cudaErrorInvalidValue;
  void (*kernel)(const T*, T*, int64_t, int, int) =
      vec ? &softmax_cluster_kernel<T, true>
          : &softmax_cluster_kernel<T, false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(rows * cluster));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, x, y, cols, slice,
                                          cluster);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// (c) three sweeps, one block per row
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Reduces v over the block; every thread receives the result.  Each of the
// two instantiations has its own shared memory, so the max and the sum of
// one row never share a buffer.
template <bool kMax>
__device__ float block_reduce(float v) {
  __shared__ float partial[kWarps];
  __shared__ float result;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = warp_reduce<kMax>(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : (kMax ? -INFINITY : 0.f);
    v = warp_reduce<kMax>(v);
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

template <typename T>
__global__ void softmax_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t cols) {
  const T* row = x + static_cast<int64_t>(blockIdx.x) * cols;
  T* out = y + static_cast<int64_t>(blockIdx.x) * cols;

  float m = -INFINITY;
  for (int64_t c = threadIdx.x; c < cols; c += kThreads) {
    m = fmaxf(m, to_f32(row[c]));
  }
  m = block_reduce<true>(m);

  float sum = 0.f;
  for (int64_t c = threadIdx.x; c < cols; c += kThreads) {
    sum += copift::exp_phases(to_f32(row[c]) - m, /*clamp_hi=*/false);
  }
  sum = block_reduce<false>(sum);

  for (int64_t c = threadIdx.x; c < cols; c += kThreads) {
    const float e = copift::exp_phases(to_f32(row[c]) - m, /*clamp_hi=*/false);
    store(out + c, __fdiv_rn(e, sum));
  }
}

template <typename T>
int launch_sweep(const T* x, T* y, int64_t rows, int64_t cols,
                 cudaStream_t stream) {
  softmax_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
      x, y, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row softmax of a contiguous (rows, cols) matrix into y, on the given
// stream, one launcher a path and type.  rows and cols are positive, and
// the grid (rows / 8 blocks for (a), rows * cluster for (b), rows for (c))
// stays below 2^31 (the wrapper's plan checks).  A launcher refuses
// parameters that do not fit its path with cudaErrorInvalidValue.  Each
// returns the launch's cudaError_t as an int (0 on success).
extern "C" int copift_softmax_warp_f32(const float* x, float* y, int64_t rows,
                                       int64_t cols, int per_lane,
                                       cudaStream_t stream) {
  return launch_warp(x, y, rows, cols, per_lane, stream);
}

extern "C" int copift_softmax_warp_bf16(const __nv_bfloat16* x,
                                        __nv_bfloat16* y, int64_t rows,
                                        int64_t cols, int per_lane,
                                        cudaStream_t stream) {
  return launch_warp(x, y, rows, cols, per_lane, stream);
}

extern "C" int copift_softmax_cluster_f32(const float* x, float* y,
                                          int64_t rows, int64_t cols,
                                          int cluster, int slice, int threads,
                                          int smem_bytes, int vec,
                                          cudaStream_t stream) {
  return launch_cluster(x, y, rows, cols, cluster, slice, threads, smem_bytes,
                        vec, stream);
}

extern "C" int copift_softmax_cluster_bf16(const __nv_bfloat16* x,
                                           __nv_bfloat16* y, int64_t rows,
                                           int64_t cols, int cluster,
                                           int slice, int threads,
                                           int smem_bytes, int vec,
                                           cudaStream_t stream) {
  return launch_cluster(x, y, rows, cols, cluster, slice, threads, smem_bytes,
                        vec, stream);
}

extern "C" int copift_softmax_sweep_f32(const float* x, float* y, int64_t rows,
                                        int64_t cols, cudaStream_t stream) {
  return launch_sweep(x, y, rows, cols, stream);
}

extern "C" int copift_softmax_sweep_bf16(const __nv_bfloat16* x,
                                         __nv_bfloat16* y, int64_t rows,
                                         int64_t cols, cudaStream_t stream) {
  return launch_sweep(x, y, rows, cols, stream);
}
