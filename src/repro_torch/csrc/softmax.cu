// COPIFT row softmax over a (rows, cols) fp32 or bf16 matrix.
//
// Replaces src/repro/kernels/softmax_tpu.py:_softmax_kernel (via
// softmax_2d).  The TPU kernel holds a (block_rows, cols) block in VMEM and
// so limits cols; here one thread block of 256 threads owns one row and
// makes three sweeps over it in device memory:
//   1. the row max (warp shuffles, then shared memory across the warps);
//   2. the sum of exp(x - max);
//   3. exp(x - max) / sum, with the exp computed again, so a bf16 output is
//      rounded once, from fp32, and never stored and rescaled.
// No shared memory is spent per column, so rows of any length run.  This is
// the two-pass fallback for long rows that the TPU kernel's docstring
// promises.
//
// Compute is fp32 whatever the input type, and the output has the input's
// type, as in the TPU kernel.  The division is IEEE (__fdiv_rn), not a
// multiply by 1/sum.  NaN inputs are outside the contract: fmaxf drops a NaN
// where the TPU kernel's max would keep it.
//
// Bound on the H100: device-memory bytes.  The function reads each element
// once and writes it once; sweeps 2 and 3 read the row again, which the
// 50 MB L2 serves for the row lengths attention produces.
#include <cuda_bf16.h>

#include "common.cuh"
#include "copift_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

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
int launch(const T* x, T* y, int64_t rows, int64_t cols, cudaStream_t stream) {
  if (rows > 0 && cols > 0) {
    softmax_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
        x, y, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row softmax of a contiguous (rows, cols) matrix into y, on the given
// stream.  rows must be below 2^31 (one block per row; the wrapper checks).
// Each returns the launch's cudaError_t as an int (0 on success).
extern "C" int copift_softmax_f32(const float* x, float* y, int64_t rows,
                                  int64_t cols, cudaStream_t stream) {
  return launch(x, y, rows, cols, stream);
}

extern "C" int copift_softmax_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                   int64_t rows, int64_t cols,
                                   cudaStream_t stream) {
  return launch(x, y, rows, cols, stream);
}
