// COPIFT exp over n fp32 values.
//
// Replaces src/repro/kernels/expf.py:_exp_kernel (via exp_2d).  The TPU
// kernel works on (rows, 1024) vreg tiles and needs its input padded to
// them; here one grid-stride loop covers any n, with no padding.
//
// Bound on the H100: device-memory bytes.  Each element is read once and
// written once (8 bytes) for about 25 floating-point and integer
// operations, far below the ~20 operations per byte at which the fp32
// units would become the limit.  Consecutive threads touch consecutive
// elements, so every warp's loads and stores are coalesced.
#include "common.cuh"
#include "copift_exp.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void exp_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = copift::exp_phases(x[i], /*clamp_hi=*/true);
  }
}

}  // namespace

// y[i] = exp(x[i]) for i < n, on the given stream.  Returns the launch's
// cudaError_t as an int (0 on success).
extern "C" int copift_exp_f32(const float* x, float* y, int64_t n,
                              cudaStream_t stream) {
  if (n > 0) {
    exp_kernel<<<grid_stride_blocks(n, kThreads), kThreads, 0, stream>>>(x, y,
                                                                          n);
  }
  return static_cast<int>(cudaGetLastError());
}
