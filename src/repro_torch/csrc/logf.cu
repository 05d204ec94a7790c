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
// src/repro/kernels/ops.py:log does before the TPU kernel; NaN passes
// through.  Denormals are not flushed (no -ftz), so a positive denormal gives
// a finite value that is not its log: the kernel's domain is positive
// normals, as the TPU kernel's is.
//
// The tables: each block copies both (32 floats, from the wrapper's device
// copy of repro_torch/kernels/ref.py's tables) into shared memory once.  A
// warp's 32 lanes then read at most 16 distinct words, which lie in 16
// distinct banks, so the gather costs one shared-memory access without
// conflicts.  In __constant__ memory the same reads would be serialised, one
// per distinct address.
//
// FMA contraction is left on (nvcc's default): r = z*invc - 1, the Horner
// steps and k*ln2 may fuse.  The plain version rounds every product; the two
// agree within the rtol 1e-5 / atol 1e-6 of the JAX package's kernel tests.
//
// Bound on the H100: device-memory bytes.  Each element is read once and
// written once (8 bytes) for about 18 instructions, 6 of them on the integer
// pipe.  Consecutive threads touch consecutive elements, so every
// warp's loads and stores are coalesced, and the grid-stride loop covers any
// n with no padding.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 16;
constexpr uint32_t kOff = 0x3f330000u;
constexpr float kLn2 = 0x1.62e43p-1f;
constexpr float kC4 = -0x1p-2f;        // -1/4
constexpr float kC3 = 0x1.555556p-2f;  // 1/3 in fp32
constexpr float kC2 = -0x1p-1f;        // -1/2

__device__ __forceinline__ float log_phases(float x, const float* invc_t,
                                            const float* logc_t) {
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
  const float invc = invc_t[i];
  const float logc = logc_t[i];
  // --- FP phase 1.
  const float r = z * invc - 1.f;
  float p = kC4;
  p = p * r + kC3;
  p = p * r + kC2;
  const float y = (p * r + 1.f) * r;
  return (y + logc) + static_cast<float>(k) * kLn2;
}

__global__ void log_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int64_t n, const float* __restrict__ invc,
                           const float* __restrict__ logc) {
  __shared__ float invc_s[kTable];
  __shared__ float logc_s[kTable];
  if (threadIdx.x < kTable) {
    invc_s[threadIdx.x] = invc[threadIdx.x];
    logc_s[threadIdx.x] = logc[threadIdx.x];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    y[j] = log_phases(x[j], invc_s, logc_s);
  }
}

}  // namespace

// y[j] = log(x[j]) for j < n, on the given stream; invc and logc are the two
// 16-entry fp32 tables on the device.  Returns the launch's cudaError_t as an
// int (0 on success).
extern "C" int copift_log_f32(const float* x, float* y, int64_t n,
                              const float* invc, const float* logc,
                              cudaStream_t stream) {
  if (n > 0) {
    log_kernel<<<grid_stride_blocks(n, kThreads), kThreads, 0, stream>>>(
        x, y, n, invc, logc);
  }
  return static_cast<int>(cudaGetLastError());
}
