// The COPIFT exp construction as a device function, shared by expf.cu and
// softmax.cu.  It computes what src/repro/kernels/expf.py:_exp_kernel and
// src/repro/kernels/softmax_tpu.py:_exp_phases compute, phase by phase:
//   FP phase 0   z = x*log2e, kd = round(z), Cody-Waite remainder r;
//   INT phase 1  2^kd assembled in the exponent field and bitcast to f32;
//   FP phase 2   degree-7 Horner polynomial in r, times the scale.
// The constants are the exact float32 values of repro_torch/kernels/ref.py,
// written as hexadecimal literals so that no decimal rounding intervenes.
//
// FMA contraction: this file is built with nvcc's default (--fmad=true), so
// the Cody-Waite steps and the Horner steps may become fused multiply-adds.
// The plain PyTorch version rounds every product; the two agree to the
// rtol 2e-6 that the JAX package's kernel tests set.
//
// Built without --use_fast_math on purpose: fast math flushes denormals to
// zero and approximates the division in softmax.cu.
#pragma once

#include <cmath>

namespace copift {

constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kP7 = 0x1.a01a02p-13f;  // 1/7!
constexpr float kP6 = 0x1.6c16c2p-10f;  // 1/6!
constexpr float kP5 = 0x1.111112p-7f;   // 1/5!
constexpr float kP4 = 0x1.555556p-5f;   // 1/4!
constexpr float kP3 = 0x1.555556p-3f;   // 1/3!
constexpr float kP2 = 0x1.0p-1f;        // 1/2!
constexpr float kP1 = 0x1.0p+0f;        // 1/1!

// clamp_hi selects the exp kernel's x > 88 -> inf; the softmax kernel's
// exp has no such clamp (its argument x - max is never positive).
__device__ __forceinline__ float exp_phases(float x, bool clamp_hi) {
  // --- FP phase 0.
  const float z = x * kLog2e;
  // Rounding: jnp.round rounds half to even, and so does rintf under the
  // default rounding mode; roundf would round half away from zero.
  const float kd = rintf(z);
  const float r = (x - kd * kLn2Hi) - kd * kLn2Lo;
  // --- INT phase 1.
  // Masked scores: attention's NEG_INF is -0.7*FLT_MAX, so for masked
  // entries z overflows to -inf, kd is -inf and r is NaN.  fmaxf/fminf clamp
  // kd into [-126, 127] before the conversion (and map a NaN to -126), so
  // the conversion never leaves the int32 range.
  const int ki = __float2int_rn(fminf(fmaxf(kd, -126.f), 127.f));
  const float s = __int_as_float((ki + 127) << 23);
  // --- FP phase 2.
  float p = kP7;
  p = p * r + kP6;
  p = p * r + kP5;
  p = p * r + kP4;
  p = p * r + kP3;
  p = p * r + kP2;
  p = p * r + kP1;
  float y = (p * r + 1.f) * s;
  if (clamp_hi && x > 88.f) y = INFINITY;
  // Masked scores: y is NaN there, and only this select turns them into 0,
  // so it stays last.
  return x < -87.f ? 0.f : y;
}

}  // namespace copift
