// The paper's generators as device functions, shared by prng.cu and
// montecarlo.cu.  All arithmetic is uint32 with its wraparound, as in
// src/repro/kernels/prng.py and src/repro/kernels/montecarlo.py, so the bits
// equal the TPU kernels' exactly.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace copift {

constexpr uint32_t kPhi = 0x9e3779b9u;
constexpr uint32_t kLcgA = 1664525u;
constexpr uint32_t kLcgC = 1013904223u;

// Seed expander: decorrelates the streams of neighbouring lanes.
__device__ __forceinline__ uint32_t splitmix32(uint32_t z) {
  z += kPhi;
  z = (z ^ (z >> 16)) * 0x85ebca6bu;
  z = (z ^ (z >> 13)) * 0xc2b2ae35u;
  return z ^ (z >> 16);
}

// The top 24 bits as an fp32 value in [0, 1); the conversion and the scale
// are both exact.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * 0x1p-24f;
}

}  // namespace copift
