// Counter-based uniforms in [0, 1): one thread per element.
//
// Replaces src/repro/kernels/prng.py:_uniform_kernel (via uniform_2d).
// copift_uniform_rows_f32 draws many streams in one launch, a row each, from
// seeds in device memory (the serving engine's sampler: a row a slot, one
// launch a step, inside a CUDA graph).
// Element i draws from its own stream: the counter (uint32)i + seed, wrapping
// mod 2^32, seeds splitmix32, and the generator takes one step:
//   LCG         state*A + C, output (new >> 9) ^ new;
//   xoshiro128+ first output s0 + s3 of the splitmix-seeded words
//               (the words s1 and s2 do not enter it).
// The top 24 bits scale to [0, 1).  All integer arithmetic is uint32 with
// its wraparound, so the bits equal the TPU kernel's exactly.
//
// Bound on the H100: device-memory bytes, 4 written per element.  xoshiro128+
// comes closest to the integer limit: its two splitmix32 calls take about 24
// instructions per element, 16 of them shifts, logic and adds that only the
// integer pipe runs, and an SM has 64 INT32 lanes against 128 FP32 lanes;
// those 16 take 80 % of the time the 4 bytes do.  splitmix32 lives in
// prng.cuh, shared with montecarlo.cu.  The TPU kernel's (rows, 1024) tiling
// and the padding it needs are gone: the grid-stride loop covers any n.
//
// Tiling.  The threads a block (a multiple of 32, 32 to 1024) are a launch
// argument, the port's counterpart of the TPU kernel's block_rows: the
// wrapper (prng.py:uniform_plan) takes 256 x block_rows / 64 threads, so
// the default 64 rows give 256.  The grid keeps its cap of 132 x 16 blocks.
// The counter is the element index i at any tiling, never an offset of the
// block, so no bit depends on it.  Built with __launch_bounds__(1024): ptxas
// gives 26 registers a thread (28 at a bound of 256; sm_90a, CUDA 12.8).
#include "common.cuh"
#include "prng.cuh"

namespace {

using copift::kLcgA;
using copift::kLcgC;
using copift::kPhi;
using copift::splitmix32;

// Element i of the stream `seed`: kind 0 the LCG, 1 xoshiro128+.
__device__ __forceinline__ float draw(int64_t i, uint32_t seed, int kind) {
  const uint32_t idx = static_cast<uint32_t>(i) + seed;
  uint32_t bits;
  if (kind == 0) {  // LCG
    const uint32_t next = splitmix32(idx) * kLcgA + kLcgC;
    bits = (next >> 9) ^ next;
  } else {  // xoshiro128+
    bits = splitmix32(idx) + splitmix32(idx + 3u * kPhi);
  }
  return copift::uniform_from_bits(bits);
}

__global__ void __launch_bounds__(kMaxBlockThreads)
    uniform_kernel(float* __restrict__ out, int64_t n, uint32_t seed,
                   int kind) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = draw(i, seed, kind);
  }
}

// Row r of (rows, n): the n elements of the stream seeds[r], each the bits
// uniform_kernel gives that seed.  The grid's y takes the rows (striding
// past 65,535), its x the elements as uniform_kernel's grid does.
__global__ void __launch_bounds__(kMaxBlockThreads)
    uniform_rows_kernel(float* __restrict__ out,
                        const uint32_t* __restrict__ seeds, int64_t rows,
                        int64_t n, int kind) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t seed = seeds[r];
    float* o = out + r * n;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
      o[i] = draw(i, seed, kind);
    }
  }
}

}  // namespace

// out[i] for i < n, on the given stream, with `threads` a block (a multiple
// of 32, 32 to 1024; others are refused with cudaErrorInvalidValue); kind 0
// is the LCG, 1 xoshiro128+.  Returns the launch's cudaError_t as an int (0
// on success).
extern "C" int copift_uniform_f32(float* out, int64_t n, uint32_t seed,
                                  int kind, int threads, cudaStream_t stream) {
  if (!valid_block_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    uniform_kernel<<<grid_stride_blocks(n, threads), threads, 0, stream>>>(
        out, n, seed, kind);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (rows, n), row r drawn from the seed seeds[r] (uint32 in device
// memory), on the given stream: one launch for what copift_uniform_f32 gives
// row by row, bit for bit.  `threads` and kind as copift_uniform_f32's.
extern "C" int copift_uniform_rows_f32(float* out, const uint32_t* seeds,
                                       int64_t rows, int64_t n, int kind,
                                       int threads, cudaStream_t stream) {
  if (!valid_block_threads(threads) || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && n > 0) {
    const dim3 grid(grid_stride_blocks(n, threads),
                    static_cast<unsigned int>(rows < 65535 ? rows : 65535));
    uniform_rows_kernel<<<grid, threads, 0, stream>>>(out, seeds, rows, n,
                                                      kind);
  }
  return static_cast<int>(cudaGetLastError());
}
