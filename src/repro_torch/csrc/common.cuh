// Helpers shared by the port's kernel sources.  Each .cu file is built into
// its own shared library (repro_torch/kernels/_build.py), so every library
// carries one copy of repro_error_string.  The sources include no PyTorch
// header: the launchers take raw pointers and the stream from the Python
// wrappers, which bind them with ctypes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Lets a wrapper turn the code a launcher returned into a message.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The block sizes the tiled kernels take (exp, logf, uniform, softmax's
// warp path): a multiple of 32 from 32 to kMaxBlockThreads, the default
// tiling's kDefaultBlockThreads among them.  A launcher refuses others.  A
// kernel built with __launch_bounds__(kMaxBlockThreads) gets at most 64
// registers a thread, so that a block of 1024 fits an SM.
constexpr int kDefaultBlockThreads = 256;
constexpr int kMaxBlockThreads = 1024;
inline bool valid_block_threads(int threads) {
  return threads >= 32 && threads <= kMaxBlockThreads && threads % 32 == 0;
}

// Grid for a grid-stride loop over n elements: enough blocks to fill the
// 132 SMs of an H100 several times over, and never more than the elements
// need.
inline unsigned int grid_stride_blocks(int64_t n, int threads) {
  const int64_t need = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;
  return static_cast<unsigned int>(need < cap ? need : cap);
}
