// An empty kernel: what one launch costs the card when it does no work.
// tools/launch_floor.py times it at the grids of the uniform kernel's
// small launches, beside that kernel, to tell launch cost from kernel cost.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_floor_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
