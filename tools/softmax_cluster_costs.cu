// For tools/softmax_cluster_costs.py: empty kernels, for what a launch
// with a cluster dimension and its cluster barriers cost before any byte
// moves, and the number of clusters of the softmax kernel's cluster path
// that the card holds at once (softmax.cu is compiled into this library
// for that; its launchers here are not used).
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "softmax.cu"

namespace {

// `syncs` cluster barriers, as softmax.cu's cluster path makes three.
__global__ void empty_cluster(int syncs) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < syncs; ++i) cluster.sync();
}

}  // namespace

// grid blocks of threads each, in clusters of `cluster` blocks (0: a plain
// launch without the cluster attribute).
extern "C" int empty_cluster_launch(int grid, int threads, int cluster,
                                    int syncs, cudaStream_t stream) {
  if (cluster == 0) {
    empty_cluster<<<grid, threads, 0, stream>>>(syncs);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, empty_cluster, syncs);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Clusters of `cluster` blocks of the fp32 16-byte-load cluster kernel, at
// `threads` threads and `smem_bytes` of dynamic shared memory a block, that
// can be resident at once (cudaOccupancyMaxActiveClusters), or -1 and the
// error in *error.
extern "C" int softmax_active_clusters(int cluster, int threads,
                                       int smem_bytes, int* error) {
  void (*kernel)(const float*, float*, int64_t, int, int) =
      &softmax_cluster_kernel<float, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster * 64);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = -1;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  }
  *error = static_cast<int>(e);
  return e == cudaSuccess ? clusters : -1;
}
