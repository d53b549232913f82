// Launching a kernel on thread-block clusters whose size is set at launch
// (leaf.cu, ddleaf.cu, colfft.cu, leaft.cu). Up to 8 blocks a cluster is portable; 16 needs the
// kernel's non-portable opt-in, and whether such clusters fit at all is for
// the occupancy query to say.
#pragma once

#include <cuda_runtime.h>

namespace phastft {

// A launch configuration of `blocks` blocks in clusters of `cluster`. Not
// copyable: the configuration points at its own attribute.
struct ClusterLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr = {};

  ClusterLaunch(long long blocks, int cluster, int threads, size_t smem, cudaStream_t s) {
    config.gridDim = dim3(static_cast<unsigned>(blocks));
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = s;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(cluster);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The kernel's dynamic shared memory, the largest shared-memory carveout and,
// past 8 blocks, the non-portable cluster size.
template <typename Kernel>
cudaError_t configure_cluster_kernel(Kernel kernel, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Clusters the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, int threads, size_t smem) {
  cudaError_t err = configure_cluster_kernel(kernel, cluster, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ClusterLaunch launch(1024LL * cluster, cluster, threads, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// Launches `kernel` on `blocks` blocks in clusters of `cluster`; returns the
// CUDA error code (0 on success). `resident` caches the occupancy query of
// this kernel and cluster size: a shape no cluster of which fits the device
// is refused (cudaErrorInvalidConfiguration) rather than launched.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int cluster, long long blocks, int threads, size_t smem,
                    cudaStream_t s, int& resident, Args... args) {
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (resident <= 0) {
    resident = resident_clusters(kernel, cluster, threads, smem);
    if (resident < 0) return -resident;
    if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = configure_cluster_kernel(kernel, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(blocks, cluster, threads, smem, s);
  err = cudaLaunchKernelEx(&launch.config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phastft
