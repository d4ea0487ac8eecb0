// Thread-block cluster launches on Hopper (sm_90a), shared by the probes
// whose data stay in a cluster's distributed shared memory
// (probe_floors.cu cf_cluster, probe_phases.cu fused_block). The shipped
// kernels (fourstep.cuh and the sources that include it) use none of this.
//
// A cluster of up to 8 CTAs is portable; 16 needs the kernel's
// cudaFuncAttributeNonPortableClusterSizeAllowed. Every CTA of a cluster
// runs at once on neighbouring SMs, so a kernel that cannot fit one
// cluster on the card has an occupancy of 0 clusters: the callers return
// an error for it, and their wrappers raise (no fallback).
//
// Everything here has internal linkage, as in fourstep.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

namespace cg = cooperative_groups;

// The shared::cluster address of `p` (this CTA's shared memory) in the CTA
// of rank `rank`: 32 bits, where a generic pointer from
// cluster.map_shared_rank takes 64 and a generic load.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

// 16 bytes of a peer's shared memory, and a store of 16 bytes to one.
__device__ __forceinline__ float4 ld_cluster(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(unsigned a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// A 1-D launch of `grid` CTAs (a multiple of `ctas`) in clusters of `ctas`;
// `attr` holds the cluster dimension and must outlive the launch call.
inline cudaLaunchConfig_t cluster_launch_config(unsigned grid, unsigned threads,
                                                size_t smem, int ctas,
                                                cudaLaunchAttribute* attr,
                                                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` (and allows a
// non-portable cluster above 8 CTAs), then *clusters =
// cudaOccupancyMaxActiveClusters for clusters of `ctas` CTAs of `threads`.
template <typename K>
cudaError_t max_active_clusters(K kernel, int ctas, int threads, size_t smem,
                                int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch_config(ctas, threads, smem, ctas, &attr, 0);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace
