// TMA bulk copies, mbarriers and the persistent grid on Hopper (sm_90a),
// shared by the probes that stage data through shared memory
// (probe_floors.cu bw_ring and copy_floor's cluster, probe_stages.cu
// ring_chain) and by the shipped segment kernel's persistent passes 2 and
// 3 (segment_filter.cuh rows_multiply_ring: one 1-D bulk load a stage;
// cols_inverse_ring: 2-D tile loads through a tensor map; resident_ctas).
// fourstep.cuh and the block path use none of this.
//
// A bulk copy (cp.async.bulk, 1-D; cp.async.bulk.tensor, a tile through a
// tensor map) is issued by one thread and run by the TMA unit. A load
// completes its bytes on an mbarrier in shared memory: the issuing thread
// arrives once with expect_tx of the bytes its copies bring, and the
// threads wait on the barrier's phase parity. A store reads shared memory
// in the issuing thread's bulk group; the stage may be written again only
// after cp.async.bulk.wait_group.read says the group has read it, and the
// threads' own writes reach a store only after fence.proxy.async.shared::cta.
//
// Everything here has internal linkage, as in fourstep.cuh.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using Bar = unsigned long long;  // an mbarrier: 8 bytes of shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(Bar* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy and the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of bulk-copy completions.
__device__ __forceinline__ void mbar_expect_tx(Bar* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(Bar* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(Bar* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// global -> shared, completing `bytes` on `bar` (the CTA's own shared
// memory is its window of the cluster's).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, Bar* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// shared -> global, in the issuing thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N of the issuing thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Orders the threads' shared-memory writes before a later bulk store.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Persistent grid: as many CTAs of `kernel` as occupancy allows on every SM.
template <typename K>
cudaError_t resident_ctas(K kernel, int threads, size_t smem, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  return err;
}

// ------------------------------------------- 2-D tensor maps (TMA tiles)

// Tile copies through a tensor map (cp.async.bulk.tensor.2d): the TMA unit
// walks the rows of a box itself, so one instruction moves up to 256 rows.
// `map` is a __grid_constant__ kernel parameter; (c, r) is the box's first
// element, innermost coordinate first.
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int c, int r, Bar* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c), "r"(r),
      "r"(smem_addr(bar))
      : "memory");
}
// shared -> global, in the issuing thread's current bulk group.
__device__ __forceinline__ void tile_store(const CUtensorMap* map, int c, int r,
                                           const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group "
      "[%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(c), "r"(r), "r"(smem_addr(src))
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's
// entry-point query (the build does not link libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// A row-major [rows, cols] matrix of T (float or double) at `base` as a
// tensor map of [box_rows, box_cols] tiles with no swizzle: a tile lands
// in shared memory row-major, box_cols * sizeof(T) bytes a row.
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* base, unsigned long long rows,
                     unsigned long long cols, unsigned box_rows,
                     unsigned box_cols) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(T)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
