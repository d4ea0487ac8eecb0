// Four-step FFT machinery shared by the port's CUDA kernels (sm_90a):
// segment_filter.cu (whole-segment overlap-save) and conv_blocks.cu
// (circular convolution of real blocks). Both convolve complex pairs of real
// blocks, z = x0 + i*x1, with the spectrum H of a real kernel:
//
//   B = N1 * N2;  pass 1: column FFTs (length N1) * four-step twiddle;
//   pass 2: row FFTs (length N2) * H, inverse row FFTs;
//   pass 3: * conjugate twiddle, inverse column FFTs, * 1/B.
//
// The passes share a [pairs, B] scratch in device memory. The forward FFTs
// are decimation in frequency (natural in, bit-reversed out) and the inverse
// ones decimation in time (bit-reversed in, natural out); the host lays H
// and the twiddle table out in that order, so nothing is ever reordered.
// The kernels differ only in pass 1's gather and pass 3's scatter, which
// each source writes around cols_forward_store / cols_inverse_load. The
// probes (probe_phases.cu, probe_floors.cu, probe_stages.cu) launch these
// passes and FFTs with switches whose defaults are the shipped code.
//
// Everything here has internal linkage: each kernel source is its own
// library with its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
// Elements of one shared-memory FFT tile: 8192 complex = 64 KB (float) or
// 128 KB (double), above the 48 KB default, hence allow_smem below.
constexpr int kTileElems = 8192;

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> cadd(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// a * conj(b)
template <typename T>
__device__ __forceinline__ Cx<T> cmulc(Cx<T> a, Cx<T> b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

// In-place radix-2 FFTs over a tile of W transforms of length L = 2^logL,
// element (pos, w) at s[pos * W + w]. tw[k] = exp(-2*pi*i*k/L), k < L/2.
// The caller synchronizes before the first stage; every stage ends with a
// barrier.

// Forward, decimation in frequency: natural order in, bit-reversed out.
template <typename T>
__device__ void fft_dif(Cx<T>* s, int W, int logL, const Cx<T>* tw) {
  const int nbf = W << (logL - 1);
  for (int lh = logL - 1; lh >= 0; --lh) {
    const int h = 1 << lh;
    const int tshift = logL - 1 - lh;
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      const int w = t % W;
      const int b = t / W;
      const int j = b & (h - 1);
      const int lo = (((b >> lh) << (lh + 1)) + j) * W + w;
      const int hi = lo + h * W;
      const Cx<T> a = s[lo], c = s[hi];
      s[lo] = cadd(a, c);
      s[hi] = cmul(csub(a, c), tw[j << tshift]);
    }
    __syncthreads();
  }
}

// Inverse (conjugate twiddles, no scaling), decimation in time:
// bit-reversed order in, natural out.
template <typename T>
__device__ void ifft_dit(Cx<T>* s, int W, int logL, const Cx<T>* tw) {
  const int nbf = W << (logL - 1);
  for (int lh = 0; lh < logL; ++lh) {
    const int h = 1 << lh;
    const int tshift = logL - 1 - lh;
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      const int w = t % W;
      const int b = t / W;
      const int j = b & (h - 1);
      const int lo = (((b >> lh) << (lh + 1)) + j) * W + w;
      const int hi = lo + h * W;
      const Cx<T> a = s[lo];
      const Cx<T> c = cmulc(s[hi], tw[j << tshift]);
      s[lo] = cadd(a, c);
      s[hi] = csub(a, c);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void load_table(Cx<T>* dst, const Cx<T>* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The four-step split of one block and its tile widths.
struct Split {
  int log_n1, log_n2;  // B = 2^log_n1 * 2^log_n2
  int tc;              // columns per tile (passes 1 and 3)
  int tr;              // rows per tile (pass 2)
};

inline Split make_split(int log_n1, int log_n2) {
  Split sp;
  sp.log_n1 = log_n1;
  sp.log_n2 = log_n2;
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  sp.tc = n2 < (kTileElems >> log_n1) ? n2 : (kTileElems >> log_n1);
  sp.tr = n1 < (kTileElems >> log_n2) ? n1 : (kTileElems >> log_n2);
  return sp;
}

// Dynamic shared memory of the column passes (1 and 3) and the row pass.
template <typename T>
inline size_t cols_smem(Split sp) {
  return ((size_t)(1 << (sp.log_n1 - 1)) + (size_t)sp.tc * (1 << sp.log_n1)) *
         sizeof(Cx<T>);
}
template <typename T>
inline size_t rows_smem(Split sp) {
  return ((size_t)(1 << (sp.log_n2 - 1)) + (size_t)sp.tr * (1 << sp.log_n2)) *
         sizeof(Cx<T>);
}

// The column passes take two switches for the decomposition probes
// (experiments/, csrc/probe_phases.cu); the defaults are the shipped code:
//   kArith   = false: no FFT and no twiddle, a pure gather/scatter;
//   kStrided = false: the tile goes to one contiguous run of the scratch
//              (tc * N1 values at c0 * N1) instead of column-strided.

// Pass 1, after the gather: the tile s holds columns [c0, c0 + tc) of one
// pair in natural row order and tws the length-N1 roots. Column FFTs, then
// the pair's scratch gets them times the four-step twiddle (scratch row pos
// holds k1 = bitrev(pos)).
template <typename T, bool kArith = true, bool kStrided = true>
__device__ void cols_forward_store(Cx<T>* s, const Cx<T>* tws,
                                   Cx<T>* __restrict__ out,
                                   const Cx<T>* __restrict__ tw4, Split sp,
                                   int c0) {
  const int n1 = 1 << sp.log_n1, n2 = 1 << sp.log_n2;
  __syncthreads();
  if constexpr (kArith) fft_dif(s, sp.tc, sp.log_n1, tws);
  for (int i = threadIdx.x; i < sp.tc * n1; i += blockDim.x) {
    const int w = i % sp.tc, pos = i / sp.tc;
    const size_t idx = (size_t)pos * n2 + c0 + w;
    const size_t at = kStrided ? idx : (size_t)c0 * n1 + i;
    if constexpr (kArith) {
      out[at] = cmul(s[pos * sp.tc + w], tw4[idx]);
    } else {
      out[at] = s[pos * sp.tc + w];
    }
  }
}

// What pass 2 runs: the shipped FFT * H * inverse, or (probes only) its
// forward FFT alone, or its shared-memory round trip with no arithmetic.
constexpr int kRowsFull = 0, kRowsForward = 1, kRowsCopy = 2;

// Pass 2: rows [blockIdx.x * tr, +tr) of pair blockIdx.y of the scratch:
// FFT, times H, inverse FFT, in place.
template <typename T, int kRows = kRowsFull>
__global__ void __launch_bounds__(kThreads)
rows_multiply(Cx<T>* __restrict__ scratch, const Cx<T>* __restrict__ H,
              const Cx<T>* __restrict__ w2, Split sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << sp.log_n1, n2 = 1 << sp.log_n2;
  Cx<T>* tws = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tws + (n2 >> 1);
  const int r0 = blockIdx.x * sp.tr;
  Cx<T>* blk = scratch + (size_t)blockIdx.y * ((size_t)n1 * n2);

  if constexpr (kRows != kRowsCopy) load_table(tws, w2, n2 >> 1);
  for (int i = threadIdx.x; i < sp.tr * n2; i += blockDim.x) {
    const int r = i / n2, q = i % n2;  // row-contiguous global reads
    s[q * sp.tr + r] = blk[(size_t)(r0 + r) * n2 + q];
  }
  __syncthreads();
  if constexpr (kRows != kRowsCopy) fft_dif(s, sp.tr, sp.log_n2, tws);
  if constexpr (kRows == kRowsFull) {
    for (int i = threadIdx.x; i < sp.tr * n2; i += blockDim.x) {
      const int r = i / n2, q = i % n2;
      s[q * sp.tr + r] = cmul(s[q * sp.tr + r], H[(size_t)(r0 + r) * n2 + q]);
    }
    __syncthreads();
    ifft_dit(s, sp.tr, sp.log_n2, tws);
  }
  for (int i = threadIdx.x; i < sp.tr * n2; i += blockDim.x) {
    const int r = i / n2, q = i % n2;
    blk[(size_t)(r0 + r) * n2 + q] = s[q * sp.tr + r];
  }
}

// Pass 3, before the scatter: the tile s gets columns [c0, c0 + tc) of the
// pair's scratch times the conjugate twiddle, inverse column FFTs; it is
// left in natural row order, unscaled. tws holds the length-N1 roots.
template <typename T, bool kArith = true, bool kStrided = true>
__device__ void cols_inverse_load(Cx<T>* s, const Cx<T>* tws,
                                  const Cx<T>* __restrict__ blk,
                                  const Cx<T>* __restrict__ tw4, Split sp,
                                  int c0) {
  const int n1 = 1 << sp.log_n1, n2 = 1 << sp.log_n2;
  for (int i = threadIdx.x; i < sp.tc * n1; i += blockDim.x) {
    const int w = i % sp.tc, pos = i / sp.tc;
    const size_t idx = (size_t)pos * n2 + c0 + w;
    const size_t at = kStrided ? idx : (size_t)c0 * n1 + i;
    if constexpr (kArith) {
      s[pos * sp.tc + w] = cmulc(blk[at], tw4[idx]);
    } else {
      s[pos * sp.tc + w] = blk[at];
    }
  }
  __syncthreads();
  if constexpr (kArith) ifft_dit(s, sp.tc, sp.log_n1, tws);
}

// Raise one kernel's dynamic shared-memory limit.
template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Raise the dynamic shared-memory limit of a kernel's column passes and of
// rows_multiply<T>.
template <typename T, typename K1, typename K3>
cudaError_t allow_smem(K1 cols_fwd, K3 cols_inv, Split sp) {
  cudaError_t err;
  const int sm_cols = (int)cols_smem<T>(sp), sm_rows = (int)rows_smem<T>(sp);
  err = cudaFuncSetAttribute(cols_fwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm_cols);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows_multiply<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm_rows);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(cols_inv,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sm_cols);
}

}  // namespace
