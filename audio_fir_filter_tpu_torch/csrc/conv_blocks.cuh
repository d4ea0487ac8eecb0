// The block convolution's column passes (pass 1 with its pair gather, pass
// 3 with its full-block scatter), shared by conv_blocks.cu, which launches
// them with rows_multiply as the shipped kernel, and probe_phases.cu, which
// launches them one at a time and with the ablation switches of
// fourstep.cuh (kArith, kStrided) to time the code that ships. The default
// template arguments are the shipped kernel.
//
// blocks / out are [nb, B] float32; pair p is blocks 2p (real part) and
// 2p + 1 (imaginary part). Internal linkage, as fourstep.cuh.

#pragma once

#include "fourstep.cuh"

namespace {

// Pass 1: forward column FFTs of pair (pair0 + blockIdx.y), columns
// [blockIdx.x * tc, +tc), read from blocks 2p and 2p + 1.
template <typename T, bool kArith = true, bool kStrided = true>
__global__ void __launch_bounds__(kThreads)
pairs_forward(const float* __restrict__ blocks, Cx<T>* __restrict__ scratch,
              const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
              Split sp, long long pair0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << sp.log_n1, n2 = 1 << sp.log_n2, tc = sp.tc;
  const size_t b = (size_t)n1 * n2;
  Cx<T>* tws = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tws + (n1 >> 1);
  const float* x0 = blocks + (size_t)(pair0 + blockIdx.y) * 2 * b;
  const float* x1 = x0 + b;
  const int c0 = blockIdx.x * tc;

  load_table(tws, w1, n1 >> 1);
  for (int i = threadIdx.x; i < tc * n1; i += blockDim.x) {
    const int w = i % tc, row = i / tc;
    const size_t n = (size_t)row * n2 + c0 + w;
    s[row * tc + w] = {static_cast<T>(x0[n]), static_cast<T>(x1[n])};
  }
  cols_forward_store<T, kArith, kStrided>(
      s, tws, scratch + (size_t)blockIdx.y * b, tw4, sp, c0);
}

// Pass 3: inverse column FFTs, scale 1/B, write every position of blocks
// 2p (real part) and 2p + 1 (imaginary part). With kArith = false: no
// twiddle, no FFT and no scale.
template <typename T, bool kArith = true, bool kStrided = true>
__global__ void __launch_bounds__(kThreads)
pairs_inverse(const Cx<T>* __restrict__ scratch, float* __restrict__ out,
              const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
              Split sp, long long pair0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << sp.log_n1, n2 = 1 << sp.log_n2, tc = sp.tc;
  const size_t b = (size_t)n1 * n2;
  Cx<T>* tws = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tws + (n1 >> 1);
  const int c0 = blockIdx.x * tc;

  load_table(tws, w1, n1 >> 1);
  cols_inverse_load<T, kArith, kStrided>(
      s, tws, scratch + (size_t)blockIdx.y * b, tw4, sp, c0);

  const T scale = kArith ? T(1) / static_cast<T>(b) : T(1);
  float* y0 = out + (size_t)(pair0 + blockIdx.y) * 2 * b;
  float* y1 = y0 + b;
  for (int i = threadIdx.x; i < tc * n1; i += blockDim.x) {
    const int w = i % tc, row = i / tc;
    const size_t n = (size_t)row * n2 + c0 + w;
    const Cx<T> v = s[row * tc + w];
    y0[n] = static_cast<float>(v.re * scale);
    y1[n] = static_cast<float>(v.im * scale);
  }
}

}  // namespace
