// The block convolution's column passes (pass 1 with its pair gather, pass
// 3 with its full-block scatter), shared by conv_blocks.cu, which launches
// them with rows_multiply as the shipped kernel, and probe_phases.cu, which
// launches them one at a time and with the ablation switches of
// fourstep.cuh (kArith, kStrided) to time the code that ships. The default
// template arguments are the shipped kernel.
//
// blocks / out are [nb, B] float32; pair p is blocks 2p (real part) and
// 2p + 1 (imaginary part). Thread (t, w) of a CTA reads and writes column
// c0 + w at rows pos<0>(t, m): lanes run along w, so each row's 8 columns
// (32 bytes of a block) are one sector. Internal linkage, as fourstep.cuh.

#pragma once

#include "fourstep.cuh"

namespace {

// Pass 1: forward column FFTs of pair (pair0 + blockIdx.y), columns
// [blockIdx.x * kW, +kW), read from blocks 2p and 2p + 1.
template <typename T, class S, bool kArith = true, bool kStrided = true>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
pairs_forward(const float* __restrict__ blocks, Cx<T>* __restrict__ scratch,
              const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
              long long pair0) {
  using C = Cols<T, S>;
  using F = typename C::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;
  const int c0 = blockIdx.x * C::kW;
  const float* x0 = blocks + (size_t)(pair0 + blockIdx.y) * 2 * S::kB;
  const float* x1 = x0 + S::kB;

  if constexpr (kArith) F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const size_t n = (size_t)F::template pos<0>(t, m) * S::kN2 + c0 + w;
    v[m] = {static_cast<T>(x0[n]), static_cast<T>(x1[n])};
  }
  cols_forward_store<T, S, kArith, kStrided>(
      v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
      scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);
}

// Pass 3: inverse column FFTs, scale 1/B, write every position of blocks
// 2p (real part) and 2p + 1 (imaginary part). With kArith = false: no
// twiddle, no FFT and no scale.
template <typename T, class S, bool kArith = true, bool kStrided = true>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
pairs_inverse(const Cx<T>* __restrict__ scratch, float* __restrict__ out,
              const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
              long long pair0) {
  using C = Cols<T, S>;
  using F = typename C::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;
  const int c0 = blockIdx.x * C::kW;

  if constexpr (kArith) F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
  cols_inverse_load<T, S, kArith, kStrided>(
      v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
      scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);

  const T scale = kArith ? T(1) / static_cast<T>(S::kB) : T(1);
  float* y0 = out + (size_t)(pair0 + blockIdx.y) * 2 * S::kB;
  float* y1 = y0 + S::kB;
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const size_t n = (size_t)F::template pos<0>(t, m) * S::kN2 + c0 + w;
    y0[n] = static_cast<float>(v[m].re * scale);
    y1[n] = static_cast<float>(v[m].im * scale);
  }
}

// The three passes' shared-memory limits at split S (allow_smem).
template <typename T, class S>
cudaError_t allow_block_smem() {
  return allow_smem({{pairs_forward<T, S>, Cols<T, S>::kSmem},
                     {rows_multiply<T, S>, Rows<T, S>::kSmem},
                     {pairs_inverse<T, S>, Cols<T, S>::kSmem}});
}

}  // namespace
