// Circular convolution of real blocks with a real kernel on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audio_fir_filter_tpu/ops/pallas_fft.py
// pallas_conv_real_blocks (the pl.pallas_call in _call_fused; its XLA
// mirror is _conv_xla_mirror), the generic block path of overlap-save. For
// blocks [nb, B] float32, nb even, and each pair k:
//
//   z = blocks[2k] + i*blocks[2k+1],  Z = FFT_B(z) * H,
//   out[2k] + i*out[2k+1] = IFFT_B(Z) / B
//
// at every position [0, B): the aliased head [0, M) is returned too (the
// caller discards it). H is the spectrum of the real kernel, so the real
// part belongs to block 2k and the imaginary part to block 2k+1. Modes: f32
// (float32 arithmetic) and f64 (float64 arithmetic); input and output are
// float32 in both.
//
// What bounds it on this card, and the design: a four-step FFT in three
// launches with a [pairs, B] scratch in device memory (a 2^18-point block
// is far above a CTA's 227 KB of shared memory). On the block path a call
// takes 8 pairs, so the scratch (16 MB f32, 32 MB f64) lives in the 50 MB
// L2. Before this design each pass ran 2.8-7.0x above its device-memory
// floor in radix-2 sweeps and bank conflicts (PERF.md). The passes now run
// register-resident radix-8 stages with conflict-free exchanges and 16
// warps per SM in f64, 32 in f32 (fourstep.cuh says how): 1.2-1.4x above
// the floor, bound by memory. On an NVIDIA H100 80GB HBM3 at 700 W the
// kernel takes 0.168 ms (f64) / 0.100 ms (f32) for blocks [28, 2^18],
// against 0.503 / 0.225 ms for cuFFT (PERF.md). This file adds only pass
// 1's gather (contiguous rows of one block pair, no bounds tests) and pass
// 3's scatter (all B positions, no peak, no quantizer), both in
// conv_blocks.cuh, and the dispatch over the compiled splits.

#include <cuda_runtime.h>

#include "conv_blocks.cuh"

namespace {

template <typename T, class S>
int run_split(const float* blocks, float* out, const Cx<T>* H,
              const Cx<T>* tw4, const Cx<T>* w1, const Cx<T>* w2, Cx<T>* sc,
              long long nb, long long chunk_pairs, cudaStream_t stream) {
  using C = Cols<T, S>;
  using RW = Rows<T, S>;
  cudaError_t err = allow_block_smem<T, S>();
  if (err != cudaSuccess) return err;
  const long long total = nb / 2;
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    const dim3 grid_cols(S::kN2 / C::kW, (unsigned)np);
    const dim3 grid_rows(S::kN1 / RW::kR, (unsigned)np);
    pairs_forward<T, S><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        blocks, sc, tw4, w1, p0);
    rows_multiply<T, S><<<grid_rows, RW::kThreads, RW::kSmem, stream>>>(
        sc, H, w2);
    pairs_inverse<T, S><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        sc, out, tw4, w1, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename T>
int run(const float* blocks, float* out, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, long long nb,
        int log_n1, int log_n2, long long chunk_pairs, cudaStream_t stream) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    return run_split<T, decltype(sp)>(
        blocks, out, static_cast<const Cx<T>*>(H),
        static_cast<const Cx<T>*>(tw4), static_cast<const Cx<T>*>(w1),
        static_cast<const Cx<T>*>(w2), static_cast<Cx<T>*>(scratch), nb,
        chunk_pairs, stream);
  });
}

// [pass 1, pass 2, pass 3] x occupancy()'s five numbers.
template <typename T>
int occupancy_of(int log_n1, int log_n2, int* out) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    using S = decltype(sp);
    cudaError_t err = allow_block_smem<T, S>();
    if (err == cudaSuccess)
      err = occupancy(pairs_forward<T, S>, Cols<T, S>::kThreads,
                      Cols<T, S>::kSmem, out);
    if (err == cudaSuccess)
      err = occupancy(rows_multiply<T, S>, Rows<T, S>::kThreads,
                      Rows<T, S>::kSmem, out + 5);
    if (err == cudaSuccess)
      err = occupancy(pairs_inverse<T, S>, Cols<T, S>::kThreads,
                      Cols<T, S>::kSmem, out + 10);
    return (int)err;
  });
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a split with no instantiation).
// blocks and out are [nb, B] float32 (nb even); scratch holds
// chunk_pairs * B complex values of the compute type.
#define LOWCUT_CONV_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* blocks, void* out, const void* H,         \
                      const void* tw4, const void* w1, const void* w2,      \
                      void* scratch, long long nb, int log_n1, int log_n2,  \
                      long long chunk_pairs, void* stream) {                \
    return run<T>(static_cast<const float*>(blocks),                        \
                  static_cast<float*>(out), H, tw4, w1, w2, scratch, nb,    \
                  log_n1, log_n2, chunk_pairs,                              \
                  static_cast<cudaStream_t>(stream));                       \
  }

LOWCUT_CONV_ENTRY(lowcut_conv_blocks_f32, float)
LOWCUT_CONV_ENTRY(lowcut_conv_blocks_f64, double)

// The three passes' occupancy at one split: out[15] ints, per pass [CTAs
// per SM, threads, dynamic shared bytes, registers, local-memory bytes].
extern "C" int lowcut_conv_blocks_occupancy(int log_n1, int log_n2, int f64,
                                            void* out) {
  int* o = static_cast<int*>(out);
  return f64 ? occupancy_of<double>(log_n1, log_n2, o)
             : occupancy_of<float>(log_n1, log_n2, o);
}
