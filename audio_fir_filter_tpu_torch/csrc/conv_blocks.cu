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
// What bounds it on this card, and the design: the same as
// segment_filter.cu, whose three passes it shares through fourstep.cuh (a
// 2^18-point block is far above a block's 227 KB of shared memory, so a
// four-step FFT in three launches with a [pairs, B] scratch in device
// memory). It differs only in pass 1's gather (contiguous rows of one
// block pair, no bounds tests) and pass 3's scatter (all B positions, no
// peak, no quantizer), both in conv_blocks.cuh. Against the segment
// kernel the path around it pays for a materialized block matrix (B / hop
// times the signal) and a full [nb, B] output, which the caller slices to
// [M, B).

#include <cuda_runtime.h>

#include "conv_blocks.cuh"

namespace {

template <typename T>
int run(const float* blocks, float* out, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, long long nb,
        int log_n1, int log_n2, long long chunk_pairs, cudaStream_t stream) {
  const Split sp = make_split(log_n1, log_n2);
  cudaError_t err = allow_smem<T>(pairs_forward<T>, pairs_inverse<T>, sp);
  if (err != cudaSuccess) return err;
  const size_t sm_cols = cols_smem<T>(sp), sm_rows = rows_smem<T>(sp);
  const Cx<T>* Hc = static_cast<const Cx<T>*>(H);
  const Cx<T>* tw4c = static_cast<const Cx<T>*>(tw4);
  const Cx<T>* w1c = static_cast<const Cx<T>*>(w1);
  const Cx<T>* w2c = static_cast<const Cx<T>*>(w2);
  Cx<T>* sc = static_cast<Cx<T>*>(scratch);
  const long long total = nb / 2;
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    const dim3 grid_cols((1 << log_n2) / sp.tc, (unsigned)np);
    const dim3 grid_rows((1 << log_n1) / sp.tr, (unsigned)np);
    pairs_forward<T><<<grid_cols, kThreads, sm_cols, stream>>>(
        blocks, sc, tw4c, w1c, sp, p0);
    rows_multiply<T><<<grid_rows, kThreads, sm_rows, stream>>>(sc, Hc, w2c, sp);
    pairs_inverse<T><<<grid_cols, kThreads, sm_cols, stream>>>(
        sc, out, tw4c, w1c, sp, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError().
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
