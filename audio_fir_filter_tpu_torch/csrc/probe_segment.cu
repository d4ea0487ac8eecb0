// Ablation probes of the shipped segment kernel on Hopper (sm_90a): its
// three passes with parts switched off, to split its time on the card.
//
// Replaces the TPU's ablation set of the fused Pallas segment kernel,
// LOWCUT_ABLATE (audio_fir_filter_tpu/ops/pallas_fft.py:124-155, read in
// _call_fused), which experiments/fast_decomp_r05.py timed one subprocess
// per variant. Nothing here is a copy of the shipped code: the passes are
// segment_filter.cuh's cols_forward / rows_multiply_ring (pass 2 in f64) /
// run_split and fourstep.cuh's rows_multiply (pass 2 in f32 and i16),
// instantiated with their switches (Ablate), so a time here is a time of
// the kernel that ships. Variant (JAX tokens): what it leaves
// out; its defined output.
//   0 full      (none): nothing, the shipped kernel; the segment filter;
//   1 no_gather (dma, noreadx): pass 1's reads of the signal; zeros;
//   2 no_store  (out8): pass 3's stores of y, the peak kept; y untouched,
//               the peak of full;
//   3 no_tr     (tr): the column-strided scratch layout (each column tile
//               one contiguous run); the passes with that permutation
//               between them;
//   4 rows_copy (phaseb): pass 2's FFTs and H, its data movement kept;
//               x shifted, / N2;
//   5 no_arith  (fft, mul): every FFT, twiddle, H and the 1/B scale;
//               x shifted (y[o] = x[o + M - left]), exactly;
//   6 floor     (dma, tr, fft, mul): the reads, the arithmetic and the
//               strided layout; zeros, through the scratch and stored;
//   7 no_tw4    (no TPU token): the column passes' reads of the four-step
//               twiddle table, the multiply kept (by a unit held in
//               registers); the passes with every four-step twiddle 1.
// Every variant still moves the scratch three times and takes the peak.
// Only the splits of the probes' shapes are instantiated, B = 2^18 (512 x
// 512) and 2^19 (1024 x 512, the column passes' 1024-point side), which
// keeps the build short; any other B, or another variant id, returns
// cudaErrorInvalidValue, which the wrapper raises. The probes allocate
// nothing and do not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_filter.cuh"

namespace {

template <typename T, typename IO, class S>
int run_variant(const IO* x, IO* y, unsigned int* pk, const Cx<T>* h,
                const Cx<T>* t4, const Cx<T>* r1, const Cx<T>* r2, Cx<T>* sc,
                const Geometry& g, long long total, long long chunk_pairs,
                int variant, cudaStream_t stream) {
  auto go = [&](auto a) {
    return run_split<T, IO, S, decltype(a)>(x, y, pk, h, t4, r1, r2, sc, g,
                                            total, chunk_pairs, stream);
  };
  switch (variant) {
    case 0: return go(Shipped{});
    case 1: return go(Ablate<false>{});
    case 2: return go(Ablate<true, false>{});
    case 3: return go(Ablate<true, true, true, false>{});
    case 4: return go(Ablate<true, true, true, true, kRowsCopy>{});
    case 5: return go(Ablate<true, true, false, true, kRowsCopy>{});
    case 6: return go(Ablate<false, true, false, false, kRowsCopy>{});
    case 7: return go(Ablate<true, true, true, true, kRowsFull, false>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename IO>
int run(const IO* x, IO* y, float* peak, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, int channels,
        long long n_in, long long out_len, long long left, int m, int log_n1,
        int log_n2, long long chunk_pairs, int variant, cudaStream_t stream) {
  Geometry g;
  const long long total =
      make_geometry(g, channels, n_in, out_len, left, m, log_n1 + log_n2);
  auto go = [&](auto sp) {
    return run_variant<T, IO, decltype(sp)>(
        x, y, reinterpret_cast<unsigned int*>(peak),
        static_cast<const Cx<T>*>(H), static_cast<const Cx<T>*>(tw4),
        static_cast<const Cx<T>*>(w1), static_cast<const Cx<T>*>(w2),
        static_cast<Cx<T>*>(scratch), g, total, chunk_pairs, variant, stream);
  };
  if (log_n1 == 9 && log_n2 == 9) return go(Split<9, 9>{});
  if (log_n1 == 10 && log_n2 == 9) return go(Split<10, 9>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes): the segment filter's entry
// (segment_filter.cu) with the variant id before the stream.
#define LOWCUT_PROBE_SEGMENT_ENTRY(NAME, T, IO)                               \
  extern "C" int NAME(const void* x, void* y, void* peak, const void* H,     \
                      const void* tw4, const void* w1, const void* w2,       \
                      void* scratch, int channels, long long n_in,           \
                      long long out_len, long long left, int m, int log_n1,  \
                      int log_n2, long long chunk_pairs, int variant,        \
                      void* stream) {                                        \
    return run<T, IO>(static_cast<const IO*>(x), static_cast<IO*>(y),        \
                      static_cast<float*>(peak), H, tw4, w1, w2, scratch,    \
                      channels, n_in, out_len, left, m, log_n1, log_n2,      \
                      chunk_pairs, variant,                                  \
                      static_cast<cudaStream_t>(stream));                    \
  }

LOWCUT_PROBE_SEGMENT_ENTRY(lowcut_probe_segment_f32, float, float)
LOWCUT_PROBE_SEGMENT_ENTRY(lowcut_probe_segment_f64, double, float)
LOWCUT_PROBE_SEGMENT_ENTRY(lowcut_probe_segment_i16, float, int16_t)
