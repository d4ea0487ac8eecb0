// Decomposition probes of the shipped block kernel on Hopper (sm_90a):
// its passes launched one at a time, and with phases switched off.
//
// Replaces two TPU probes of the fused Pallas conv kernel:
//   experiments/fused_phase_decomp.py make_variant (the pallas_call at
//     :152): the kernel with phases disabled (full, no_tr, ac_only,
//     b_only, copy);
//   experiments/pallas_micro.py tiled_call (the pallas_call at :73): each
//     pass alone (K1, K2, K2a, K3).
// Nothing here is a copy of the shipped code: the passes are
// conv_blocks.cuh's pairs_forward / pairs_inverse and fourstep.cuh's
// rows_multiply, instantiated with their ablation switches, so a time
// here is a time of the kernel that ships. The TPU's double-float (df64)
// arithmetic is not carried over: f32 and native f64, as the port ships.
//
// Variants (blocks [2 * pairs, B] float32 in and out, scratch [pairs, B]
// of the compute type):
//   full     pass 1, 2, 3: the shipped kernel (= lowcut_conv_blocks_*);
//   ac_only  passes 1 and 3 with arithmetic, no pass 2: x / N2;
//   b_only   pass 2 only; passes 1 and 3 gather and scatter with no
//            arithmetic (and no 1/B scale);
//   no_tr    as full, but passes 1 and 3 store / load each tile as one
//            contiguous run instead of column-strided: the same operation
//            count, a defined permutation, not a convolution;
//   copy     passes 1 and 3 with no arithmetic and no pass 2: identity;
//   k1       pass 1 alone: blocks -> scratch (column FFT * tw4);
//   k2       pass 2 alone, in place on the scratch (FFT * H * inverse);
//   k2a      pass 2's forward row FFT alone, in place;
//   k3       pass 3 alone: scratch -> blocks (* conj tw4, inverse, 1/B).
// What bounds each pass is what these probes measure (PERF.md); they
// allocate nothing and do not synchronize. To keep the build short the
// probes instantiate the splits of their own shapes only: B = 2^16 .. 2^20
// (N1 x N2 = 256 x 256 .. 1024 x 1024); any other B returns
// cudaErrorInvalidValue, which the wrappers raise.

#include <cuda_runtime.h>

#include "conv_blocks.cuh"

namespace {

enum Variant {
  kFull = 0, kAcOnly = 1, kBOnly = 2, kNoTr = 3, kCopy = 4,
  kK1 = 5, kK2 = 6, kK2a = 7, kK3 = 8,
};

template <typename T, class S>
cudaError_t allow_variants() {
  const size_t c = Cols<T, S>::kSmem, r = Rows<T, S>::kSmem;
  cudaError_t err = allow_smem<T, S>(pairs_forward<T, S>, pairs_inverse<T, S>);
  if (err == cudaSuccess) err = smem_limit(pairs_forward<T, S, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_inverse<T, S, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_forward<T, S, true, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_inverse<T, S, true, false>, c);
  if (err == cudaSuccess) err = smem_limit(rows_multiply<T, S, kRowsForward>, r);
  return err;
}

template <typename T, class S>
int run_split(const float* blocks, float* out, const Cx<T>* Hc,
              const Cx<T>* t4, const Cx<T>* r1, const Cx<T>* r2, Cx<T>* s,
              long long pairs, int variant, cudaStream_t st) {
  using C = Cols<T, S>;
  using RW = Rows<T, S>;
  cudaError_t err = allow_variants<T, S>();
  if (err != cudaSuccess) return err;
  const int tc = C::kThreads, tr = RW::kThreads;
  const size_t sc = C::kSmem, sr = RW::kSmem;
  const dim3 gc(S::kN2 / C::kW, (unsigned)pairs);
  const dim3 gr(S::kN1 / RW::kR, (unsigned)pairs);
  switch (variant) {
    case kFull:
      pairs_forward<T, S><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      rows_multiply<T, S><<<gr, tr, sr, st>>>(s, Hc, r2);
      pairs_inverse<T, S><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    case kAcOnly:
      pairs_forward<T, S><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      pairs_inverse<T, S><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    case kBOnly:
      pairs_forward<T, S, false><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      rows_multiply<T, S><<<gr, tr, sr, st>>>(s, Hc, r2);
      pairs_inverse<T, S, false><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    case kNoTr:
      pairs_forward<T, S, true, false><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      rows_multiply<T, S><<<gr, tr, sr, st>>>(s, Hc, r2);
      pairs_inverse<T, S, true, false><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    case kCopy:
      pairs_forward<T, S, false><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      pairs_inverse<T, S, false><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    case kK1:
      pairs_forward<T, S><<<gc, tc, sc, st>>>(blocks, s, t4, r1, 0);
      break;
    case kK2:
      rows_multiply<T, S><<<gr, tr, sr, st>>>(s, Hc, r2);
      break;
    case kK2a:
      rows_multiply<T, S, kRowsForward><<<gr, tr, sr, st>>>(s, Hc, r2);
      break;
    case kK3:
      pairs_inverse<T, S><<<gc, tc, sc, st>>>(s, out, t4, r1, 0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#define LOWCUT_PROBE_SPLITS(X) X(8, 8) X(9, 8) X(9, 9) X(10, 9) X(10, 10)

template <typename F>
int with_probe_split(int log_n1, int log_n2, F&& f) {
  LOWCUT_PROBE_SPLITS(LOWCUT_SPLIT_CASE)
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const float* blocks, float* out, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, long long pairs,
        int log_n1, int log_n2, int variant, cudaStream_t st) {
  return with_probe_split(log_n1, log_n2, [&](auto sp) {
    return run_split<T, decltype(sp)>(
        blocks, out, static_cast<const Cx<T>*>(H),
        static_cast<const Cx<T>*>(tw4), static_cast<const Cx<T>*>(w1),
        static_cast<const Cx<T>*>(w2), static_cast<Cx<T>*>(scratch), pairs,
        variant, st);
  });
}

}  // namespace

// Plain C entry points (bound with ctypes): launch `variant` on `stream`,
// allocate nothing, do not synchronize, return the launch error.
#define LOWCUT_PHASES_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* blocks, void* out, const void* H,          \
                      const void* tw4, const void* w1, const void* w2,       \
                      void* scratch, long long pairs, int log_n1,            \
                      int log_n2, int variant, void* stream) {               \
    return run<T>(static_cast<const float*>(blocks),                         \
                  static_cast<float*>(out), H, tw4, w1, w2, scratch, pairs,  \
                  log_n1, log_n2, variant,                                   \
                  static_cast<cudaStream_t>(stream));                        \
  }

LOWCUT_PHASES_ENTRY(lowcut_probe_phases_f32, float)
LOWCUT_PHASES_ENTRY(lowcut_probe_phases_f64, double)
