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
// allocate nothing and do not synchronize.

#include <cuda_runtime.h>

#include "conv_blocks.cuh"

namespace {

enum Variant {
  kFull = 0, kAcOnly = 1, kBOnly = 2, kNoTr = 3, kCopy = 4,
  kK1 = 5, kK2 = 6, kK2a = 7, kK3 = 8,
};

template <typename T>
cudaError_t allow_variants(Split sp) {
  const size_t c = cols_smem<T>(sp), r = rows_smem<T>(sp);
  cudaError_t err = allow_smem<T>(pairs_forward<T>, pairs_inverse<T>, sp);
  if (err == cudaSuccess) err = smem_limit(pairs_forward<T, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_inverse<T, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_forward<T, true, false>, c);
  if (err == cudaSuccess) err = smem_limit(pairs_inverse<T, true, false>, c);
  if (err == cudaSuccess) err = smem_limit(rows_multiply<T, kRowsForward>, r);
  return err;
}

template <typename T>
int run(const float* blocks, float* out, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, long long pairs,
        int log_n1, int log_n2, int variant, cudaStream_t st) {
  const Split sp = make_split(log_n1, log_n2);
  cudaError_t err = allow_variants<T>(sp);
  if (err != cudaSuccess) return err;
  const size_t sc = cols_smem<T>(sp), sr = rows_smem<T>(sp);
  const Cx<T>* Hc = static_cast<const Cx<T>*>(H);
  const Cx<T>* t4 = static_cast<const Cx<T>*>(tw4);
  const Cx<T>* r1 = static_cast<const Cx<T>*>(w1);
  const Cx<T>* r2 = static_cast<const Cx<T>*>(w2);
  Cx<T>* s = static_cast<Cx<T>*>(scratch);
  const dim3 gc((1 << log_n2) / sp.tc, (unsigned)pairs);
  const dim3 gr((1 << log_n1) / sp.tr, (unsigned)pairs);
  switch (variant) {
    case kFull:
      pairs_forward<T><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1, sp, 0);
      rows_multiply<T><<<gr, kThreads, sr, st>>>(s, Hc, r2, sp);
      pairs_inverse<T><<<gc, kThreads, sc, st>>>(s, out, t4, r1, sp, 0);
      break;
    case kAcOnly:
      pairs_forward<T><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1, sp, 0);
      pairs_inverse<T><<<gc, kThreads, sc, st>>>(s, out, t4, r1, sp, 0);
      break;
    case kBOnly:
      pairs_forward<T, false><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1, sp, 0);
      rows_multiply<T><<<gr, kThreads, sr, st>>>(s, Hc, r2, sp);
      pairs_inverse<T, false><<<gc, kThreads, sc, st>>>(s, out, t4, r1, sp, 0);
      break;
    case kNoTr:
      pairs_forward<T, true, false><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1,
                                                             sp, 0);
      rows_multiply<T><<<gr, kThreads, sr, st>>>(s, Hc, r2, sp);
      pairs_inverse<T, true, false><<<gc, kThreads, sc, st>>>(s, out, t4, r1,
                                                             sp, 0);
      break;
    case kCopy:
      pairs_forward<T, false><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1, sp, 0);
      pairs_inverse<T, false><<<gc, kThreads, sc, st>>>(s, out, t4, r1, sp, 0);
      break;
    case kK1:
      pairs_forward<T><<<gc, kThreads, sc, st>>>(blocks, s, t4, r1, sp, 0);
      break;
    case kK2:
      rows_multiply<T><<<gr, kThreads, sr, st>>>(s, Hc, r2, sp);
      break;
    case kK2a:
      rows_multiply<T, kRowsForward><<<gr, kThreads, sr, st>>>(s, Hc, r2, sp);
      break;
    case kK3:
      pairs_inverse<T><<<gc, kThreads, sc, st>>>(s, out, t4, r1, sp, 0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
