// Overlap-save "same" FIR filtering of a whole segment on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audio_fir_filter_tpu/ops/pallas_fft.py
// pallas_segment_filter (the pl.pallas_call in _call_fused) in its three
// modes: f32 ("fast"), double-float ("high"; native fp64 here) and
// 16-bit-native I/O. It computes what that kernel computes, not its block
// structure:
//
//   y[i] = sum_{k=0}^{M} h[k] * x[i - left + k],  x == 0 outside [0, n_in),
//   for i in [0, out_len)
//
// (left = Mo2 gives the zero-padded "same" filter; left = 0 on a buffer
// that already carries Mo2 halos gives the extended-segment filter). Block
// j is the window xp[j*hop, j*hop + B) of the virtually left-padded signal
// (no padded copy exists: reads outside [0, n_in) return 0); its circular
// convolution with the reversed taps is alias-free at positions [M, B),
// which are y[j*hop, (j+1)*hop). Complex pair k packs real blocks 2k and
// 2k+1 as x0 + i*x1; the real part of the result belongs to block 2k, the
// imaginary part to block 2k+1 (the taps are real).
//
// What bounds it on this card: one B = 2^18 complex block is 2 MiB in
// complex64 and 4 MiB in complex128, far above the 227 KB of shared memory
// a CTA may use, so the TPU's "whole block resident in VMEM" design does
// not carry over. This kernel is a four-step FFT, B = N1*N2 (512*512 at
// 2^18), in three launches with a [pairs, B] scratch in device memory
// between them (at most 64 f64 pairs, 256 MB, a launch chunk; 2 x 30 s of
// 96 kHz stereo is 14 pairs, 59 MB in f64 and 29 MB in f32, around the
// 50 MB L2):
//   1. forward columns: gather the pair's two windows straight from the
//      signal (through a ring of shared-memory stages in f64, below),
//      length-N1 DIF FFT down each column (natural in, bit-reversed out),
//      times the four-step twiddle, stored from the registers;
//   2. rows: length-N2 DIF FFT, times H (host-laid-out in this exact
//      bit-reversed order, so no reordering happens anywhere), inverse
//      length-N2 DIT FFT (bit-reversed in, natural out), each row read and
//      written coalesced by its own threads;
//   3. inverse columns: times the conjugate twiddle, inverse DIT FFT, scale
//      1/B, write only the valid positions, quantize for int16 I/O, and take
//      the output peak max|y| over written positions (atomicMax on the float
//      bits, which order like the values for non-negative floats).
// Before the redesign each pass ran 4.1-7.0x above its device-memory floor
// (PERF.md, NVIDIA H100 80GB HBM3 at 700 W) in barrier-separated radix-2
// sweeps; the FFTs are now register-resident radix-8 stages with
// conflict-free shared-memory exchanges and 16 warps per SM in f64, 32 in
// f32. For 2 x 30 s at 2^18 the passes now run 1.3-1.7x above their floor
// (0.052 / 0.071 / 0.049 ms in f64), a size whose scratch the L2 holds
// (in part, in f64); the kernel takes 0.168 ms (f64; 0.178 before pass
// 1's ring), 0.103 (f32) and 0.050 (i16) against 0.61, 0.33 and 0.20 ms
// for the plain version on cuFFT (PERF.md). At the bench's 1008 hops the scratch streams through
// device memory; experiments/fast_decomp_r05.py (csrc/probe_segment.cu)
// splits that time by part. There pass 1 in f64 ran furthest from its
// floor: 3.71 us a pair against 2.1-2.2 us for its 4.19 MB of scratch
// stores and ~2 MB of signal at the 2.87 TB/s copy rate. Its registers
// hold one 512-thread CTA an SM, so nothing overlapped one tile's gather,
// FFT and stores. It is now persistent (segment_filter.cuh Pass1): the
// resident CTAs walk the (pair, column tile) items, build the twiddle
// tables once, and cp.async the next item's signal into a ring of two
// stages while the current one is transformed: 2.85 us a pair (-23 %;
// passes 2 and 3 4.22 and 2.81 us as before; 2 x 1 h at 96 kHz: call
// p95 -7.7 %). f32 and i16 run two CTAs an SM, which already overlap, and
// there a ring ran slower (it takes the L1 the gather stages through), so
// they keep one CTA an item: 1.75 / 1.93 / 2.04 us a pair (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md). Pass 2 in f64 then held 43 % of the card's
// time at 2^18 (4.2 us a pair against 2.92 of bytes), its 512-thread CTA
// alone on its SM; it is persistent too (segment_filter.cuh Pass2): CTAs
// of 2 rows (128 threads), four an SM at the same register cap, walk the
// (pair, row tile) items and bring the next item's rows into a two-stage
// ring by one bulk copy each, the stage then the item's exchange tile:
// 3.56 us a pair at 2^18, 7.33 at 2^19 (8.46 before). The f32 and i16 row
// pass keeps rows_multiply. Pass 3 in f64 is persistent too
// (segment_filter.cuh Pass3): one 512-thread CTA an SM takes its (pair,
// column tile) items from a counter and brings the next item's tile into
// a two-stage ring by 2-D tensor-map copies: 2.29-2.30 us a pair at 2^18
// (2.81 before), 6.24-6.27 at 2^19 (7.40-7.43). f32 and i16 keep
// cols_inverse. fourstep.cuh holds the FFT engine, the
// passes' shared halves and rows_multiply (shared with conv_blocks.cu),
// and says why tensor cores are not used; segment_filter.cuh holds the
// signal gather, the valid-hop scatter, the peak, pass 2's ring and the
// launch loop, with the ablation switches whose defaults this file
// instantiates. All
// twiddles and H come from host float64 tables (rounded to float for the
// f32 modes); no fast-math sin/cos is used. Where the four-step twiddle
// table would exceed 4 MiB (f64 from B = 2^19, f32 from 2^20) the column
// passes take it as the product of two small factor tables
// (fourstep.cuh Twiddle).

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_filter.cuh"

namespace {

template <typename T, typename IO>
int run(const IO* x, IO* y, float* peak, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, int channels,
        long long n_in, long long out_len, long long left, int m, int log_n1,
        int log_n2, long long chunk_pairs, cudaStream_t stream) {
  Geometry g;
  const long long total =
      make_geometry(g, channels, n_in, out_len, left, m, log_n1 + log_n2);
  return with_split(log_n1, log_n2, [&](auto sp) {
    return run_split<T, IO, decltype(sp)>(
        x, y, reinterpret_cast<unsigned int*>(peak),
        static_cast<const Cx<T>*>(H), static_cast<const Cx<T>*>(tw4),
        static_cast<const Cx<T>*>(w1), static_cast<const Cx<T>*>(w2),
        static_cast<Cx<T>*>(scratch), g, total, chunk_pairs, stream);
  });
}

// The twiddle layout of one compute type at one split: [factored, table
// bytes, lo rows, hi rows] (the rows 0 where the table is not factored).
template <typename T>
int twiddle_layout_of(int log_n1, int log_n2, long long* out) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    using TW = Twiddle<T, decltype(sp)>;
    out[0] = TW::kFactored;
    out[1] = (long long)TW::kBytes;
    out[2] = TW::kLoRows;
    out[3] = TW::kHiRows;
    return (int)cudaSuccess;
  });
}

template <typename T, typename IO>
int pass1_occupancy_of(int log_n1, int log_n2, int* out) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    return pass1_occupancy<T, IO, decltype(sp)>(out);
  });
}

template <typename T, typename IO>
int pass3_occupancy_of(int log_n1, int log_n2, int* out) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    return pass3_occupancy<T, IO, decltype(sp)>(out);
  });
}

template <typename T>
int pass2_occupancy_of(int log_n1, int log_n2, int* out) {
  return with_split(log_n1, log_n2, [&](auto sp) {
    return pass2_occupancy<T, decltype(sp)>(out);
  });
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError().
// `peak` is three 32-bit words the caller zeroed: the peak (a float), then
// pass 3's item counter and count of finished CTAs (segment_filter.cuh
// Pass3), which the call leaves zero; scratch holds chunk_pairs * B
// complex values of the compute type.
#define LOWCUT_ENTRY(NAME, T, IO)                                             \
  extern "C" int NAME(const void* x, void* y, void* peak, const void* H,     \
                      const void* tw4, const void* w1, const void* w2,       \
                      void* scratch, int channels, long long n_in,           \
                      long long out_len, long long left, int m, int log_n1,  \
                      int log_n2, long long chunk_pairs, void* stream) {     \
    return run<T, IO>(static_cast<const IO*>(x), static_cast<IO*>(y),        \
                      static_cast<float*>(peak), H, tw4, w1, w2, scratch,    \
                      channels, n_in, out_len, left, m, log_n1, log_n2,      \
                      chunk_pairs, static_cast<cudaStream_t>(stream));       \
  }

LOWCUT_ENTRY(lowcut_segment_filter_f32, float, float)
LOWCUT_ENTRY(lowcut_segment_filter_f64, double, float)
LOWCUT_ENTRY(lowcut_segment_filter_i16, float, int16_t)

// Pass 1 of one mode (0 f32, 1 f64, 2 i16) at one split: out[8] ints, [CTAs
// per SM, threads, dynamic shared bytes, registers, local-memory bytes,
// ring depth, column tiles a pair, resident CTAs].
extern "C" int lowcut_segment_pass1_occupancy(int mode, int log_n1, int log_n2,
                                              void* out) {
  int* o = static_cast<int*>(out);
  switch (mode) {
    case 0: return pass1_occupancy_of<float, float>(log_n1, log_n2, o);
    case 1: return pass1_occupancy_of<double, float>(log_n1, log_n2, o);
    case 2: return pass1_occupancy_of<float, int16_t>(log_n1, log_n2, o);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 2 of one mode (0 f32, 1 f64, 2 i16) at one split: out[8] ints, [CTAs
// per SM, threads, dynamic shared bytes, registers, local-memory bytes,
// ring depth (0: rows_multiply, no ring), row tiles a pair, resident CTAs
// (0 without a ring)]. f32 and i16 share their row pass.
extern "C" int lowcut_segment_pass2_occupancy(int mode, int log_n1, int log_n2,
                                              void* out) {
  int* o = static_cast<int*>(out);
  switch (mode) {
    case 0:
    case 2: return pass2_occupancy_of<float>(log_n1, log_n2, o);
    case 1: return pass2_occupancy_of<double>(log_n1, log_n2, o);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 3 of one mode (0 f32, 1 f64, 2 i16) at one split: out[8] ints, [CTAs
// per SM, threads, dynamic shared bytes, registers, local-memory bytes,
// ring depth (0: cols_inverse, no ring), column tiles a pair, resident
// CTAs (0 without a ring)].
extern "C" int lowcut_segment_pass3_occupancy(int mode, int log_n1, int log_n2,
                                              void* out) {
  int* o = static_cast<int*>(out);
  switch (mode) {
    case 0: return pass3_occupancy_of<float, float>(log_n1, log_n2, o);
    case 1: return pass3_occupancy_of<double, float>(log_n1, log_n2, o);
    case 2: return pass3_occupancy_of<float, int16_t>(log_n1, log_n2, o);
    default: return cudaErrorInvalidValue;
  }
}

// The four-step twiddle table the column passes of one mode (0 f32, 1 f64,
// 2 i16) read at one split, as compiled: out[4] long longs, [factored (0
// or 1), table bytes, lo rows, hi rows]. Needs no card.
extern "C" int lowcut_segment_twiddle_layout(int mode, int log_n1, int log_n2,
                                             void* out) {
  long long* o = static_cast<long long*>(out);
  switch (mode) {
    case 0:
    case 2: return twiddle_layout_of<float>(log_n1, log_n2, o);
    case 1: return twiddle_layout_of<double>(log_n1, log_n2, o);
    default: return cudaErrorInvalidValue;
  }
}
