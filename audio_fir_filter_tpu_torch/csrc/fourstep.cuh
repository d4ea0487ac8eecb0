// Four-step FFT machinery shared by the port's CUDA kernels (sm_90a):
// segment_filter.cu (whole-segment overlap-save) and conv_blocks.cu
// (circular convolution of real blocks). Both convolve complex pairs of real
// blocks, z = x0 + i*x1, with the spectrum H of a real kernel:
//
//   B = N1 * N2;  pass 1: column FFTs (length N1) * four-step twiddle;
//   pass 2: row FFTs (length N2) * H, inverse row FFTs;
//   pass 3: * conjugate twiddle, inverse column FFTs, * 1/B.
//
// The passes share a [pairs, B] scratch in device memory (a 2^18 pair is
// 2 MB in complex64 and 4 MB in complex128, far above the 227 KB of shared
// memory a CTA may use). The forward FFTs are decimation in frequency
// (natural in, bit-reversed out) and the inverse ones decimation in time
// (bit-reversed in, natural out); the host lays H and the twiddle table out
// in that order, so nothing is ever reordered.
//
// What bounds the passes on this card, and the design. The radix-2 design
// that came before ran every pass 2.8-7.1x above its device-memory floor
// (the pass's bytes at the 2.87 TB/s TMA staged-copy rate of probe_floors
// bw; PERF.md, NVIDIA H100 80GB HBM3 at 700 W): nine barrier-separated
// sweeps over a shared tile per 512-point FFT, run-time index division,
// 32-way bank conflicts in pass 2's transposed tile, one 256-thread CTA
// per SM in f64. It was
// bound by that on-chip work, not by memory. The engine below cuts the
// work, and now each pass of the block kernel runs 1.2-1.4x above its
// floor at 128 x 2^18 (K1 / K2 / K3 0.204 / 0.275 / 0.174 ms in f64,
// 0.122 / 0.134 / 0.113 in f32), and the passes' data movement alone
// (no arithmetic) reaches 2.7-2.85 TB/s, 94-99 % of that rate (x.clone()
// 2.96 TB/s). So the passes are bound by device
// memory, or by L2 where the scratch fits it (8 pairs on the block path:
// 16 MB f32, 32 MB f64, against 50 MB of L2):
//
//   - Sizes are template parameters (Fft<T, LOG>, Split<LOG1, LOG2>): index
//     arithmetic is shifts and masks and every loop unrolls. with_split
//     dispatches the 25 qualifying splits (sides 2^1 .. 2^13); any other
//     split returns cudaErrorInvalidValue, which the wrappers raise.
//   - Each thread holds 8 elements of one transform in registers (L / 8
//     threads per transform) and runs radix-2^3 butterflies there: a
//     radix-8 DFT whose outputs land in bit-reversed slots, so the order is
//     exactly the radix-2 DIF's. Sides whose log2 is not a multiple of 3
//     start with one radix-2 or radix-4 stage. 512 points: 3 register
//     stages, 2 exchanges through shared memory, 4 barriers (9 sweeps
//     before). The inner constant 1/sqrt(2) is a T literal; the stage
//     twiddles are read from per-stage tables built in shared memory from
//     the host's float64 half table (entry (k-1)*d + j = w_L^(j k L/(R d))),
//     so a stage reads consecutive entries; no sin/cos on the device.
//   - Exchanges go through shared memory at p ^ ((p >> 3) & 15): in every
//     stage the lanes of a 16-lane (8-byte element) or 8-lane (16-byte)
//     phase fall on distinct banks (tests/test_torch_fft_stages.py checks
//     each access). Passes 1 and 3 keep the column index w in the low lane
//     bits (element (p, w) at swizzle(p) * W + w), pass 2 puts a row's
//     threads on consecutive lanes and reads and writes the row straight
//     from the scratch, coalesced, with no transposed tile.
//   - Pass 1 stores from registers and pass 3 loads into registers; the
//     shared tile only carries the exchanges. Tiles: W = 8 columns (pass 1,
//     3) or 8 rows (pass 2) of 512 points, 512 threads and 72 KB (f64) or
//     36 KB (f32) of shared memory with the twiddle tables. The registers
//     bound occupancy, not shared memory: f64 runs one CTA (16 warps, up to
//     128 registers, no spills at 2^18) per SM, f32 two (32 warps, 64
//     registers); tighter caps for more CTAs spilled and ran slower
//     (min_blocks).
//   - Every register index must fold to a constant (brev has no loop):
//     a thread's 8 elements otherwise go to local memory.
//   - Global accesses stay 8 or 16 bytes (one element) a thread: the
//     gathers read 8 columns (32 bytes of a row) per 8 lanes, and the
//     passes with no arithmetic already move their bytes at 94-99 % of
//     the TMA staged-copy rate (2.87 TB/s), so neither 16-byte vectors of
//     real samples nor TMA staging (its own copy is at most 6 % faster
//     than these passes) has more than a few percent left to gain.
//   - Tensor cores are not used: even the old passes did only about 1.3
//     TFLOP/s in f64, a few percent of the card, and the new ones are bound
//     by memory; TF32 would break the f32 gate (1 LSB @ 16 bits) without
//     error compensation, and a DFT as a matmul on FP64 DMMA or split TF32
//     (FlashFFTConv, arXiv 2311.05908) waits until a pass is shown to be
//     bound by arithmetic.
//
// The kernels differ only in pass 1's gather and pass 3's scatter, which
// each source writes around cols_forward_store / cols_inverse_load. The
// probes (probe_phases.cu, probe_floors.cu, probe_stages.cu) launch these
// passes with switches whose defaults are the shipped code.
//
// Everything here has internal linkage: each kernel source is its own
// library with its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <initializer_list>
#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

// Block size of the probes' plain copy and stage kernels.
constexpr int kThreads = 256;

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
template <typename T>
__device__ __forceinline__ Cx<T> scl(Cx<T> a, T c) {
  return {a.re * c, a.im * c};
}
// a * (-i) in a forward DFT, a * (+i) in an inverse one.
template <typename T, bool kInv>
__device__ __forceinline__ Cx<T> rot(Cx<T> a) {
  if constexpr (kInv) {
    return {-a.im, a.re};
  } else {
    return {a.im, -a.re};
  }
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cclamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__host__ __device__ constexpr int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}
// k < 2^bits bit-reversed, bits <= 3. No loop: the butterflies index their
// registers with it, and nvcc kept a loop here rolled in the full build
// (the index then is not a constant), which put the registers in local
// memory and made the passes 2.3x slower (PERF.md).
__host__ __device__ __forceinline__ constexpr int brev(int k, int bits) {
  return bits == 1 ? k
       : bits == 2 ? ((k & 1) << 1) | (k >> 1)
                   : ((k & 1) << 2) | (k & 2) | (k >> 2);
}

// f(integral_constant<int, I>) for I = B .. E-1, unrolled.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// Radix-R DFT of a[0..R) in registers, natural order in and out; the
// inverse (kInv) is unscaled.
template <typename T, int R, bool kInv>
__device__ __forceinline__ void dft(Cx<T> (&a)[R]) {
  if constexpr (R == 2) {
    const Cx<T> x = a[0], y = a[1];
    a[0] = cadd(x, y);
    a[1] = csub(x, y);
  } else if constexpr (R == 4) {
    const Cx<T> t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const Cx<T> t2 = cadd(a[1], a[3]), t3 = rot<T, kInv>(csub(a[1], a[3]));
    a[0] = cadd(t0, t2);
    a[1] = cadd(t1, t3);
    a[2] = csub(t0, t2);
    a[3] = csub(t1, t3);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    const T r = T(0.70710678118654752440);
    Cx<T> b0[4], b1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b0[q] = cadd(a[q], a[q + 4]);
      b1[q] = csub(a[q], a[q + 4]);
    }
    const Cx<T> c0 = cadd(b0[0], b0[2]), c1 = csub(b0[0], b0[2]);
    const Cx<T> c2 = cadd(b0[1], b0[3]), c3 = rot<T, kInv>(csub(b0[1], b0[3]));
    const Cx<T> d0 = b1[0], d2 = rot<T, kInv>(b1[2]);
    const Cx<T> d1 = scl(cadd(b1[1], rot<T, kInv>(b1[1])), r);
    const Cx<T> d3 = scl(csub(rot<T, kInv>(b1[3]), b1[3]), r);
    const Cx<T> e0 = cadd(d0, d2), e1 = csub(d0, d2), e2 = cadd(d1, d3);
    const Cx<T> e3 = rot<T, kInv>(csub(d1, d3));
    a[0] = cadd(c0, c2);
    a[1] = cadd(e0, e2);
    a[2] = cadd(c1, c3);
    a[3] = cadd(e1, e3);
    a[4] = csub(c0, c2);
    a[5] = csub(e0, e2);
    a[6] = csub(c1, c3);
    a[7] = csub(e1, e3);
  }
}

// One length-2^LOG transform held by kNT threads of kE registers each.
// Stage s has radix 2^lrad(s) and span d = 2^ld(s): stage 0 takes the
// remainder of LOG mod 3 (or radix 8), the rest are radix 8 down to d = 1.
// In stage s, register m of thread t holds position pos<s>(t, m).
template <typename T, int LOG>
struct Fft {
  static_assert(LOG >= 1 && LOG <= 13, "sides 2^1 .. 2^13");
  static constexpr int kL = 1 << LOG;
  static constexpr int kE = LOG >= 3 ? 8 : kL;  // registers per thread
  static constexpr int kNT = kL / kE;           // threads per transform
  static constexpr int kLogNT = LOG >= 3 ? LOG - 3 : 0;
  static constexpr int kR0 = LOG < 3 ? LOG : (LOG % 3 ? LOG % 3 : 3);
  static constexpr int kStages = LOG < 3 ? 1 : (LOG + 2) / 3;
  // The per-stage tables hold L - 1 entries; at 2^13 in f64 they and the
  // exchange tile (128 KB each) exceed a CTA's shared memory, so that size
  // reads the host's half table from device memory (L1-cached) instead.
  static constexpr bool kGlobalTw = LOG == 13 && sizeof(T) == 8;
  static constexpr int kTableElems = kGlobalTw ? 0 : kL - 1;

  __host__ __device__ static constexpr int lrad(int s) { return s == 0 ? kR0 : 3; }
  __host__ __device__ static constexpr int ld(int s) { return LOG - kR0 - 3 * s; }
  // Offset of stage s's table: sum of (R - 1) * d over the stages before.
  __host__ __device__ static constexpr int toff(int s) {
    int o = 0;
    for (int i = 0; i < s; ++i) o += ((1 << lrad(i)) - 1) << ld(i);
    return o;
  }

  template <int S>
  __device__ static __forceinline__ int pos(int t, int m) {
    if constexpr (lrad(S) < 3) {
      return t + m * kNT;
    } else {
      constexpr int e = ld(S);
      return ((t >> e) << (e + 3)) | (t & ((1 << e) - 1)) | (m << e);
    }
  }

  // Exchange-tile address of position p (bank-conflict-free swizzle).
  __device__ static __forceinline__ int swz(int p) { return p ^ ((p >> 3) & 15); }

  // w_L^e, e < L, from the half table exp(-2 pi i k / L), k < L / 2.
  __device__ static __forceinline__ Cx<T> raw(const Cx<T>* __restrict__ half,
                                              int e) {
    if (e < kL / 2) return half[e];
    const Cx<T> h = half[e - kL / 2];
    return {-h.re, -h.im};
  }

  // Stage S's twiddle w_L^(j k u): tw is the shared stage tables, or the
  // half table itself with kGlobalTw.
  template <int S>
  __device__ static __forceinline__ Cx<T> twiddle(const Cx<T>* tw, int k, int j) {
    constexpr int u = kL >> (lrad(S) + ld(S)), off = toff(S);
    if constexpr (kGlobalTw) {
      return raw(tw, j * k * u);
    } else {
      return tw[off + ((k - 1) << ld(S)) + j];
    }
  }

  // Build the stage tables from the half table (all threads of the CTA);
  // the caller synchronizes before the first stage.
  __device__ static void build_table(Cx<T>* tab, const Cx<T>* __restrict__ half,
                                     int tid, int nthreads) {
    if constexpr (!kGlobalTw) {
      static_for<0, kStages>([&](auto sc) {
        constexpr int S = decltype(sc)::value;
        constexpr int D = 1 << ld(S), u = kL >> (lrad(S) + ld(S));
        constexpr int n = ((1 << lrad(S)) - 1) * D;
        for (int i = tid; i < n; i += nthreads) {
          const int k = (i >> ld(S)) + 1, j = i & (D - 1);
          tab[toff(S) + i] = raw(half, j * k * u);
        }
      });
    }
  }

  // Stage S's butterflies in registers. Forward: radix-R DFT of registers
  // i + q * (kE / R), output k to register i + brev(k) * (kE / R) times the
  // twiddle. Inverse: the reverse, with conjugate twiddles.
  template <int S, bool kInv>
  __device__ static __forceinline__ void stage(Cx<T> (&v)[kE], const Cx<T>* tw,
                                               int t) {
    constexpr int LR = lrad(S), R = 1 << LR, SUB = kE / R, D = 1 << ld(S);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int j = LR < 3 ? t + i * kNT : (t & (D - 1));
      Cx<T> a[R];
      if constexpr (!kInv) {
#pragma unroll
        for (int q = 0; q < R; ++q) a[q] = v[i + q * SUB];
        dft<T, R, false>(a);
        v[i] = a[0];
#pragma unroll
        for (int k = 1; k < R; ++k)
          v[i + brev(k, LR) * SUB] = cmul(a[k], twiddle<S>(tw, k, j));
      } else {
        a[0] = v[i];
#pragma unroll
        for (int k = 1; k < R; ++k)
          a[k] = cmulc(v[i + brev(k, LR) * SUB], twiddle<S>(tw, k, j));
        dft<T, R, true>(a);
#pragma unroll
        for (int q = 0; q < R; ++q) v[i + q * SUB] = a[q];
      }
    }
  }

  // Registers from stage SF's positions to stage ST's through the tile s
  // (position p at s[swz(p) * STRIDE]). kLead: the tile was read before,
  // so wait for those reads first.
  template <int STRIDE, int SF, int ST, bool kLead>
  __device__ static __forceinline__ void exchange(Cx<T> (&v)[kE], Cx<T>* s, int t) {
    if constexpr (kLead) __syncthreads();
#pragma unroll
    for (int m = 0; m < kE; ++m) s[swz(pos<SF>(t, m)) * STRIDE] = v[m];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kE; ++m) v[m] = s[swz(pos<ST>(t, m)) * STRIDE];
  }

  // Forward DIF: positions pos<0> (natural) in, pos<kStages - 1> out
  // (bit-reversed). kArith = false keeps the exchanges and drops the
  // butterflies (a probe's round trip). Everything down to the butterflies
  // is forced inline: v passed by reference to a call that is not inlined
  // lives in local memory.
  template <int STRIDE, bool kLead, bool kArith = true, int S = 0>
  __device__ static __forceinline__ void forward(Cx<T> (&v)[kE], Cx<T>* s,
                                                 const Cx<T>* tw, int t) {
    if constexpr (S > 0) exchange<STRIDE, S - 1, S, kLead || (S > 1)>(v, s, t);
    if constexpr (kArith) stage<S, false>(v, tw, t);
    if constexpr (S + 1 < kStages) forward<STRIDE, kLead, kArith, S + 1>(v, s, tw, t);
  }

  // Inverse DIT, unscaled: pos<kStages - 1> in, pos<0> out.
  template <int STRIDE, bool kLead, bool kArith = true, int S = kStages - 1>
  __device__ static __forceinline__ void inverse(Cx<T> (&v)[kE], Cx<T>* s,
                                                 const Cx<T>* tw, int t) {
    if constexpr (S < kStages - 1)
      exchange<STRIDE, S + 1, S, kLead || (S < kStages - 2)>(v, s, t);
    if constexpr (kArith) stage<S, true>(v, tw, t);
    if constexpr (S > 0) inverse<STRIDE, kLead, kArith, S - 1>(v, s, tw, t);
  }
};

// The four-step split B = 2^LOG1 * 2^LOG2 (LOG1 = LOG2 or LOG2 + 1) and the
// tile widths: kTc columns per CTA in passes 1 and 3, kTr rows in pass 2 --
// 8 up to 512-point sides, fewer above so that a CTA has at most 512
// threads (1024 at 2^13).
template <int LOG1, int LOG2>
struct Split {
  static constexpr int kLog1 = LOG1, kLog2 = LOG2;
  static constexpr int kN1 = 1 << LOG1, kN2 = 1 << LOG2;
  static constexpr long long kB = (long long)kN1 * kN2;
  static constexpr int kTc = cmin(cclamp(4096 >> LOG1, 1, 8), kN2);
  static constexpr int kTr = cmin(cclamp(4096 >> LOG2, 1, 8), kN1);
};

// CTAs per SM the register cap aims at: one of 512 threads in f64 (up to
// 128 registers), two in f32 (64). Measured on the card (PERF.md):
// capping f64 at 64 registers for 2 CTAs, or f32 at 42 for 3, spills
// 100-220 bytes a thread and runs 21-27 % slower; 256-thread CTAs (4
// columns a tile) are 5-7 % (f64) and 29-54 % (f32) slower.
__host__ __device__ constexpr int min_blocks(int threads, bool f64) {
  return cclamp((f64 ? 512 : 1024) / threads, 1, 16);
}

// Passes 1 and 3: thread (t, w) = threadIdx.x >> kLogW, & (kW - 1).
template <typename T, class S>
struct Cols {
  using F = Fft<T, S::kLog1>;
  static constexpr int kW = S::kTc, kLogW = ilog2(kW);
  static constexpr int kThreads = kW * F::kNT;
  static constexpr int kMinBlocks = min_blocks(kThreads, sizeof(T) == 8);
  static constexpr size_t kSmem =
      ((size_t)F::kTableElems + (size_t)kW * F::kL) * sizeof(Cx<T>);
};

// Pass 2: thread (r, t) = threadIdx.x >> kLogNT, & (kNT - 1).
template <typename T, class S>
struct Rows {
  using F = Fft<T, S::kLog2>;
  static constexpr int kR = S::kTr;
  static constexpr int kThreads = kR * F::kNT;
  static constexpr int kMinBlocks = min_blocks(kThreads, sizeof(T) == 8);
  static constexpr size_t kSmem =
      ((size_t)F::kTableElems + (size_t)kR * F::kL) * sizeof(Cx<T>);
};

// Every split the wrappers qualify: B = 2^2 .. 2^26.
#define LOWCUT_SPLITS(X)                                                     \
  X(1, 1) X(2, 1) X(2, 2) X(3, 2) X(3, 3) X(4, 3) X(4, 4) X(5, 4) X(5, 5)   \
  X(6, 5) X(6, 6) X(7, 6) X(7, 7) X(8, 7) X(8, 8) X(9, 8) X(9, 9) X(10, 9)  \
  X(10, 10) X(11, 10) X(11, 11) X(12, 11) X(12, 12) X(13, 12) X(13, 13)

// f(Split<log_n1, log_n2>{}) for a listed split; cudaErrorInvalidValue for
// any other (no instantiation, no fallback).
#define LOWCUT_SPLIT_CASE(A, B) \
  if (log_n1 == (A) && log_n2 == (B)) return f(Split<(A), (B)>{});

template <typename F>
int with_split(int log_n1, int log_n2, F&& f) {
  LOWCUT_SPLITS(LOWCUT_SPLIT_CASE)
  return cudaErrorInvalidValue;
}

// The four-step twiddle of the column passes: scratch row p of column c
// takes w_B^(k1 * c), k1 = bitrev(p) over LOG1 bits. Where the full
// [N1, N2] table (tw4) would hold more than 4 MiB -- f64 from B = 2^19,
// f32 from 2^20 -- each column pass reads 8 MiB or more of it a pair, as
// many bytes as the pair's scratch. There the twiddle is the product of
// two factor tables, packed one after the other in tw4's place. The
// column passes' registers hold rows pos<kLast>(t, m) = 8 t + m, so
// k1 = brev(m) << kH | bt, with kH = LOG1 - 3 and bt = t bit-reversed
// over kH bits:
//   lo[bt, c]      = w_B^(bt * c),               2^kH rows of N2,
//   hi[brev(m), c] = w_B^(brev(m) * 2^kH * c),   8 rows of N2,
// each rounded once from float64 on the host; the product is within
// about 1.5 ulp of the exact twiddle. A thread loads its lo entry once,
// and its 8 hi entries are those of every thread of its column. At
// (10, 9) in f64 that is 1 MiB + 64 KiB in place of 8 MiB, and the two
// column passes take 15.17 us a pair in place of 15.76 (a unit held in
// registers in place of every twiddle, probe_segment.cu no_tw4: 14.4).
// Splitting k1 at ceil(LOG1 / 2) instead (two 256 KiB tables, every
// register its own pair of entries) gave 15.43 (PERF.md). At and below
// 4 MiB the passes read tw4 as before and compile to the same code.
// ops/segment_filter.kernel_tables lays the tables out by the same rule;
// segment_filter.cu's lowcut_segment_twiddle_layout reports it.
template <typename T, class S>
struct Twiddle {
  static constexpr size_t kFullBytes = sizeof(Cx<T>) * (size_t)S::kB;
  static constexpr bool kFactored = kFullBytes > ((size_t)4 << 20);
  // The factor tables' rows (0 where the table is read whole, which every
  // split below 2^3-point columns is).
  static constexpr int kH = kFactored ? S::kLog1 - 3 : 0;
  static constexpr int kLoRows = kFactored ? 1 << kH : 0;
  static constexpr int kHiRows = kFactored ? 8 : 0;
  static constexpr size_t kBytes =
      kFactored ? sizeof(Cx<T>) * (size_t)(kLoRows + kHiRows) * S::kN2
                : kFullBytes;
};

// Thread t's factored twiddles at column c (kOn: the passes multiply by
// factored twiddles; otherwise empty, and nothing is read).
template <typename T, class S, bool kOn>
struct ColTwiddle {
  __device__ __forceinline__ ColTwiddle(const Cx<T>*, int, int) {}
};
template <typename T, class S>
struct ColTwiddle<T, S, true> {
  using TW = Twiddle<T, S>;
  using F = Fft<T, S::kLog1>;
  static_assert(F::lrad(F::kStages - 1) == 3 && F::ld(F::kStages - 1) == 0 &&
                    F::kNT == TW::kLoRows,
                "the last stage's rows are 8 t + m");
  const Cx<T>* hi;  // register 0's hi factor (brev(0) = 0) at column c
  Cx<T> lo;
  __device__ __forceinline__ ColTwiddle(const Cx<T>* __restrict__ tab, int t,
                                        int c) {
    const int bt = (int)(__brev((unsigned)t) >> (32 - TW::kH));
    lo = tab[(size_t)bt * S::kN2 + c];
    hi = tab + (size_t)TW::kLoRows * S::kN2 + c;
  }
  // Register m's twiddle.
  __device__ __forceinline__ Cx<T> operator()(int m) const {
    return cmul(hi[(size_t)brev(m, 3) * S::kN2], lo);
  }
};

// The column passes take three switches for the decomposition probes
// (experiments/, csrc/probe_phases.cu, csrc/probe_segment.cu); the
// defaults are the shipped code:
//   kArith   = false: no FFT and no twiddle, a pure gather/scatter;
//   kStrided = false: the tile goes to one contiguous run of the scratch
//              (tc * N1 values at c0 * N1, row-major in the tile) instead
//              of column-strided;
//   kTw4     = false: the four-step twiddle multiply stays, but by
//              opaque_unit, a value in registers, so no twiddle table is
//              read.

// The no_tw4 probe's twiddle: (1, 0) at run time (the table pointer is
// never null), a unit nvcc cannot fold, so the complex multiply stays.
template <typename T>
__device__ __forceinline__ Cx<T> opaque_unit(const void* p) {
  const T z = static_cast<T>(p == nullptr);
  return {T(1) - z, z};
}

// Pass 1, after the gather: v holds column c0 + w of one pair at rows
// pos<0>(t, m) in natural order; s is the column's exchange tile (stride
// kW) and tw the twiddles of a length-N1 FFT. Column FFT, then the pair's
// scratch gets it times the four-step twiddle (scratch row p holds
// k1 = bitrev(p); tw4 as Twiddle<T, S> lays it out), straight from the
// registers.
template <typename T, class S, bool kArith = true, bool kStrided = true,
          bool kTw4 = true>
__device__ __forceinline__ void cols_forward_store(
    Cx<T> (&v)[Fft<T, S::kLog1>::kE], Cx<T>* s, const Cx<T>* tw,
    Cx<T>* __restrict__ out, const Cx<T>* __restrict__ tw4, int c0, int t,
    int w) {
  using C = Cols<T, S>;
  using F = typename C::F;
  constexpr int kLast = kArith ? F::kStages - 1 : 0;
  constexpr bool kFactored = kArith && kTw4 && Twiddle<T, S>::kFactored;
  if constexpr (kArith) {
    __syncthreads();  // the twiddle tables
    F::template forward<C::kW, false>(v, s, tw, t);
  }
  [[maybe_unused]] const ColTwiddle<T, S, kFactored> ft(tw4, t, c0 + w);
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const int p = F::template pos<kLast>(t, m);
    const size_t idx = (size_t)p * S::kN2 + c0 + w;
    const size_t at = kStrided ? idx : (size_t)c0 * S::kN1 + p * C::kW + w;
    if constexpr (kFactored) {
      out[at] = cmul(v[m], ft(m));
    } else if constexpr (kArith && kTw4) {
      out[at] = cmul(v[m], tw4[idx]);
    } else if constexpr (kArith) {
      out[at] = cmul(v[m], opaque_unit<T>(tw4));
    } else {
      out[at] = v[m];
    }
  }
}

// What pass 2 runs: the shipped FFT * H * inverse, or (probes only) its
// forward FFT alone, or its load, exchanges and store with no arithmetic.
constexpr int kRowsFull = 0, kRowsForward = 1, kRowsCopy = 2;

// Pass 2 on one row held in registers at pos<0>(t, m) (scratch row `row`
// of a pair, at blk): FFT, times H, inverse FFT, stored to blk in place;
// s is the row's exchange tile. kLead: the tile was read before (by an
// earlier item of a persistent CTA), so its first exchange waits for those
// reads. rows_multiply and segment_filter.cuh's persistent pass share it.
template <typename T, class S, int kRows, bool kLead>
__device__ __forceinline__ void rows_transform(
    Cx<T> (&v)[Fft<T, S::kLog2>::kE], Cx<T>* s, const Cx<T>* tw,
    const Cx<T>* H, size_t row, Cx<T>* blk, int t) {
  using F = Fft<T, S::kLog2>;
  constexpr bool kArith = kRows != kRowsCopy;
  constexpr int kLast = F::kStages - 1;
  F::template forward<1, kLead, kArith>(v, s, tw, t);
  if constexpr (kRows == kRowsForward) {
#pragma unroll
    for (int m = 0; m < F::kE; ++m) blk[F::template pos<kLast>(t, m)] = v[m];
  } else {
    if constexpr (kRows == kRowsFull) {
      const Cx<T>* Hr = H + row * S::kN2;
#pragma unroll
      for (int m = 0; m < F::kE; ++m)
        v[m] = cmul(v[m], Hr[F::template pos<kLast>(t, m)]);
    }
    F::template inverse<1, true, kArith>(v, s, tw, t);
#pragma unroll
    for (int m = 0; m < F::kE; ++m) blk[F::template pos<0>(t, m)] = v[m];
  }
}

// Pass 2: rows [blockIdx.x * kR, +kR) of pair blockIdx.y of the scratch:
// FFT, times H, inverse FFT, in place. Each row is read and written by its
// own kNT threads on consecutive lanes.
template <typename T, class S, int kRows = kRowsFull>
__global__ void __launch_bounds__(Rows<T, S>::kThreads, Rows<T, S>::kMinBlocks)
rows_multiply(Cx<T>* __restrict__ scratch, const Cx<T>* __restrict__ H,
              const Cx<T>* __restrict__ w2) {
  using RW = Rows<T, S>;
  using F = typename RW::F;
  constexpr bool kArith = kRows != kRowsCopy;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int t = tid & (F::kNT - 1), r = tid >> F::kLogNT;
  Cx<T>* s = tab + F::kTableElems + r * F::kL;
  const Cx<T>* tw = F::kGlobalTw ? w2 : tab;
  const size_t row = (size_t)blockIdx.x * RW::kR + r;
  Cx<T>* blk = scratch + (size_t)blockIdx.y * S::kB + row * S::kN2;

  if constexpr (kArith) F::build_table(tab, w2, tid, RW::kThreads);
  Cx<T> v[F::kE];
#pragma unroll
  for (int m = 0; m < F::kE; ++m) v[m] = blk[F::template pos<0>(t, m)];
  if constexpr (kArith) __syncthreads();  // the twiddle tables
  rows_transform<T, S, kRows, false>(v, s, tw, H, row, blk, t);
}

// Pass 3, before the scatter: v gets column c0 + w of the pair's scratch
// blk times the conjugate four-step twiddle (tw4 as in
// cols_forward_store), then the inverse column FFT; it leaves
// rows pos<0>(t, m) in natural order, unscaled.
template <typename T, class S, bool kArith = true, bool kStrided = true,
          bool kTw4 = true>
__device__ __forceinline__ void cols_inverse_load(
    Cx<T> (&v)[Fft<T, S::kLog1>::kE], Cx<T>* s, const Cx<T>* tw,
    const Cx<T>* __restrict__ blk, const Cx<T>* __restrict__ tw4, int c0,
    int t, int w) {
  using C = Cols<T, S>;
  using F = typename C::F;
  constexpr int kFirst = kArith ? F::kStages - 1 : 0;
  constexpr bool kFactored = kArith && kTw4 && Twiddle<T, S>::kFactored;
  [[maybe_unused]] const ColTwiddle<T, S, kFactored> ft(tw4, t, c0 + w);
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const int p = F::template pos<kFirst>(t, m);
    const size_t idx = (size_t)p * S::kN2 + c0 + w;
    const size_t at = kStrided ? idx : (size_t)c0 * S::kN1 + p * C::kW + w;
    if constexpr (kFactored) {
      v[m] = cmulc(blk[at], ft(m));
    } else if constexpr (kArith && kTw4) {
      v[m] = cmulc(blk[at], tw4[idx]);
    } else if constexpr (kArith) {
      v[m] = cmulc(blk[at], opaque_unit<T>(tw4));
    } else {
      v[m] = blk[at];
    }
  }
  if constexpr (kArith) {
    __syncthreads();  // the twiddle tables
    F::template inverse<C::kW, false>(v, s, tw, t);
  }
}

// A kernel and the dynamic shared bytes it launches with.
struct SmemLimit {
  const void* kernel;
  size_t bytes;
  template <typename K>
  SmemLimit(K k, size_t b) : kernel((const void*)k), bytes(b) {}
};

// Raise each kernel's dynamic shared-memory limit to its bytes once per
// card (the current device's ordinal: mesh cells may sit on several); the
// limit lasts in the card's context. A failure is returned and not
// remembered, so the next call tries again.
inline cudaError_t allow_smem(std::initializer_list<SmemLimit> limits) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const SmemLimit& l : limits) {
    if (done.count({l.kernel, dev})) continue;
    err = cudaFuncSetAttribute(
        l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
    if (err != cudaSuccess) return err;
    done.insert({l.kernel, dev});
  }
  return cudaSuccess;
}

// For one kernel: [CTAs per SM, threads, dynamic shared bytes, registers
// per thread, local-memory (stack and spill) bytes per thread].
template <typename K>
cudaError_t occupancy(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  out[0] = n;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = a.numRegs;
  out[4] = (int)a.localSizeBytes;
  return err;
}

}  // namespace
