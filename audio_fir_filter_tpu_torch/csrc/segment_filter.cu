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
// between them (at most 64 f64 pairs, 256 MB, a call; 2 x 30 s of 96 kHz
// audio is 7 pairs, 28 MB, which stays in the 50 MB L2):
//   1. forward columns: gather the pair's two windows straight from the
//      signal into registers, length-N1 DIF FFT down each column (natural
//      in, bit-reversed out), times the four-step twiddle, stored from the
//      registers;
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
// (0.052 / 0.071 / 0.049 ms in f64), so they are bound by memory (L2 at
// this size); the kernel takes 0.178 ms (f64), 0.103 (f32) and 0.049
// (i16) against 0.61, 0.33 and 0.20 ms for the plain version on cuFFT
// (PERF.md). fourstep.cuh holds that engine, the passes' shared
// halves and rows_multiply (shared with conv_blocks.cu), and says why
// tensor cores are not used; this file holds the signal gather, the
// valid-hop scatter and the peak. All twiddles and H come from host
// float64 tables (rounded to float for the f32 modes); no fast-math
// sin/cos is used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fourstep.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T load_sample(float v) { return static_cast<T>(v); }
template <typename T>
__device__ __forceinline__ T load_sample(int16_t v) {
  return static_cast<T>(static_cast<float>(v) * (1.0f / 32768.0f));
}

// Output conversion; returns |stored value| for the peak.
template <typename T>
__device__ __forceinline__ float store_sample(float* dst, T v) {
  const float f = static_cast<float>(v);
  *dst = f;
  return fabsf(f);
}
template <typename T>
__device__ __forceinline__ float store_sample(int16_t* dst, T v) {
  // The codec's rule, as the TPU writer: clip(rint(y * 2^15), -2^15,
  // 2^15 - 1). rintf rounds half to even like np.rint; clamp before the
  // cast. The peak is taken on the quantized value.
  float q = rintf(static_cast<float>(v) * 32768.0f);
  q = fminf(fmaxf(q, -32768.0f), 32767.0f);
  *dst = static_cast<int16_t>(q);
  return fabsf(q);
}

struct Geometry {
  long long n_in;        // input frames per channel
  long long out_len;     // output frames per channel
  long long left;        // virtual zero pad before x
  long long hop;         // B - M
  long long pairs_per_ch;
  long long pair0;       // first global pair of this chunk
  int m;                 // kernel order M
};

// Pass 1: forward column FFTs of pair (pair0 + blockIdx.y), columns
// [blockIdx.x * kW, +kW), gathered straight from the signal.
template <typename T, typename IO, class S>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
cols_forward(const IO* __restrict__ x, Cx<T>* __restrict__ scratch,
             const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
             Geometry g) {
  using C = Cols<T, S>;
  using F = typename C::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;
  const long long p = g.pair0 + blockIdx.y;
  const long long ch = p / g.pairs_per_ch;
  const long long k = p % g.pairs_per_ch;
  const int c0 = blockIdx.x * C::kW;
  const IO* xc = x + ch * g.n_in;
  const long long s0 = 2 * k * g.hop - g.left;
  const long long s1 = s0 + g.hop;

  F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const long long n = (long long)F::template pos<0>(t, m) * S::kN2 + c0 + w;
    const long long i0 = s0 + n, i1 = s1 + n;
    v[m].re = (i0 >= 0 && i0 < g.n_in) ? load_sample<T>(xc[i0]) : T(0);
    v[m].im = (i1 >= 0 && i1 < g.n_in) ? load_sample<T>(xc[i1]) : T(0);
  }
  cols_forward_store<T, S>(v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
                           scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);
}

// Pass 3: inverse column FFTs, valid-position write-out, fused peak.
template <typename T, typename IO, class S>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
cols_inverse(const Cx<T>* __restrict__ scratch, IO* __restrict__ y,
             unsigned int* __restrict__ peak_bits,
             const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
             Geometry g) {
  using C = Cols<T, S>;
  using F = typename C::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;
  const long long p = g.pair0 + blockIdx.y;
  const long long ch = p / g.pairs_per_ch;
  const long long k = p % g.pairs_per_ch;
  const int c0 = blockIdx.x * C::kW;

  F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
  cols_inverse_load<T, S>(v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
                          scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);

  const T scale = T(1) / static_cast<T>(S::kB);
  IO* yc = y + ch * g.out_len;
  const long long base0 = 2 * k * g.hop - g.m;  // out index of position n
  float pk = 0.0f;
#pragma unroll
  for (int m = 0; m < F::kE; ++m) {
    const long long n = (long long)F::template pos<0>(t, m) * S::kN2 + c0 + w;
    if (n < g.m) continue;
    const long long o0 = base0 + n, o1 = o0 + g.hop;
    if (o0 < g.out_len) pk = fmaxf(pk, store_sample(yc + o0, v[m].re * scale));
    if (o1 < g.out_len) pk = fmaxf(pk, store_sample(yc + o1, v[m].im * scale));
  }
  // Warp maximum; a CTA narrower than a warp (the smallest sides) reduces
  // over its own lanes only.
  constexpr int kLanes = C::kThreads < 32 ? C::kThreads : 32;
  constexpr unsigned kMask = kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    pk = fmaxf(pk, __shfl_xor_sync(kMask, pk, off));
  if ((threadIdx.x & 31) == 0 && pk > 0.0f)
    atomicMax(peak_bits, __float_as_uint(pk));
}

template <typename T, typename IO, class S>
int run_split(const IO* x, IO* y, unsigned int* pk, const Cx<T>* H,
              const Cx<T>* tw4, const Cx<T>* w1, const Cx<T>* w2, Cx<T>* sc,
              Geometry g, long long total, long long chunk_pairs,
              cudaStream_t stream) {
  using C = Cols<T, S>;
  using RW = Rows<T, S>;
  cudaError_t err =
      allow_smem<T, S>(cols_forward<T, IO, S>, cols_inverse<T, IO, S>);
  if (err != cudaSuccess) return err;
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    g.pair0 = p0;
    const dim3 grid_cols(S::kN2 / C::kW, (unsigned)np);
    const dim3 grid_rows(S::kN1 / RW::kR, (unsigned)np);
    cols_forward<T, IO, S><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        x, sc, tw4, w1, g);
    rows_multiply<T, S><<<grid_rows, RW::kThreads, RW::kSmem, stream>>>(
        sc, H, w2);
    cols_inverse<T, IO, S><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        sc, y, pk, tw4, w1, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename T, typename IO>
int run(const IO* x, IO* y, float* peak, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, int channels,
        long long n_in, long long out_len, long long left, int m, int log_n1,
        int log_n2, long long chunk_pairs, cudaStream_t stream) {
  Geometry g;
  g.n_in = n_in;
  g.out_len = out_len;
  g.left = left;
  g.hop = (1LL << (log_n1 + log_n2)) - m;
  g.m = m;
  g.pair0 = 0;
  const long long nb = (out_len + g.hop - 1) / g.hop;
  g.pairs_per_ch = (nb + 1) / 2;
  const long long total = g.pairs_per_ch * channels;
  return with_split(log_n1, log_n2, [&](auto sp) {
    return run_split<T, IO, decltype(sp)>(
        x, y, reinterpret_cast<unsigned int*>(peak),
        static_cast<const Cx<T>*>(H), static_cast<const Cx<T>*>(tw4),
        static_cast<const Cx<T>*>(w1), static_cast<const Cx<T>*>(w2),
        static_cast<Cx<T>*>(scratch), g, total, chunk_pairs, stream);
  });
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError().
// `peak` is one float the caller zeroed; scratch holds chunk_pairs * B
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
