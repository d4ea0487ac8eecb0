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
// a block may use, so the TPU's "whole block resident in VMEM" design does
// not carry over. This kernel is a four-step FFT, B = N1*N2 (512*512 at
// 2^18), in three launches with a [pairs, B] scratch in device memory
// between them. Each pass reads and writes the scratch once (~30 MB of
// traffic per float64 pair with the tables) and each length-N
// shared-memory FFT makes log2(N) barrier-separated radix-2 sweeps over
// its tile. On an H100 SXM (700 W) a float64 pair takes ~50 us: ~0.6 TB/s
// and ~1 TFLOP/s, so the sweeps, not device memory or arithmetic, limit
// this simple design:
//   1. forward columns: gather the pair's two windows straight from the
//      signal, length-N1 DIF FFT down each column (natural in, bit-reversed
//      out), times the four-step twiddle;
//   2. rows: length-N2 DIF FFT, times H (host-laid-out in this exact
//      bit-reversed order, so no reordering happens anywhere), inverse
//      length-N2 DIT FFT (bit-reversed in, natural out);
//   3. inverse columns: times the conjugate twiddle, inverse DIT FFT, scale
//      1/B, write only the valid positions, quantize for int16 I/O, and take
//      the output peak max|y| over written positions (atomicMax on the float
//      bits, which order like the values for non-negative floats).
// All twiddles and H come from host float64 tables (rounded to float for the
// f32 modes); no fast-math sin/cos is used. The FFTs, pass 2 and the column
// passes' shared halves live in fourstep.cuh (shared with conv_blocks.cu);
// this file holds the signal gather, the valid-hop scatter and the peak.
// Making this fast (wgmma DFT as a matmul, TMA, fewer sweeps) is later work.

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
  Split sp;              // B = N1 * N2 and the tile widths
};

// Pass 1: forward column FFTs of pair (pair0 + blockIdx.y), columns
// [blockIdx.x * tc, +tc), gathered straight from the signal.
template <typename T, typename IO>
__global__ void __launch_bounds__(kThreads)
cols_forward(const IO* __restrict__ x, Cx<T>* __restrict__ scratch,
             const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
             Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << g.sp.log_n1, n2 = 1 << g.sp.log_n2, tc = g.sp.tc;
  Cx<T>* tws = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tws + (n1 >> 1);
  const long long p = g.pair0 + blockIdx.y;
  const long long ch = p / g.pairs_per_ch;
  const long long k = p % g.pairs_per_ch;
  const int c0 = blockIdx.x * tc;
  const IO* xc = x + ch * g.n_in;
  const long long s0 = 2 * k * g.hop - g.left;
  const long long s1 = s0 + g.hop;

  load_table(tws, w1, n1 >> 1);
  for (int i = threadIdx.x; i < tc * n1; i += blockDim.x) {
    const int w = i % tc, row = i / tc;
    const long long n = (long long)row * n2 + c0 + w;
    const long long i0 = s0 + n, i1 = s1 + n;
    Cx<T> v;
    v.re = (i0 >= 0 && i0 < g.n_in) ? load_sample<T>(xc[i0]) : T(0);
    v.im = (i1 >= 0 && i1 < g.n_in) ? load_sample<T>(xc[i1]) : T(0);
    s[row * tc + w] = v;
  }
  cols_forward_store(s, tws, scratch + (size_t)blockIdx.y * ((size_t)n1 * n2),
                     tw4, g.sp, c0);
}

// Pass 3: inverse column FFTs, valid-position write-out, fused peak.
template <typename T, typename IO>
__global__ void __launch_bounds__(kThreads)
cols_inverse(const Cx<T>* __restrict__ scratch, IO* __restrict__ y,
             unsigned int* __restrict__ peak_bits,
             const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
             Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n1 = 1 << g.sp.log_n1, n2 = 1 << g.sp.log_n2, tc = g.sp.tc;
  Cx<T>* tws = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tws + (n1 >> 1);
  const long long p = g.pair0 + blockIdx.y;
  const long long ch = p / g.pairs_per_ch;
  const long long k = p % g.pairs_per_ch;
  const int c0 = blockIdx.x * tc;

  load_table(tws, w1, n1 >> 1);
  cols_inverse_load(s, tws, scratch + (size_t)blockIdx.y * ((size_t)n1 * n2),
                    tw4, g.sp, c0);

  const T scale = T(1) / static_cast<T>((long long)n1 * n2);
  IO* yc = y + ch * g.out_len;
  const long long base0 = 2 * k * g.hop - g.m;  // out index of position n
  float pk = 0.0f;
  for (int i = threadIdx.x; i < tc * n1; i += blockDim.x) {
    const int w = i % tc, row = i / tc;
    const long long n = (long long)row * n2 + c0 + w;
    if (n < g.m) continue;
    const long long o0 = base0 + n, o1 = o0 + g.hop;
    const Cx<T> v = s[row * tc + w];
    if (o0 < g.out_len) pk = fmaxf(pk, store_sample(yc + o0, v.re * scale));
    if (o1 < g.out_len) pk = fmaxf(pk, store_sample(yc + o1, v.im * scale));
  }
  for (int off = 16; off > 0; off >>= 1)
    pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, off));
  if ((threadIdx.x & 31) == 0 && pk > 0.0f)
    atomicMax(peak_bits, __float_as_uint(pk));
}

template <typename T, typename IO>
int run(const IO* x, IO* y, float* peak, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, int channels,
        long long n_in, long long out_len, long long left, int m, int log_n1,
        int log_n2, long long chunk_pairs, cudaStream_t stream) {
  Geometry g;
  g.sp = make_split(log_n1, log_n2);
  g.n_in = n_in;
  g.out_len = out_len;
  g.left = left;
  g.hop = (1LL << (log_n1 + log_n2)) - m;
  g.m = m;
  const long long nb = (out_len + g.hop - 1) / g.hop;
  g.pairs_per_ch = (nb + 1) / 2;
  const long long total = g.pairs_per_ch * channels;

  cudaError_t err = allow_smem<T>(cols_forward<T, IO>, cols_inverse<T, IO>, g.sp);
  if (err != cudaSuccess) return err;
  const size_t sm_cols = cols_smem<T>(g.sp), sm_rows = rows_smem<T>(g.sp);
  const Cx<T>* Hc = static_cast<const Cx<T>*>(H);
  const Cx<T>* tw4c = static_cast<const Cx<T>*>(tw4);
  const Cx<T>* w1c = static_cast<const Cx<T>*>(w1);
  const Cx<T>* w2c = static_cast<const Cx<T>*>(w2);
  Cx<T>* sc = static_cast<Cx<T>*>(scratch);
  unsigned int* pk = reinterpret_cast<unsigned int*>(peak);
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    g.pair0 = p0;
    const dim3 grid_cols((1 << log_n2) / g.sp.tc, (unsigned)np);
    const dim3 grid_rows((1 << log_n1) / g.sp.tr, (unsigned)np);
    cols_forward<T, IO><<<grid_cols, kThreads, sm_cols, stream>>>(
        x, sc, tw4c, w1c, g);
    rows_multiply<T><<<grid_rows, kThreads, sm_rows, stream>>>(sc, Hc, w2c,
                                                               g.sp);
    cols_inverse<T, IO><<<grid_cols, kThreads, sm_cols, stream>>>(
        sc, y, pk, tw4c, w1c, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
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
