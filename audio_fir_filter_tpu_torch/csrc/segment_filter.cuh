// The segment kernel's column passes (pass 1 with its signal gather, pass 3
// with its valid-hop scatter and peak) and its launch loop, shared by
// segment_filter.cu, which instantiates the defaults (the shipped kernel),
// and probe_segment.cu, which instantiates the ablation variants to time
// the code that ships. fourstep.cuh holds the FFT engine and pass 2
// (rows_multiply); segment_filter.cu says what the kernel computes and what
// bounds it. Internal linkage, as fourstep.cuh.

#pragma once

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

// Output conversion: the value written for v, as a float.
template <typename T>
__device__ __forceinline__ float out_value(float*, T v) {
  return static_cast<float>(v);
}
template <typename T>
__device__ __forceinline__ float out_value(int16_t*, T v) {
  // The codec's rule, as the TPU writer: clip(rint(y * 2^15), -2^15,
  // 2^15 - 1). rintf rounds half to even like np.rint; clamp before the
  // cast. The peak is taken on the quantized value.
  const float q = rintf(static_cast<float>(v) * 32768.0f);
  return fminf(fmaxf(q, -32768.0f), 32767.0f);
}

// Writes v to dst (unless kStore is off) and returns |written value| for
// the peak.
template <bool kStore, typename T, typename IO>
__device__ __forceinline__ float store_sample(IO* dst, T v) {
  const float f = out_value(dst, v);
  if constexpr (kStore) *dst = static_cast<IO>(f);
  return fabsf(f);
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

// The call's geometry for B = 2^log_b; returns the pairs of all channels.
inline long long make_geometry(Geometry& g, int channels, long long n_in,
                               long long out_len, long long left, int m,
                               int log_b) {
  g.n_in = n_in;
  g.out_len = out_len;
  g.left = left;
  g.hop = (1LL << log_b) - m;
  g.m = m;
  g.pair0 = 0;
  const long long nb = (out_len + g.hop - 1) / g.hop;
  g.pairs_per_ch = (nb + 1) / 2;
  return g.pairs_per_ch * channels;
}

// The ablation switches of probe_segment.cu; the defaults are the shipped
// kernel (segment_filter.cu instantiates nothing else):
//   kGather  = false: pass 1 reads no signal; its registers take an opaque
//              zero, so the FFTs after it still run;
//   kStore   = false: pass 3 writes no y and keeps the peak (its atomicMax
//              keeps every value, and so every FFT, alive);
//   kArith, kStrided: the column passes' switches of fourstep.cuh;
//              kArith = false also drops the twiddle tables and the 1/B
//              scale;
//   kRows:     what pass 2 runs (kRowsFull, or kRowsCopy: its load,
//              shared-memory exchanges and store only).
template <bool Gather = true, bool Store = true, bool Arith = true,
          bool Strided = true, int RowsV = kRowsFull>
struct Ablate {
  static constexpr bool kGather = Gather, kStore = Store, kArith = Arith,
                        kStrided = Strided;
  static constexpr int kRows = RowsV;
};
using Shipped = Ablate<>;

// Pass 1: forward column FFTs of pair (pair0 + blockIdx.y), columns
// [blockIdx.x * kW, +kW), gathered straight from the signal.
template <typename T, typename IO, class S, class A = Shipped>
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

  if constexpr (A::kArith) F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
  if constexpr (A::kGather) {
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      const long long n = (long long)F::template pos<0>(t, m) * S::kN2 + c0 + w;
      const long long i0 = s0 + n, i1 = s1 + n;
      v[m].re = (i0 >= 0 && i0 < g.n_in) ? load_sample<T>(xc[i0]) : T(0);
      v[m].im = (i1 >= 0 && i1 < g.n_in) ? load_sample<T>(xc[i1]) : T(0);
    }
  } else {
    // nvcc cannot fold x == nullptr (the wrapper passes the signal, which
    // is never read), and the registers get distinct multiples of it, so
    // no butterfly below sees a constant or two equal inputs.
    const T zero = static_cast<T>(x == nullptr);
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      v[m].re = zero * static_cast<T>(2 * m + 1);
      v[m].im = zero * static_cast<T>(2 * m + 2);
    }
  }
  cols_forward_store<T, S, A::kArith, A::kStrided>(
      v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
      scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);
}

// Pass 3: inverse column FFTs, valid-position write-out, fused peak.
template <typename T, typename IO, class S, class A = Shipped>
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

  if constexpr (A::kArith) F::build_table(tab, w1, tid, C::kThreads);
  Cx<T> v[F::kE];
  cols_inverse_load<T, S, A::kArith, A::kStrided>(
      v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
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
    T re = v[m].re, im = v[m].im;
    if constexpr (A::kArith) {
      re *= scale;
      im *= scale;
    }
    if (o0 < g.out_len) pk = fmaxf(pk, store_sample<A::kStore>(yc + o0, re));
    if (o1 < g.out_len) pk = fmaxf(pk, store_sample<A::kStore>(yc + o1, im));
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

// The three passes over `total` pairs, chunk_pairs at a time through the
// scratch.
template <typename T, typename IO, class S, class A = Shipped>
int run_split(const IO* x, IO* y, unsigned int* pk, const Cx<T>* H,
              const Cx<T>* tw4, const Cx<T>* w1, const Cx<T>* w2, Cx<T>* sc,
              Geometry g, long long total, long long chunk_pairs,
              cudaStream_t stream) {
  using C = Cols<T, S>;
  using RW = Rows<T, S>;
  cudaError_t err = smem_limit(cols_forward<T, IO, S, A>, C::kSmem);
  if (err == cudaSuccess)
    err = smem_limit(rows_multiply<T, S, A::kRows>, RW::kSmem);
  if (err == cudaSuccess) err = smem_limit(cols_inverse<T, IO, S, A>, C::kSmem);
  if (err != cudaSuccess) return err;
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    g.pair0 = p0;
    const dim3 grid_cols(S::kN2 / C::kW, (unsigned)np);
    const dim3 grid_rows(S::kN1 / RW::kR, (unsigned)np);
    cols_forward<T, IO, S, A><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        x, sc, tw4, w1, g);
    rows_multiply<T, S, A::kRows><<<grid_rows, RW::kThreads, RW::kSmem, stream>>>(
        sc, H, w2);
    cols_inverse<T, IO, S, A><<<grid_cols, C::kThreads, C::kSmem, stream>>>(
        sc, y, pk, tw4, w1, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace
