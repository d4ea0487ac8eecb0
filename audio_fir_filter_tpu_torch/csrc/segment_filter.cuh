// The segment kernel's column passes (pass 1 with its signal gather, pass 3
// with its valid-hop scatter and peak, and pass 3's persistent form,
// cols_inverse_ring), the persistent form of pass 2 (rows_multiply_ring)
// and its launch loop, shared by segment_filter.cu, which instantiates the
// defaults (the shipped kernel), and probe_segment.cu, which instantiates
// the ablation variants to time the code that ships. fourstep.cuh holds
// the FFT engine and pass 2 with one CTA an item (rows_multiply, and the
// per-row body both forms share); tma.cuh the bulk and tile copies and
// mbarriers of the rings of passes 2 and 3; segment_filter.cu says what
// the kernel computes and what bounds it. Internal linkage, as
// fourstep.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fourstep.cuh"
#include "tma.cuh"


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
//              shared-memory exchanges and store only);
//   kTw4:      the column passes' switch of fourstep.cuh: false multiplies
//              by a unit in registers and reads no twiddle table.
template <bool Gather = true, bool Store = true, bool Arith = true,
          bool Strided = true, int RowsV = kRowsFull, bool Tw4 = true>
struct Ablate {
  static constexpr bool kGather = Gather, kStore = Store, kArith = Arith,
                        kStrided = Strided, kTw4 = Tw4;
  static constexpr int kRows = RowsV;
};
using Shipped = Ablate<>;

// Pass 1's copies: cp.async of one 4-byte word into shared memory, with
// src_bytes = 0 for a zero word (nothing is read). Each thread waits for
// its own groups and reads back only the words it copied itself, so no
// barrier guards the ring.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The word of sample p a copy takes: p itself for float; for int16 the
// aligned word that holds p (a 2-byte sample has no 4-byte copy of its
// own; the word never leaves the 4-byte-aligned granule of a sample the
// signal holds), and the half p sits in.
__device__ __forceinline__ const void* sample_word(const float* p) { return p; }
__device__ __forceinline__ const void* sample_word(const int16_t* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                       ~uintptr_t(3));
}
template <typename T>
__device__ __forceinline__ T word_sample(const float*, uint32_t u, int) {
  return load_sample<T>(__uint_as_float(u));
}
template <typename T>
__device__ __forceinline__ T word_sample(const int16_t*, uint32_t u, int half) {
  return load_sample<T>(static_cast<int16_t>(u >> (16 * half)));
}

// Shared memory a CTA may use, an SM has, and the card keeps of it for
// each CTA.
constexpr size_t kCtaSmemMax = 232448, kSmSmem = 233472, kCtaReserved = 1024;

// Pass 1's items: item = local pair * kTiles + column tile, kTiles tiles
// of kW columns a pair.
//
// Where Cols aims at one CTA an SM (kMinBlocks == 1: f64 at 512-point and
// longer columns, f32 at 8192), no other CTA on the SM hides one item's
// gather, FFT and stores behind another's, so the pass is persistent: CTA
// b of G (the CTAs the card holds at once) walks items b, b + G, b + 2G,
// ..., builds its twiddle tables once, and gathers each item's signal
// (its pair's two windows at its kW columns) into a ring of kDepth
// shared-memory stages, kDepth - 1 items ahead of the one it transforms:
// word (win * kE + m) * kThreads + tid of a stage is register m of window
// win of thread tid. kDepth is what a CTA's shared memory holds beside
// the tables and the exchange tile, at most 2 (1 at 8192-point columns:
// the same loop, unpipelined). A third stage fits at 2^18 but takes the
// L1 that the pass's loads stage through: 3.08-3.16 us a pair against
// 2.82-2.85 at depth 2 (PERF.md).
//
// Where it aims at two or more (f32 and i16 at 2^18, f64 below 512-point
// columns), those CTAs already overlap one another's phases, and a ring's
// stages would come out of that L1 too: at 2^18 in f32 a two-stage ring
// made the pass 1.35x slower, one stage 1.12x (PERF.md). There kDepth =
// 0: one CTA an item (column tile blockIdx.x of pair blockIdx.y),
// gathering straight into its registers.
template <typename T, typename IO, class S>
struct Pass1 {
  using C = Cols<T, S>;
  using F = typename C::F;
  static constexpr int kTiles = S::kN2 / C::kW, kLogTiles = ilog2(kTiles);
  static constexpr int kStageWords = 2 * F::kE * C::kThreads;
  static constexpr size_t kStageBytes = (size_t)kStageWords * 4;
  static constexpr int kDepth =
      C::kMinBlocks > 1
          ? 0
          : cclamp((int)((kCtaSmemMax - C::kSmem) / kStageBytes), 1, 2);
  static constexpr size_t kSmem = C::kSmem + (size_t)kDepth * kStageBytes;
  static_assert(kSmem <= kCtaSmemMax, "the ring must fit a CTA");

  // An item's pair (local to the chunk), channel frame offset, first
  // window start and first column.
  struct Item {
    long long pl, base, s0;
    int c0;
    __device__ Item(const Geometry& g, long long pair, int tile) {
      pl = pair;
      c0 = tile * C::kW;
      const long long p = g.pair0 + pl;
      const long long ch = p / g.pairs_per_ch, k = p % g.pairs_per_ch;
      base = ch * g.n_in;
      s0 = 2 * k * g.hop - g.left;
    }
    __device__ Item(const Geometry& g, long long it)
        : Item(g, it >> kLogTiles, (int)(it & (kTiles - 1))) {}
  };

  // Without a ring: thread (t, w)'s registers of item c straight from the
  // signal (zero outside [0, n_in)).
  __device__ static __forceinline__ void load(Cx<T> (&v)[F::kE],
                                              const IO* __restrict__ x,
                                              const Geometry& g, const Item& c,
                                              int t, int w) {
    const IO* xc = x + c.base;
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      const long long n = (long long)F::template pos<0>(t, m) * S::kN2 + c.c0 + w;
      const long long i0 = c.s0 + n, i1 = i0 + g.hop;
      v[m].re = (i0 >= 0 && i0 < g.n_in) ? load_sample<T>(xc[i0]) : T(0);
      v[m].im = (i1 >= 0 && i1 < g.n_in) ? load_sample<T>(xc[i1]) : T(0);
    }
  }

  // Start the copies of item `it` into stage st (zero words outside
  // [0, n_in)).
  __device__ static __forceinline__ void gather(const IO* __restrict__ x,
                                                uint32_t* st, const Geometry& g,
                                                long long it, int t, int w,
                                                int tid) {
    const Item c(g, it);
    const IO* xc = x + c.base;
#pragma unroll
    for (int win = 0; win < 2; ++win) {
      const long long s = c.s0 + win * g.hop + c.c0 + w;
#pragma unroll
      for (int m = 0; m < F::kE; ++m) {
        const long long i = s + (long long)F::template pos<0>(t, m) * S::kN2;
        const bool in = i >= 0 && i < g.n_in;
        cp_async4(st + (win * F::kE + m) * C::kThreads + tid,
                  sample_word(in ? xc + i : x), in ? 4 : 0);
      }
    }
  }

  // Thread tid's registers of item c from stage st, once its copies landed.
  __device__ static __forceinline__ void read(Cx<T> (&v)[F::kE],
                                              const uint32_t* st,
                                              const IO* __restrict__ x,
                                              const Geometry& g, const Item& c,
                                              int w, int tid) {
    // The half of its word each window's samples sit in (int16 only; rows
    // step by N2, which is even).
    const long long a =
        (long long)(reinterpret_cast<uintptr_t>(x) / sizeof(IO)) + c.base +
        c.s0 + c.c0 + w;
    const int h0 = (int)(a & 1), h1 = (int)((a + g.hop) & 1);
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      v[m].re = word_sample<T>(x, st[m * C::kThreads + tid], h0);
      v[m].im = word_sample<T>(x, st[(F::kE + m) * C::kThreads + tid], h1);
    }
  }
};

// The registers of the no_gather ablation: nvcc cannot fold x == nullptr
// (the wrapper passes the signal, which is never read), and the registers
// get distinct multiples of it, so no butterfly after sees a constant or
// two equal inputs.
template <typename T, typename IO, int E>
__device__ __forceinline__ void opaque_zeros(Cx<T> (&v)[E], const IO* x) {
  const T zero = static_cast<T>(x == nullptr);
#pragma unroll
  for (int m = 0; m < E; ++m) {
    v[m].re = zero * static_cast<T>(2 * m + 1);
    v[m].im = zero * static_cast<T>(2 * m + 2);
  }
}

// Pass 1: forward column FFTs of the chunk's `items` (pair, column tile)
// items, each gathered straight from the signal (Pass1: through the ring,
// or into the registers of a CTA of its own), stored to its pair's
// scratch (cols_forward_store). Grid: pass1_grid.
template <typename T, typename IO, class S, class A = Shipped>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
cols_forward(const IO* __restrict__ x, Cx<T>* __restrict__ scratch,
             const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
             Geometry g, long long items) {
  using C = Cols<T, S>;
  using F = typename C::F;
  using P = Pass1<T, IO, S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = tab + F::kTableElems;
  const Cx<T>* tw = F::kGlobalTw ? w1 : tab;
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;

  if constexpr (P::kDepth == 0) {
    const typename P::Item c(g, blockIdx.y, blockIdx.x);
    if constexpr (A::kArith) F::build_table(tab, w1, tid, C::kThreads);
    Cx<T> v[F::kE];
    if constexpr (A::kGather) {
      P::load(v, x, g, c, t, w);
    } else {
      opaque_zeros(v, x);
    }
    cols_forward_store<T, S, A::kArith, A::kStrided, A::kTw4>(
        v, s + w, tw, scratch + (size_t)c.pl * S::kB, tw4, c.c0, t, w);
  } else {
    uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw + C::kSmem);
    const long long step = gridDim.x;
    // The first kDepth - 1 items' copies go out before the tables are
    // built, which happens once a CTA.
    if constexpr (A::kGather) {
#pragma unroll
      for (int d = 0; d < P::kDepth - 1; ++d) {
        const long long it = blockIdx.x + d * step;
        if (it < items) P::gather(x, ring + d * P::kStageWords, g, it, t, w, tid);
        cp_async_commit();
      }
    }
    if constexpr (A::kArith) F::build_table(tab, w1, tid, C::kThreads);
    int stage = 0;
    for (long long it = blockIdx.x; it < items; it += step) {
      const typename P::Item c(g, it);
      Cx<T> v[F::kE];
      if constexpr (A::kGather) {
        // Refill the stage read one item ago, then wait for this item's.
        const long long ahead = it + (P::kDepth - 1) * step;
        const int fill = stage == 0 ? P::kDepth - 1 : stage - 1;
        if (ahead < items)
          P::gather(x, ring + fill * P::kStageWords, g, ahead, t, w, tid);
        cp_async_commit();
        cp_async_wait<P::kDepth - 1>();
        P::read(v, ring + stage * P::kStageWords, x, g, c, w, tid);
        stage = stage + 1 == P::kDepth ? 0 : stage + 1;
      } else {
        opaque_zeros(v, x);
      }
      cols_forward_store<T, S, A::kArith, A::kStrided, A::kTw4>(
          v, s + w, tw, scratch + (size_t)c.pl * S::kB, tw4, c.c0, t, w);
    }
  }
}

// Pass 3's write-out of one item: v holds column c0 + w of the item's pair
// at rows pos<0>(t, m) in natural order, unscaled; yc is the pair's channel
// of y and base0 the out index of its row 0. Scales by 1/B, writes the
// valid positions of both windows and returns their largest |value|.
template <typename T, typename IO, class S, class A>
__device__ __forceinline__ float cols_inverse_scatter(
    const Cx<T> (&v)[Fft<T, S::kLog1>::kE], IO* yc, long long base0,
    const Geometry& g, int c0, int t, int w) {
  using F = Fft<T, S::kLog1>;
  const T scale = T(1) / static_cast<T>(S::kB);
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
  return pk;
}

// The CTA's peak: a warp maximum, then one atomicMax a warp. A CTA
// narrower than a warp (the smallest sides) reduces over its own lanes only.
template <int kThreads>
__device__ __forceinline__ void peak_max(float pk, unsigned int* peak_bits) {
  constexpr int kLanes = kThreads < 32 ? kThreads : 32;
  constexpr unsigned kMask = kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    pk = fmaxf(pk, __shfl_xor_sync(kMask, pk, off));
  if ((threadIdx.x & 31) == 0 && pk > 0.0f)
    atomicMax(peak_bits, __float_as_uint(pk));
}

// Pass 3: inverse column FFTs, valid-position write-out, fused peak; one
// CTA an item (column tile blockIdx.x of pair blockIdx.y).
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
  cols_inverse_load<T, S, A::kArith, A::kStrided, A::kTw4>(
      v, tab + F::kTableElems + w, F::kGlobalTw ? w1 : tab,
      scratch + (size_t)blockIdx.y * S::kB, tw4, c0, t, w);

  IO* yc = y + ch * g.out_len;
  const long long base0 = 2 * k * g.hop - g.m;  // out index of position n
  const float pk = cols_inverse_scatter<T, IO, S, A>(v, yc, base0, g, c0, t, w);
  peak_max<C::kThreads>(pk, peak_bits);
}

// Pass 2's items: item = local pair * kTiles + row tile, kTiles tiles of
// kR rows a pair. An item's kR rows are one contiguous run of the scratch
// (kR * N2 values), so item it sits at scratch + it * kStageElems.
//
// Where Rows aims at one CTA an SM (kMinBlocks == 1: f64 from 512-point
// rows, f32 and i16 at 8192), rows_multiply's CTA loaded its 8 rows,
// transformed them and stored them with nothing beside it on the SM, so the
// pass moved its bytes at about the copy rate and its arithmetic came on
// top (PERF.md). There the pass is persistent: CTA b of G (the CTAs the
// card holds at once) walks items b, b + G, b + 2G, ..., builds its twiddle
// tables once, and brings each item's rows into a ring of kDepth
// shared-memory stages kDepth - 1 items ahead of the one it transforms.
// Thread 0 fills a stage with one 1-D bulk copy (tma.cuh) that completes on
// the stage's mbarrier; the threads read their registers from it at
// pos<0>(t, m), as rows_multiply reads the scratch, and the stage then is
// the item's exchange tile; the result is stored from the registers in
// place. A stage is refilled at the start of the item after the one that
// used it, past a barrier that follows every thread's last exchange, each
// thread's exchange writes fenced from the bulk copy's (async proxy) ones.
//
// An item is the rows of kRingThreads = 128 threads (2 at 512 points), so
// four CTAs share an SM at the same register cap and overlap one another's
// phases besides their own loads, and their shared memory (4 x 40 KB at
// 512 points) leaves the L1 through which the H loads reuse their lines.
// At 2^18 (H100, PERF.md): rows_multiply 4.14-4.25 us a pair; a ring of
// 8-row items, one CTA an SM, 4.12-4.18, and 5.4-6.5 with 200 KB of shared
// memory; 4 rows, two CTAs, 3.69-3.73; 2 rows, four CTAs, 3.56-3.58; 1
// row, eight CTAs, 4.37-4.39. kDepth is what a CTA's share of the SM holds
// beside its tables, at most 2; 1 is the same loop, unpipelined (f64 at
// 8192-point rows), and 0 where Rows aims at two or more CTAs an SM (f32
// and i16 at 2^18): there rows_multiply runs as it is, one CTA an item.
template <typename T, class S>
struct Pass2 {
  using RW = Rows<T, S>;
  using F = typename RW::F;
  // Rows an item: those of kRingThreads threads (at least 1, at most
  // rows_multiply's kR), so several CTAs share an SM; the CTAs an SM holds
  // as min_blocks gives them, each kCtaBudget of shared memory.
  static constexpr int kRingThreads = 128;
  static constexpr int kR = cclamp(kRingThreads / F::kNT, 1, RW::kR);
  static constexpr int kThreads = kR * F::kNT;
  static constexpr int kMinBlocks = min_blocks(kThreads, sizeof(T) == 8);
  static constexpr int kTiles = S::kN1 / kR;
  static constexpr int kStageElems = kR * F::kL;
  static constexpr size_t kStageBytes = sizeof(Cx<T>) * (size_t)kStageElems;
  static_assert(kStageBytes % 16 == 0 && kStageBytes < (1u << 20),
                "a stage is one bulk copy");
  // The stages after the tables (16-byte aligned for the bulk copies), then
  // one mbarrier a stage.
  static constexpr size_t kRingOff =
      (sizeof(Cx<T>) * (size_t)F::kTableElems + 15) & ~(size_t)15;
  static constexpr size_t kBarBytes = 16;
  static constexpr size_t kCtaBudget =
      kMinBlocks > 1 ? kSmSmem / kMinBlocks - kCtaReserved : kCtaSmemMax;
  static constexpr int kDepth =
      RW::kMinBlocks > 1
          ? 0
          : cclamp((int)((kCtaBudget - kRingOff - kBarBytes) / kStageBytes),
                   0, 2);
  static constexpr size_t kBarOff = kRingOff + (size_t)kDepth * kStageBytes;
  static constexpr size_t kSmem = kDepth ? kBarOff + kBarBytes : RW::kSmem;
  static constexpr int kLaunchThreads = kDepth ? kThreads : RW::kThreads;
  static_assert(kDepth == 0 || kSmem <= kCtaBudget,
                "the ring must fit its CTAs an SM");

  // Start the copy of item `it`'s rows into stage st (thread 0).
  __device__ static __forceinline__ void load(Cx<T>* st, const Cx<T>* scratch,
                                              long long it, Bar* bar) {
    mbar_expect_tx(bar, (unsigned)kStageBytes);
    bulk_load(st, scratch + it * kStageElems, (unsigned)kStageBytes, bar);
  }
};

// Pass 2 through the ring (Pass2, kDepth > 0): the chunk's `items` (pair,
// row tile) items, each FFT, times H, inverse FFT, in place. Grid:
// pass_grid.
template <typename T, class S, int kRows = kRowsFull>
__global__ void
__launch_bounds__(Pass2<T, S>::kThreads, Pass2<T, S>::kMinBlocks)
rows_multiply_ring(Cx<T>* __restrict__ scratch, const Cx<T>* __restrict__ H,
                   const Cx<T>* __restrict__ w2, long long items) {
  using P = Pass2<T, S>;
  using F = typename P::F;
  constexpr int kD = P::kDepth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* ring = reinterpret_cast<Cx<T>*>(smem_raw + P::kRingOff);
  Bar* bar = reinterpret_cast<Bar*>(smem_raw + P::kBarOff);
  const int tid = threadIdx.x;
  const int t = tid & (F::kNT - 1), r = tid >> F::kLogNT;
  const Cx<T>* tw = F::kGlobalTw ? w2 : tab;
  const long long step = gridDim.x;
  // The first kD - 1 items' copies go out before the tables are built,
  // which happens once a CTA.
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < kD; ++d) mbar_init(&bar[d], 1);
    mbar_init_fence();
#pragma unroll
    for (int d = 0; d < kD - 1; ++d) {
      const long long it = blockIdx.x + d * step;
      if (it < items) P::load(ring + d * P::kStageElems, scratch, it, &bar[d]);
    }
  }
  if constexpr (kRows != kRowsCopy) F::build_table(tab, w2, tid, P::kThreads);
  int stage = 0;
  unsigned phase = 0;
  for (long long it = blockIdx.x; it < items; it += step) {
    // Refill the stage used one item ago (the tables before the first
    // item), then wait for this item's.
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      const long long ahead = it + (kD - 1) * step;
      const int fill = stage == 0 ? kD - 1 : stage - 1;
      if (ahead < items)
        P::load(ring + fill * P::kStageElems, scratch, ahead, &bar[fill]);
    }
    mbar_wait(&bar[stage], phase);
    Cx<T>* s = ring + stage * P::kStageElems + r * F::kL;
    const size_t row = (size_t)(it & (P::kTiles - 1)) * P::kR + r;
    Cx<T> v[F::kE];
#pragma unroll
    for (int m = 0; m < F::kE; ++m) v[m] = s[F::template pos<0>(t, m)];
    rows_transform<T, S, kRows, true>(
        v, s, tw, H, row, scratch + it * P::kStageElems + r * F::kL, t);
    if (++stage == kD) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Pass 3's items, as pass 1's: item = local pair * kTiles + column tile.
//
// Where Cols aims at one CTA an SM (kMinBlocks == 1, the rule of Pass1:
// f64 from 512-point columns), cols_inverse's CTA loaded its tile from the
// scratch, transformed it and stored y with nothing beside it on the SM,
// so the scratch reads (two thirds of the pass's bytes) waited behind the
// transform. There the pass is persistent: the resident CTAs take items
// one at a time from a counter (the chunk's next item, an atomicAdd by
// thread 0 of a CTA), build their twiddle tables once, and bring each
// item's tile into a ring of kDepth shared-memory stages kDepth - 1 items
// ahead of the one they transform. Thread 0 fills a stage with kBoxes
// 2-D tile copies through a tensor map of the chunk's scratch, seen as
// [pairs * N1 rows, 2 * N2 reals] (tma.cuh tile_load: boxes of kBoxRows
// rows of the tile's kW columns), that complete on the stage's mbarrier,
// and notes the stage's item beside the barriers (-1: none left); a stage
// is the tile row-major, element (p, w) at p * kW + w. The threads read
// their registers from it at pos<kFirst>(t, m), where cols_inverse_load
// reads the scratch, take the conjugate twiddle as it does, and the stage
// then is the item's exchange tile. It is refilled at the start of the
// item after the one that used it, past a barrier that follows every
// thread's last exchange, each thread's exchange writes fenced from the
// copies' (async proxy) ones. The y stores, the scale and each column's
// arithmetic are cols_inverse's; a thread keeps one running peak over its
// items, reduced once a CTA.
//
// Why the counter, not Pass2's fixed walk (CTA b takes b, b + G, ...):
// the CTAs run at different speeds, and with a fixed walk the last one
// ends the pass late and neighbouring tiles' y (16 bytes a row at
// 1024-point columns, half a sector) reach the L2 far apart. At (10, 9)
// the fixed walk took 8.3-9.2 us a pair against cols_inverse's 7.4;
// groups of 2-8 neighbouring tiles a CTA 11.5-14.2; the counter 6.24-6.27
// (and 2.29-2.30 against 2.81 at (9, 9); PERF.md). The counter and
// a count of finished CTAs are the two words after the peak's, which the
// caller zeroes; the last CTA to finish zeroes them again for the next
// chunk's launch.
//
// kDepth is what a CTA's shared memory holds beside the tables, at most 2
// (two 64 KB stages and the tables at 512- and 1024-point columns, the
// shared bytes of pass 1's ring; 1 at 8192-point columns in f64: the same
// loop, unpipelined); 0 where Cols aims at two or more CTAs an SM (f32 and
// i16; f64 below 512-point columns) or a tile's row is not a multiple of
// 16 bytes, which a box's rows must be (f32 at 8192-point columns, one
// column a tile): there cols_inverse runs as it is, one CTA an item.
template <typename T, typename IO, class S>
struct Pass3 {
  using C = Cols<T, S>;
  using F = typename C::F;
  static constexpr int kTiles = S::kN2 / C::kW, kLogTiles = ilog2(kTiles);
  static constexpr int kStageElems = C::kW * F::kL;  // the exchange tile
  static constexpr size_t kStageBytes = sizeof(Cx<T>) * (size_t)kStageElems;
  static constexpr size_t kRowBytes = sizeof(Cx<T>) * (size_t)C::kW;
  static constexpr int kBoxRows = cmin(256, F::kL);  // TMA's box limit
  static constexpr int kBoxes = F::kL / kBoxRows;
  // The stages first (128-byte aligned for the tile copies), then the
  // tables, then one mbarrier and one item a stage (at most 2 each).
  static constexpr size_t kTableBytes = sizeof(Cx<T>) * (size_t)F::kTableElems;
  static constexpr size_t kBarBytes = 32;
  static constexpr int kDepth =
      C::kMinBlocks > 1 || kRowBytes % 16
          ? 0
          : cclamp((int)((kCtaSmemMax - kTableBytes - kBarBytes) / kStageBytes),
                   1, 2);
  static constexpr size_t kTabOff = (size_t)kDepth * kStageBytes;
  static constexpr size_t kBarOff = kTabOff + kTableBytes;
  static constexpr size_t kSmem = kDepth ? kBarOff + kBarBytes : C::kSmem;
  static_assert(kDepth == 0 || (kSmem <= kCtaSmemMax && kBarOff % 8 == 0 &&
                                kStageBytes < (1u << 20)),
                "the ring must fit a CTA; a stage is one expect_tx");

  // The next item from the chunk's counter, or -1 past the last (thread 0).
  __device__ static __forceinline__ long long take(unsigned int* next,
                                                   long long items) {
    const long long it = atomicAdd(next, 1u);
    return it < items ? it : -1;
  }

  // Start the copies of item `it`'s tile into stage st (thread 0): the
  // boxes through the map, or with kStrided off (the tile one contiguous
  // run of the scratch) one 1-D bulk copy.
  template <bool kStrided>
  __device__ static __forceinline__ void load(Cx<T>* st, const CUtensorMap* map,
                                              const Cx<T>* scratch, long long it,
                                              Bar* bar) {
    const long long pl = it >> kLogTiles;
    const int c0 = (int)(it & (kTiles - 1)) * C::kW;
    mbar_expect_tx(bar, (unsigned)kStageBytes);
    if constexpr (kStrided) {
#pragma unroll
      for (int h = 0; h < kBoxes; ++h)
        tile_load(st + h * kBoxRows * C::kW, map, 2 * c0,
                  (int)(pl * F::kL) + h * kBoxRows, bar);
    } else {
      bulk_load(st, scratch + pl * S::kB + (size_t)c0 * S::kN1,
                (unsigned)kStageBytes, bar);
    }
  }
};

// Pass 3 through the ring (Pass3, kDepth > 0): the chunk's `items` (pair,
// column tile) items, each times the conjugate twiddle, inverse column
// FFT, write-out and peak as cols_inverse. smap: the chunk's scratch as
// Pass3 tiles it (scratch itself is read only with kStrided off);
// peak_bits[1], [2]: the item counter and the finished CTAs, zero at the
// start and left zero at the end. Grid: pass_grid.
template <typename T, typename IO, class S, class A = Shipped>
__global__ void __launch_bounds__(Cols<T, S>::kThreads, Cols<T, S>::kMinBlocks)
cols_inverse_ring(const __grid_constant__ CUtensorMap smap,
                  const Cx<T>* __restrict__ scratch, IO* __restrict__ y,
                  unsigned int* __restrict__ peak_bits,
                  const Cx<T>* __restrict__ tw4, const Cx<T>* __restrict__ w1,
                  Geometry g, long long items) {
  using C = Cols<T, S>;
  using F = typename C::F;
  using P = Pass3<T, IO, S>;
  constexpr int kD = P::kDepth;
  constexpr int kFirst = A::kArith ? F::kStages - 1 : 0;
  constexpr bool kFactored = A::kArith && A::kTw4 && Twiddle<T, S>::kFactored;
  // The dynamic shared memory, as every kernel's smem_raw, named apart for
  // the tile copies' 128-byte alignment.
  extern __shared__ __align__(128) unsigned char ring_raw[];
  Cx<T>* ring = reinterpret_cast<Cx<T>*>(ring_raw);
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(ring_raw + P::kTabOff);
  Bar* bar = reinterpret_cast<Bar*>(ring_raw + P::kBarOff);
  long long* held = reinterpret_cast<long long*>(bar + 2);  // a stage's item
  unsigned int* next = peak_bits + 1;
  const int tid = threadIdx.x, w = tid & (C::kW - 1), t = tid >> C::kLogW;
  const Cx<T>* tw = F::kGlobalTw ? w1 : tab;
  // The first kD - 1 items' copies go out before the tables are built,
  // which happens once a CTA.
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < kD; ++d) mbar_init(&bar[d], 1);
    mbar_init_fence();
#pragma unroll
    for (int d = 0; d < kD - 1; ++d) {
      held[d] = P::take(next, items);
      if (held[d] >= 0)
        P::template load<A::kStrided>(ring + d * P::kStageElems, &smap, scratch,
                                      held[d], &bar[d]);
    }
  }
  if constexpr (A::kArith) F::build_table(tab, w1, tid, C::kThreads);
  float pk = 0.0f;
  int stage = 0;
  unsigned phase = 0;
  for (;;) {
    // Take and start the next item into the stage used one item ago (the
    // tables before the first item), then wait for this item's.
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      const int fill = stage == 0 ? kD - 1 : stage - 1;
      held[fill] = P::take(next, items);
      if (held[fill] >= 0)
        P::template load<A::kStrided>(ring + fill * P::kStageElems, &smap,
                                      scratch, held[fill], &bar[fill]);
    }
    // With one stage the item just taken is this one.
    if constexpr (kD == 1) __syncthreads();
    const long long it = held[stage];
    if (it < 0) break;  // and so is every later take
    const long long p = g.pair0 + (it >> P::kLogTiles);
    const long long ch = p / g.pairs_per_ch, k = p % g.pairs_per_ch;
    const int c0 = (int)(it & (P::kTiles - 1)) * C::kW;
    Cx<T>* s = ring + stage * P::kStageElems + w;
    // Register m's conjugate twiddle first, so its loads run while the
    // stage lands; then its value from the stage, times that twiddle.
    Cx<T> v[F::kE];
    [[maybe_unused]] const ColTwiddle<T, S, kFactored> ft(tw4, t, c0 + w);
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      const int q = F::template pos<kFirst>(t, m);
      if constexpr (kFactored) {
        v[m] = ft(m);
      } else if constexpr (A::kArith && A::kTw4) {
        v[m] = tw4[(size_t)q * S::kN2 + c0 + w];
      } else if constexpr (A::kArith) {
        v[m] = opaque_unit<T>(tw4);
      }
    }
    mbar_wait(&bar[stage], phase);
#pragma unroll
    for (int m = 0; m < F::kE; ++m) {
      const Cx<T> a = s[F::template pos<kFirst>(t, m) * C::kW];
      if constexpr (A::kArith) {
        v[m] = cmulc(a, v[m]);
      } else {
        v[m] = a;
      }
    }
    if constexpr (A::kArith) {
      __syncthreads();  // every thread's reads of the stage (the tables too)
      F::template inverse<C::kW, false>(v, s, tw, t);
    }
    pk = fmaxf(pk, cols_inverse_scatter<T, IO, S, A>(
                       v, y + ch * g.out_len, 2 * k * g.hop - g.m, g, c0, t, w));
    if (++stage == kD) {
      stage = 0;
      phase ^= 1;
    }
  }
  peak_max<C::kThreads>(pk, peak_bits);
  // Every CTA has taken its last item; the last to get here zeroes the
  // counters for the next launch.
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(peak_bits + 2, 1u) == gridDim.x - 1) {
      next[0] = 0;
      peak_bits[2] = 0;
    }
  }
}

// CTAs of a persistent pass the card holds at once (tma.cuh resident_ctas;
// at least 1); asked once a process for each instantiation, after its
// shared-memory limit is raised.
template <typename T, typename IO, class S, class A>
int pass1_resident() {
  static const int n = [] {
    int ctas = 0;
    resident_ctas(cols_forward<T, IO, S, A>, Cols<T, S>::kThreads,
                  Pass1<T, IO, S>::kSmem, &ctas);
    return ctas > 0 ? ctas : 1;
  }();
  return n;
}
template <typename T, class S, int kRows>
int pass2_resident() {
  static const int n = [] {
    int ctas = 0;
    resident_ctas(rows_multiply_ring<T, S, kRows>, Pass2<T, S>::kThreads,
                  Pass2<T, S>::kSmem, &ctas);
    return ctas > 0 ? ctas : 1;
  }();
  return n;
}
template <typename T, typename IO, class S, class A>
int pass3_resident() {
  static const int n = [] {
    int ctas = 0;
    resident_ctas(cols_inverse_ring<T, IO, S, A>, Cols<T, S>::kThreads,
                  Pass3<T, IO, S>::kSmem, &ctas);
    return ctas > 0 ? ctas : 1;
  }();
  return n;
}

// A persistent pass's grid for `items` items: the resident CTAs, or one an
// item where there are fewer items.
inline dim3 pass_grid(long long items, long long res) {
  return dim3((unsigned)(items < res ? items : res));
}

// Pass 1's grid for a chunk of np pairs: without a ring one CTA an item
// (tiles x pairs), else pass_grid.
template <typename T, typename IO, class S, class A>
dim3 pass1_grid(long long np) {
  using P = Pass1<T, IO, S>;
  if (P::kDepth == 0) return dim3(P::kTiles, (unsigned)np);
  return pass_grid(np * P::kTiles, pass1_resident<T, IO, S, A>());
}

// Pass 2's kernel and its shared bytes: rows_multiply without a ring,
// else rows_multiply_ring (only the one that runs is instantiated).
template <typename T, class S, int kRows>
SmemLimit pass2_kernel() {
  if constexpr (Pass2<T, S>::kDepth == 0) {
    return {rows_multiply<T, S, kRows>, Rows<T, S>::kSmem};
  } else {
    return {rows_multiply_ring<T, S, kRows>, Pass2<T, S>::kSmem};
  }
}

// Pass 2 on a chunk of np pairs: rows_multiply with one CTA an item (tiles
// x pairs), or rows_multiply_ring on pass_grid.
template <typename T, class S, int kRows>
void pass2_launch(Cx<T>* sc, const Cx<T>* H, const Cx<T>* w2, long long np,
                  cudaStream_t stream) {
  using P = Pass2<T, S>;
  constexpr int kThreads = P::kLaunchThreads;
  if constexpr (P::kDepth == 0) {
    rows_multiply<T, S, kRows>
        <<<dim3(S::kN1 / Rows<T, S>::kR, (unsigned)np), kThreads, P::kSmem, stream>>>(
            sc, H, w2);
  } else {
    const long long items = np * P::kTiles;
    rows_multiply_ring<T, S, kRows>
        <<<pass_grid(items, pass2_resident<T, S, kRows>()), kThreads, P::kSmem,
           stream>>>(sc, H, w2, items);
  }
}

// Pass 3's kernel and its shared bytes: cols_inverse without a ring, else
// cols_inverse_ring (only the one that runs is instantiated).
template <typename T, typename IO, class S, class A>
SmemLimit pass3_kernel() {
  if constexpr (Pass3<T, IO, S>::kDepth == 0) {
    return {cols_inverse<T, IO, S, A>, Cols<T, S>::kSmem};
  } else {
    return {cols_inverse_ring<T, IO, S, A>, Pass3<T, IO, S>::kSmem};
  }
}

// Pass 3 on a chunk of np pairs: cols_inverse with one CTA an item (tiles
// x pairs), or cols_inverse_ring on pass_grid through smap.
template <typename T, typename IO, class S, class A>
void pass3_launch(const CUtensorMap& smap, const Cx<T>* sc, IO* y,
                  unsigned int* pk, const Cx<T>* tw4, const Cx<T>* w1,
                  const Geometry& g, long long np, cudaStream_t stream) {
  using P = Pass3<T, IO, S>;
  constexpr int kThreads = Cols<T, S>::kThreads;
  if constexpr (P::kDepth == 0) {
    cols_inverse<T, IO, S, A>
        <<<dim3(P::kTiles, (unsigned)np), kThreads, P::kSmem, stream>>>(
            sc, y, pk, tw4, w1, g);
  } else {
    const long long items = np * P::kTiles;
    cols_inverse_ring<T, IO, S, A>
        <<<pass_grid(items, pass3_resident<T, IO, S, A>()), kThreads, P::kSmem,
           stream>>>(smap, sc, y, pk, tw4, w1, g, items);
  }
}

// The tensor map pass 3's ring reads the scratch through: its chunk_pairs
// pairs as [chunk_pairs * N1 rows, 2 * N2 reals], in boxes of Pass3's
// kBoxRows rows of one tile's 2 * kW reals. Encoded for each call (the
// scratch is allocated for each); nothing without a ring, or with the
// tile one contiguous run (kStrided off).
template <typename T, typename IO, class S, class A>
cudaError_t pass3_map(CUtensorMap* smap, const Cx<T>* sc, long long chunk_pairs) {
  using P = Pass3<T, IO, S>;
  if constexpr (P::kDepth == 0 || !A::kStrided) {
    return cudaSuccess;
  } else {
    return tile_map<T>(smap, sc, (unsigned long long)chunk_pairs * S::kN1,
                       2ull * S::kN2, P::kBoxRows, 2 * Cols<T, S>::kW);
  }
}

// The three passes over `total` pairs, chunk_pairs at a time through the
// scratch.
template <typename T, typename IO, class S, class A = Shipped>
int run_split(const IO* x, IO* y, unsigned int* pk, const Cx<T>* H,
              const Cx<T>* tw4, const Cx<T>* w1, const Cx<T>* w2, Cx<T>* sc,
              Geometry g, long long total, long long chunk_pairs,
              cudaStream_t stream) {
  using P = Pass1<T, IO, S>;
  cudaError_t err = allow_smem({{cols_forward<T, IO, S, A>, P::kSmem},
                                pass2_kernel<T, S, A::kRows>(),
                                pass3_kernel<T, IO, S, A>()});
  CUtensorMap smap{};
  if (err == cudaSuccess) err = pass3_map<T, IO, S, A>(&smap, sc, chunk_pairs);
  if (err != cudaSuccess) return err;
  for (long long p0 = 0; p0 < total; p0 += chunk_pairs) {
    const long long np = (total - p0) < chunk_pairs ? (total - p0) : chunk_pairs;
    g.pair0 = p0;
    cols_forward<T, IO, S, A>
        <<<pass1_grid<T, IO, S, A>(np), Cols<T, S>::kThreads, P::kSmem, stream>>>(
            x, sc, tw4, w1, g, np * P::kTiles);
    pass2_launch<T, S, A::kRows>(sc, H, w2, np, stream);
    pass3_launch<T, IO, S, A>(smap, sc, y, pk, tw4, w1, g, np, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Pass 1 at one split: occupancy()'s five numbers, then the ring's depth
// (0: none), the column tiles a pair and the resident CTAs (with a ring,
// the grid of a chunk with at least that many items).
template <typename T, typename IO, class S>
int pass1_occupancy(int* out) {
  using P = Pass1<T, IO, S>;
  cudaError_t err = allow_smem({{cols_forward<T, IO, S, Shipped>, P::kSmem}});
  if (err == cudaSuccess)
    err = occupancy(cols_forward<T, IO, S, Shipped>, Cols<T, S>::kThreads,
                    P::kSmem, out);
  out[5] = P::kDepth;
  out[6] = P::kTiles;
  out[7] = pass1_resident<T, IO, S, Shipped>();
  return err;
}

// Pass 2 at one split: occupancy()'s five numbers of the kernel that runs,
// then the ring's depth (0: none, rows_multiply), the row tiles a pair and
// the resident CTAs (0 without a ring).
template <typename T, class S>
int pass2_occupancy(int* out) {
  using P = Pass2<T, S>;
  const SmemLimit k = pass2_kernel<T, S, kRowsFull>();
  cudaError_t err = allow_smem({k});
  if (err == cudaSuccess)
    err = occupancy(k.kernel, P::kLaunchThreads, k.bytes, out);
  out[5] = P::kDepth;
  out[6] = P::kDepth ? P::kTiles : S::kN1 / Rows<T, S>::kR;
  if constexpr (P::kDepth > 0) {
    out[7] = pass2_resident<T, S, kRowsFull>();
  } else {
    out[7] = 0;
  }
  return err;
}

// Pass 3 at one split: occupancy()'s five numbers of the kernel that runs,
// then the ring's depth (0: none, cols_inverse), the column tiles a pair
// and the resident CTAs (0 without a ring).
template <typename T, typename IO, class S>
int pass3_occupancy(int* out) {
  using P = Pass3<T, IO, S>;
  const SmemLimit k = pass3_kernel<T, IO, S, Shipped>();
  cudaError_t err = allow_smem({k});
  if (err == cudaSuccess)
    err = occupancy(k.kernel, Cols<T, S>::kThreads, k.bytes, out);
  out[5] = P::kDepth;
  out[6] = P::kTiles;
  if constexpr (P::kDepth > 0) {
    out[7] = pass3_resident<T, IO, S, Shipped>();
  } else {
    out[7] = 0;
  }
  return err;
}

}  // namespace
