// FFT-stage primitive probes on Hopper (sm_90a), float32 and float64.
//
// Replaces the TPU probes experiments/mosaic_stages.py pallas_block_op
// (pallas_call at :92) and experiments/mosaic_stages2.py pallas_block_op
// (pallas_call at :76): single FFT stages and stage chains on resident
// [512, 512] blocks. A [512, 512] complex128 block is 4 MB against the
// 227 KB of shared memory a CTA may use, so here a CTA holds a tile of
// kW = 16 of the 512 independent length-512 transforms of one block (the
// layout of fft_dif below: element (pos, w) at s[pos * kW + w]),
// loads it, runs the case, and stores it. The transforms run along axis 1
// of z [batch, 512, 512] (the TPU's sublane axis); axis 2 is the batch of
// transforms. Cases (z -> out):
//   noop       load and store the tile;
//   r2, r4     one radix-2 / radix-4 DIF stage at block length d (param),
//              the stage of fft_core.dif_stage;
//   fwd_r2     the 512-point DIF chain as the kernels shipped it before
//              their register redesign (fft_dif below: nine radix-2
//              sweeps over the shared tile), the baseline of the chains;
//   fwd_r4     fft_core.dif_plan(512): r2 at d = 256, r4 at 64, 16, 4, 1;
//   fwd_r8     fft_core.dif_plan_r8(512): r8 at d = 64, 8, 1;
//   inv_r2/r4/r8  the DIT inverse chains (ifft_dit / dit_stage), * 1/512;
//   fwd_inv    fft_dif then ifft_dit (the radix-2 sweeps), * 1/512;
//   fwd_reg    the shipped 512-point forward FFT (fourstep.cuh Fft<T, 9>:
//              8 registers per thread, 3 radix-8 stages, 2 swizzled
//              exchanges), 8 transforms per CTA, loaded from and stored to
//              device memory straight from the registers; output as fwd_r2;
//   shuffle    the roll stage of mosaic_stages.py roll_r2_stage at
//              distance e = param < 32 along the transform axis, as an
//              in-warp exchange (__shfl_xor_sync): lanes hold consecutive
//              positions, y = x + x[i ^ e] on (i & e) == 0, else
//              (x[i ^ e] - x) * exp(-2 pi i v / 64) for column v;
//   transpose  out[b] = z[b]^T through param x param shared tiles (32, 64);
//   cmul       out = z * table, table [512, 512] resident in device memory;
//   fwd_ring   the row's function done the Hopper way (ring_chain below):
//              the 512-point forward DFT along axis 1 in fwd_r2's order
//              (bit-reversed);
//   fwd_ring_r8  the same in fwd_r8's order (base-8 digit-reversed).
// Stage twiddles come from `table` = exp(-2 pi i k / 512), k < 512,
// computed in float64 on the host. What bounds each case is what the
// probe measures; nothing here is on the program's path.
//
// The chain for Hopper (ring_chain; the kernels line's probe_stages and
// probe_stages2 rows, which replace the TPU probes' chains,
// experiments/mosaic_stages.py:65 `fwd r2` and mosaic_stages2.py:50
// `fwd r8`). What bounds it: bytes. One read and one write of the
// blocks, 2 x 8 MB (f32) / 16 MB (f64) at [8, 512, 512], is 0.0100 /
// 0.0200 ms at 3.35 TB/s; the arithmetic, 5 N log2 N flops a transform,
// 94 Mflop at batch 8, is 1.4 us at 67 TFLOP/s. The sweeps above
// (stage_tile) run each stage as a barrier-separated pass over a shared
// tile and load and store it with the threads, one tile a CTA, so inside
// a CTA copies and arithmetic never overlap. The design:
//   - A persistent grid: one CTA a SM (its 200 KB ring leaves room for no
//     second) walks the work items, (block b, columns [v0, v0 + kW)), in
//     the strided order c, c + G, c + 2 G, ..., so a CTA has several slabs
//     to overlap and neighbouring CTAs read neighbouring columns.
//   - A slab is [512, kW], kW = 16 (f32) or 8 (f64): 128 B a row, 64 KB.
//     A ring of 3 slabs in shared memory, one mbarrier each, is fed by
//     bulk copies: while the CTA transforms slab j, slab j + 1 loads and
//     slab j - 1 stores; slab j + 2 then loads into j - 1's stage.
//   - The copies go through 2-D tensor maps: a slab's 512 rows lie 4 / 8
//     KB apart, which the TMA unit walks itself, so a slab is two 256-row
//     boxes (the box limit) each way, two instructions of one thread
//     against one expect_tx of 64 KB. The maps are built by
//     cuTensorMapEncodeTiled through the runtime's entry-point query
//     (tma.cuh) and passed as __grid_constant__. The alternative, 512 1-D
//     copies of 128 B a slab spread over warp 0's lanes, issues 256 times
//     the copy instructions; measured, it ran 4-5x slower (about 31 ns a
//     copy; NVIDIA H100 80GB HBM3 at 700 W, PERF.md) and was dropped.
//   - The stage is the exchange tile: the slab goes from its stage into
//     registers (pos<0>), Fft<T, 9>::forward runs with its two swizzled
//     exchanges through that same stage (fourstep.cuh, unchanged), and the
//     registers go back into the stage in the output order, row-major as
//     the store reads it. Every one of those shared accesses puts a warp's
//     lanes on consecutive 8- or 16-byte elements or on the swizzle the
//     shipped passes use: no bank conflicts. Then every thread fences for
//     the async proxy (fence.proxy.async.shared::cta), a barrier, and
//     thread 0 bulk-stores the slab. A stage is refilled only after
//     cp.async.bulk.wait_group.read says its store has read it. Shared
//     memory holds the ring, the twiddle tables and the barriers.
//   - Measured (same card): at [256, 512, 512], 2.15 GB in f64, the ring
//     moves its bytes at 2.7-2.8 TB/s, 7-11 % behind z.clone() and 2-7 %
//     behind fwd_reg; at [8, 512, 512] it is within a few percent of
//     fwd_reg, at ~60 % of the bound (PERF.md).
//   - The same function, not the same sweeps: both orders run Fft<T, 9>
//     (radix 8 in registers, whose output is bit-reversed) and store DFT
//     bin k at its order's row: the bit-reversed row itself, or for
//     fwd_r8's base-8 digit reversal the row with each octal digit's three
//     bits reversed in place (digitrev8(bitrev9(p))).

#include <cuda_runtime.h>

#include "fourstep.cuh"
#include "tma.cuh"

namespace {

constexpr int kN = 512;
constexpr int kLogN = 9;
constexpr int kW = 16;

enum Case {
  kNoop = 0, kR2 = 1, kR4 = 2, kFwdR2 = 3, kFwdR4 = 4, kFwdR8 = 5,
  kInvR2 = 6, kInvR4 = 7, kInvR8 = 8, kFwdInv = 9, kShuffle = 10,
  kTranspose = 11, kCmul = 12, kFwdReg = 13, kFwdRing = 14, kFwdRingR8 = 15,
};

template <typename T>
__device__ void load_table(Cx<T>* dst, const Cx<T>* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// In-place radix-2 FFTs over a tile of W transforms of length L = 2^logL,
// element (pos, w) at s[pos * W + w]. tw[k] = exp(-2*pi*i*k/L), k < L/2.
// The caller synchronizes before the first stage; every stage ends with a
// barrier. The kernels' FFTs before their register redesign, kept here as
// the chains' baseline.

// Forward, decimation in frequency: natural order in, bit-reversed out.
template <typename T>
__device__ void fft_dif(Cx<T>* s, int W, int logL, const Cx<T>* tw) {
  const int nbf = W << (logL - 1);
  for (int lh = logL - 1; lh >= 0; --lh) {
    const int h = 1 << lh;
    const int tshift = logL - 1 - lh;
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      const int w = t % W;
      const int b = t / W;
      const int j = b & (h - 1);
      const int lo = (((b >> lh) << (lh + 1)) + j) * W + w;
      const int hi = lo + h * W;
      const Cx<T> a = s[lo], c = s[hi];
      s[lo] = cadd(a, c);
      s[hi] = cmul(csub(a, c), tw[j << tshift]);
    }
    __syncthreads();
  }
}

// Inverse (conjugate twiddles, no scaling), decimation in time:
// bit-reversed order in, natural out.
template <typename T>
__device__ void ifft_dit(Cx<T>* s, int W, int logL, const Cx<T>* tw) {
  const int nbf = W << (logL - 1);
  for (int lh = 0; lh < logL; ++lh) {
    const int h = 1 << lh;
    const int tshift = logL - 1 - lh;
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      const int w = t % W;
      const int b = t / W;
      const int j = b & (h - 1);
      const int lo = (((b >> lh) << (lh + 1)) + j) * W + w;
      const int hi = lo + h * W;
      const Cx<T> a = s[lo];
      const Cx<T> c = cmulc(s[hi], tw[j << tshift]);
      s[lo] = cadd(a, c);
      s[hi] = csub(a, c);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ Cx<T> neg_i(Cx<T> a) { return {a.im, -a.re}; }
template <typename T>
__device__ __forceinline__ Cx<T> pos_i(Cx<T> a) { return {-a.im, a.re}; }

template <typename T>
__device__ __forceinline__ T rsqrt2() { return T(0.70710678118654752440); }

// Index of element q of butterfly t in a stage of radix R at block length d.
__device__ __forceinline__ int stage_base(int t, int radix, int d) {
  const int w = t % kW, b = t / kW, j = b % d, g = b / d;
  return (g * radix * d + j) * kW + w;
}

template <typename T>
__device__ void dif_r2(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (2 * d);
  for (int t = threadIdx.x; t < kW * kN / 2; t += blockDim.x) {
    const int j = (t / kW) % d;
    const int i0 = stage_base(t, 2, d), i1 = i0 + d * kW;
    const Cx<T> a = s[i0], b = s[i1];
    s[i0] = cadd(a, b);
    s[i1] = cmul(csub(a, b), rt[j * step]);
  }
  __syncthreads();
}

template <typename T>
__device__ void dit_r2(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (2 * d);
  for (int t = threadIdx.x; t < kW * kN / 2; t += blockDim.x) {
    const int j = (t / kW) % d;
    const int i0 = stage_base(t, 2, d), i1 = i0 + d * kW;
    const Cx<T> a = s[i0], b = cmulc(s[i1], rt[j * step]);
    s[i0] = cadd(a, b);
    s[i1] = csub(a, b);
  }
  __syncthreads();
}

template <typename T>
__device__ void dif_r4(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (4 * d);
  for (int t = threadIdx.x; t < kW * kN / 4; t += blockDim.x) {
    const int j = (t / kW) % d, k = j * step;
    const int i0 = stage_base(t, 4, d), h = d * kW;
    const Cx<T> a = s[i0], b = s[i0 + h], c = s[i0 + 2 * h], e = s[i0 + 3 * h];
    const Cx<T> t0 = cadd(a, c), t1 = csub(a, c), t2 = cadd(b, e);
    const Cx<T> t3 = neg_i(csub(b, e));
    s[i0] = cadd(t0, t2);
    s[i0 + h] = cmul(cadd(t1, t3), rt[k]);
    s[i0 + 2 * h] = cmul(csub(t0, t2), rt[2 * k]);
    s[i0 + 3 * h] = cmul(csub(t1, t3), rt[3 * k]);
  }
  __syncthreads();
}

template <typename T>
__device__ void dit_r4(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (4 * d);
  for (int t = threadIdx.x; t < kW * kN / 4; t += blockDim.x) {
    const int j = (t / kW) % d, k = j * step;
    const int i0 = stage_base(t, 4, d), h = d * kW;
    const Cx<T> u0 = s[i0], u1 = cmulc(s[i0 + h], rt[k]);
    const Cx<T> u2 = cmulc(s[i0 + 2 * h], rt[2 * k]);
    const Cx<T> u3 = cmulc(s[i0 + 3 * h], rt[3 * k]);
    const Cx<T> s0 = cadd(u0, u2), d0 = csub(u0, u2), s1 = cadd(u1, u3);
    const Cx<T> id1 = pos_i(csub(u1, u3));
    s[i0] = cadd(s0, s1);
    s[i0 + h] = cadd(d0, id1);
    s[i0 + 2 * h] = csub(s0, s1);
    s[i0 + 3 * h] = csub(d0, id1);
  }
  __syncthreads();
}

template <typename T>
__device__ void dif_r8(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (8 * d);
  const T r = rsqrt2<T>();
  for (int t = threadIdx.x; t < kW * kN / 8; t += blockDim.x) {
    const int j = (t / kW) % d, k = j * step;
    const int i0 = stage_base(t, 8, d), h = d * kW;
    Cx<T> p[8];
    for (int q = 0; q < 8; ++q) p[q] = s[i0 + q * h];
    Cx<T> b0[4], b1[4];
    for (int q = 0; q < 4; ++q) {
      b0[q] = cadd(p[q], p[q + 4]);
      b1[q] = csub(p[q], p[q + 4]);
    }
    const Cx<T> c0 = cadd(b0[0], b0[2]), c1 = csub(b0[0], b0[2]);
    const Cx<T> c2 = cadd(b0[1], b0[3]), c3 = neg_i(csub(b0[1], b0[3]));
    const Cx<T> d0 = b1[0];
    const Cx<T> d1 = scl(cadd(b1[1], neg_i(b1[1])), r);
    const Cx<T> d2 = neg_i(b1[2]);
    const Cx<T> d3 = scl(csub(neg_i(b1[3]), b1[3]), r);
    const Cx<T> e0 = cadd(d0, d2), e1 = csub(d0, d2), e2 = cadd(d1, d3);
    const Cx<T> e3 = neg_i(csub(d1, d3));
    Cx<T> y[8];
    y[0] = cadd(c0, c2); y[2] = cadd(c1, c3);
    y[4] = csub(c0, c2); y[6] = csub(c1, c3);
    y[1] = cadd(e0, e2); y[3] = cadd(e1, e3);
    y[5] = csub(e0, e2); y[7] = csub(e1, e3);
    s[i0] = y[0];
    for (int q = 1; q < 8; ++q) s[i0 + q * h] = cmul(y[q], rt[q * k]);
  }
  __syncthreads();
}

template <typename T>
__device__ void idft4(const Cx<T>* v, Cx<T>* o) {
  const Cx<T> s0 = cadd(v[0], v[2]), d0 = csub(v[0], v[2]);
  const Cx<T> s1 = cadd(v[1], v[3]), id1 = pos_i(csub(v[1], v[3]));
  o[0] = cadd(s0, s1); o[1] = cadd(d0, id1);
  o[2] = csub(s0, s1); o[3] = csub(d0, id1);
}

template <typename T>
__device__ void dit_r8(Cx<T>* s, int d, const Cx<T>* rt) {
  const int step = kN / (8 * d);
  const T r = rsqrt2<T>();
  for (int t = threadIdx.x; t < kW * kN / 8; t += blockDim.x) {
    const int j = (t / kW) % d, k = j * step;
    const int i0 = stage_base(t, 8, d), h = d * kW;
    Cx<T> u[8];
    u[0] = s[i0];
    for (int q = 1; q < 8; ++q) u[q] = cmulc(s[i0 + q * h], rt[q * k]);
    const Cx<T> ev[4] = {u[0], u[2], u[4], u[6]};
    const Cx<T> od[4] = {u[1], u[3], u[5], u[7]};
    Cx<T> p[4], q4[4];
    idft4(ev, p);
    idft4(od, q4);
    const Cx<T> tq[4] = {
        q4[0], scl(csub(q4[1], neg_i(q4[1])), r), pos_i(q4[2]),
        scl(cadd(q4[3], neg_i(q4[3])), -r)};
    for (int m = 0; m < 4; ++m) {
      s[i0 + m * h] = cadd(p[m], tq[m]);
      s[i0 + (m + 4) * h] = csub(p[m], tq[m]);
    }
  }
  __syncthreads();
}

// The roll stage as an in-warp exchange: lanes hold positions.
template <typename T>
__device__ void shuffle_r2(Cx<T>* s, int e, int v0, const Cx<T>* rt) {
  for (int t = threadIdx.x; t < kW * kN; t += blockDim.x) {
    const int w = t / kN, pos = t % kN;
    const Cx<T> x = s[pos * kW + w];
    const Cx<T> o = {__shfl_xor_sync(0xffffffffu, x.re, e),
                     __shfl_xor_sync(0xffffffffu, x.im, e)};
    s[pos * kW + w] = (pos & e) == 0
        ? cadd(x, o)
        : cmul(csub(o, x), rt[((v0 + w) * (kN / 64)) % kN]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_tile(const Cx<T>* __restrict__ z, Cx<T>* __restrict__ out,
           const Cx<T>* __restrict__ roots, int kcase, int param) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* rt = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* s = rt + kN;
  const int v0 = blockIdx.x * kW;
  const size_t base = (size_t)blockIdx.y * kN * kN;
  load_table(rt, roots, kN);
  for (int i = threadIdx.x; i < kN * kW; i += blockDim.x)
    s[i] = z[base + (size_t)(i / kW) * kN + v0 + i % kW];
  __syncthreads();
  T scale = T(1);
  switch (kcase) {
    case kR2: dif_r2(s, param, rt); break;
    case kR4: dif_r4(s, param, rt); break;
    case kFwdR2: fft_dif(s, kW, kLogN, rt); break;
    case kFwdR4:
      dif_r2(s, 256, rt);
      for (int d = 64; d >= 1; d /= 4) dif_r4(s, d, rt);
      break;
    case kFwdR8:
      for (int d = 64; d >= 1; d /= 8) dif_r8(s, d, rt);
      break;
    case kInvR2:
      ifft_dit(s, kW, kLogN, rt);
      scale = T(1) / kN;
      break;
    case kInvR4:
      for (int d = 1; d <= 64; d *= 4) dit_r4(s, d, rt);
      dit_r2(s, 256, rt);
      scale = T(1) / kN;
      break;
    case kInvR8:
      for (int d = 1; d <= 64; d *= 8) dit_r8(s, d, rt);
      scale = T(1) / kN;
      break;
    case kFwdInv:
      fft_dif(s, kW, kLogN, rt);
      ifft_dit(s, kW, kLogN, rt);
      scale = T(1) / kN;
      break;
    case kShuffle: shuffle_r2(s, param, v0, rt); break;
    default: break;  // kNoop
  }
  for (int i = threadIdx.x; i < kN * kW; i += blockDim.x)
    out[base + (size_t)(i / kW) * kN + v0 + i % kW] = scl(s[i], scale);
}

// The shipped forward FFT along axis 1: CTA (blockIdx.x, blockIdx.y)
// takes transforms (columns) [blockIdx.x * kRegW, +kRegW) of block
// blockIdx.y, thread (t, w) as in the kernels' column passes.
constexpr int kRegW = 8;

template <typename T>
__global__ void __launch_bounds__(Cols<T, Split<kLogN, kLogN>>::kThreads)
reg_chain(const Cx<T>* __restrict__ z, Cx<T>* __restrict__ out,
          const Cx<T>* __restrict__ roots) {
  using F = Fft<T, kLogN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int tid = threadIdx.x, w = tid & (kRegW - 1), t = tid >> 3;
  const size_t base = (size_t)blockIdx.y * kN * kN + blockIdx.x * kRegW + w;
  F::build_table(tab, roots, tid, kRegW * F::kNT);
  Cx<T> v[F::kE];
#pragma unroll
  for (int m = 0; m < F::kE; ++m)
    v[m] = z[base + (size_t)F::template pos<0>(t, m) * kN];
  __syncthreads();
  F::template forward<kRegW, false>(v, tab + F::kTableElems + w, tab, t);
#pragma unroll
  for (int m = 0; m < F::kE; ++m)
    out[base + (size_t)F::template pos<F::kStages - 1>(t, m) * kN] = v[m];
}

// ------------------------------------------------- the chain for Hopper

constexpr int kRingStages = 3;  // slabs a CTA holds: one in work, two loading
constexpr int kBoxRows = 256;   // a tensor-map box's rows (TMA's limit)
constexpr int kOrderR2 = 0, kOrderR8 = 1;  // fwd_r2's or fwd_r8's output order

template <typename T>
struct Ring {
  using F = Fft<T, kLogN>;
  static constexpr int kW = 128 / (int)sizeof(Cx<T>);  // transforms a slab
  static constexpr int kLogW = ilog2(kW);
  static constexpr int kThreads = kW * F::kNT;  // 1024 (f32), 512 (f64)
  static constexpr int kSlabElems = kN * kW;
  static constexpr unsigned kRowBytes = kW * sizeof(Cx<T>);
  static constexpr unsigned kSlabBytes = kN * kRowBytes;  // 64 KB
  static constexpr int kSlabs = kN / kW;  // slabs a block
  static constexpr size_t kSmem = kRingStages * (size_t)kSlabBytes +
                                  F::kTableElems * sizeof(Cx<T>) +
                                  kRingStages * sizeof(Bar);
  static_assert(kRowBytes == 128 && kSlabBytes < (1u << 20), "expect_tx");
  static_assert(F::kTableElems * sizeof(Cx<T>) % sizeof(Bar) == 0, "alignment");
  static_assert(kSmem <= 232448, "a CTA's shared memory");
};

// The output row of the register that holds row p after Fft<T, 9>::forward
// (DFT bin bitrev9(p)).
template <int kOrder>
__device__ __forceinline__ int out_row(int p) {
  if constexpr (kOrder == kOrderR2) {
    return p;
  } else {
    return (brev(p >> 6, 3) << 6) | (brev((p >> 3) & 7, 3) << 3) |
           brev(p & 7, 3);
  }
}

// CTA c of G transforms items c, c + G, c + 2 G, ... of the batch x
// kSlabs items, item i being columns [(i % kSlabs) kW, + kW) of block
// i / kSlabs. Thread (t, w) = threadIdx.x >> kLogW, & (kW - 1) holds
// transform w's registers; thread 0 issues the copies.
template <typename T, int kOrder>
__global__ void __launch_bounds__(Ring<T>::kThreads, 1)
ring_chain(const __grid_constant__ CUtensorMap zmap,
           const __grid_constant__ CUtensorMap omap,
           const Cx<T>* __restrict__ roots, int items) {
  using R = Ring<T>;
  using F = typename R::F;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The ring, the twiddle tables, the barriers (each aligned for its type).
  Cx<T>* ring = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* tab = ring + kRingStages * R::kSlabElems;
  Bar* full = reinterpret_cast<Bar*>(tab + F::kTableElems);
  const int tid = threadIdx.x;
  const int w = tid & (R::kW - 1), t = tid >> R::kLogW;
  const bool issuer = tid == 0;
  const CUtensorMap* zm = &zmap;
  const CUtensorMap* om = &omap;
  const int n = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  auto slot = [&](int j) { return ring + (j % kRingStages) * R::kSlabElems; };
  // Item j of this CTA: its first row of z viewed as [batch * 512, 512],
  // and its first column.
  auto row0 = [&](int j) {
    return (size_t)((blockIdx.x + j * gridDim.x) / R::kSlabs) * kN;
  };
  auto col0 = [&](int j) {
    return (int)((blockIdx.x + j * gridDim.x) % R::kSlabs) * R::kW;
  };
  auto load = [&](int j) {
    Bar* bar = &full[j % kRingStages];
    Cx<T>* dst = slot(j);
    mbar_expect_tx(bar, R::kSlabBytes);
    for (int h = 0; h < kN / kBoxRows; ++h)
      tile_load(dst + h * kBoxRows * R::kW, zm, 2 * col0(j),
                (int)row0(j) + h * kBoxRows, bar);
  };
  auto store = [&](int j) {
    const Cx<T>* src = slot(j);
    for (int h = 0; h < kN / kBoxRows; ++h)
      tile_store(om, 2 * col0(j), (int)row0(j) + h * kBoxRows,
                 src + h * kBoxRows * R::kW);
    bulk_commit();
  };

  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (issuer)
    for (int j = 0; j < kRingStages && j < n; ++j) load(j);
  F::build_table(tab, roots, tid, R::kThreads);
  __syncthreads();  // the twiddle tables
  for (int j = 0; j < n; ++j) {
    Cx<T>* s = slot(j);
    mbar_wait(&full[j % kRingStages], (j / kRingStages) & 1);
    Cx<T> v[F::kE];
#pragma unroll
    for (int m = 0; m < F::kE; ++m)
      v[m] = s[F::template pos<0>(t, m) * R::kW + w];
    // kLead: every thread has read the slab before the first exchange
    // writes over it.
    F::template forward<R::kW, true>(v, s + w, tab, t);
    __syncthreads();  // the last exchange's reads
#pragma unroll
    for (int m = 0; m < F::kE; ++m)
      s[out_row<kOrder>(F::template pos<F::kStages - 1>(t, m)) * R::kW + w] =
          v[m];
    fence_async_shared();
    __syncthreads();
    if (issuer) {
      store(j);
      // Slab j - 1 + kRingStages goes into slab j - 1's stage once that
      // store (one group back) has read it.
      if (j >= 1 && j - 1 + kRingStages < n) {
        bulk_wait_read<1>();
        load(j - 1 + kRingStages);
      }
    }
  }
  if (issuer) bulk_wait_read<0>();
}

template <typename T, int kOrder>
int launch_ring(const Cx<T>* z, Cx<T>* out, const Cx<T>* roots,
                long long batch, cudaStream_t st) {
  using R = Ring<T>;
  auto kernel = ring_chain<T, kOrder>;
  CUtensorMap zmap{}, omap{};
  // z and out as [batch * 512, 1024] real scalars; a box is 256 rows of
  // one slab's 2 kW scalars (128 B).
  cudaError_t err =
      tile_map<T>(&zmap, z, batch * kN, 2 * kN, kBoxRows, 2 * R::kW);
  if (err == cudaSuccess)
    err = tile_map<T>(&omap, out, batch * kN, 2 * kN, kBoxRows, 2 * R::kW);
  int ctas = 0;
  if (err == cudaSuccess) err = allow_smem({{kernel, R::kSmem}});
  if (err == cudaSuccess)
    err = resident_ctas(kernel, R::kThreads, R::kSmem, &ctas);
  if (err != cudaSuccess) return err;
  const long long items = batch * R::kSlabs;
  if (ctas > items) ctas = (int)items;
  kernel<<<ctas, R::kThreads, R::kSmem, st>>>(zmap, omap, roots, (int)items);
  return cudaGetLastError();
}

// out[b] = z[b]^T through kT x kT tiles (padded against bank conflicts).
template <typename T, int kT>
__global__ void __launch_bounds__(kThreads)
transpose(const Cx<T>* __restrict__ z, Cx<T>* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tile = reinterpret_cast<Cx<T>*>(smem_raw);
  const size_t base = (size_t)blockIdx.z * kN * kN;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  for (int i = threadIdx.x; i < kT * kT; i += blockDim.x) {
    const int r = i / kT, c = i % kT;
    tile[r * (kT + 1) + c] = z[base + (size_t)(r0 + r) * kN + c0 + c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kT; i += blockDim.x) {
    const int r = i / kT, c = i % kT;
    out[base + (size_t)(c0 + r) * kN + r0 + c] = tile[c * (kT + 1) + r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cmul_table(const Cx<T>* __restrict__ z, Cx<T>* __restrict__ out,
           const Cx<T>* __restrict__ table, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = cmul(z[i], table[i % ((size_t)kN * kN)]);
}

template <typename T, int kT>
int launch_transpose(const Cx<T>* z, Cx<T>* out, long long batch,
                     cudaStream_t st) {
  const size_t sm = (size_t)kT * (kT + 1) * sizeof(Cx<T>);
  const cudaError_t err = allow_smem({{transpose<T, kT>, sm}});
  if (err != cudaSuccess) return err;
  transpose<T, kT><<<dim3(kN / kT, kN / kT, (unsigned)batch), kThreads, sm,
                     st>>>(z, out);
  return cudaGetLastError();
}

template <typename T>
int run(const void* zin, void* zout, const void* table, long long batch,
        int kcase, int param, cudaStream_t st) {
  const Cx<T>* z = static_cast<const Cx<T>*>(zin);
  Cx<T>* out = static_cast<Cx<T>*>(zout);
  const Cx<T>* tab = static_cast<const Cx<T>*>(table);
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (kcase == kFwdRing) return launch_ring<T, kOrderR2>(z, out, tab, batch, st);
  if (kcase == kFwdRingR8)
    return launch_ring<T, kOrderR8>(z, out, tab, batch, st);
  if (kcase == kTranspose) {
    if (param == 32) return launch_transpose<T, 32>(z, out, batch, st);
    if (param == 64) return launch_transpose<T, 64>(z, out, batch, st);
    return cudaErrorInvalidValue;
  }
  if (kcase == kCmul) {
    cmul_table<T><<<1024, kThreads, 0, st>>>(z, out, tab,
                                             (size_t)batch * kN * kN);
    return cudaGetLastError();
  }
  if (kcase == kFwdReg) {
    using C = Cols<T, Split<kLogN, kLogN>>;
    static_assert(C::kW == kRegW, "the column passes' tile width");
    const cudaError_t err = allow_smem({{reg_chain<T>, C::kSmem}});
    if (err != cudaSuccess) return err;
    reg_chain<T><<<dim3(kN / kRegW, (unsigned)batch), C::kThreads, C::kSmem,
                   st>>>(z, out, tab);
    return cudaGetLastError();
  }
  if (kcase < kNoop || kcase > kShuffle) return cudaErrorInvalidValue;
  const bool stage = kcase == kR2 || kcase == kR4;
  const int radix = kcase == kR2 ? 2 : 4;
  if (stage && (param < 1 || param & (param - 1) || radix * param > kN))
    return cudaErrorInvalidValue;
  if (kcase == kShuffle && (param < 1 || param > 16 || param & (param - 1)))
    return cudaErrorInvalidValue;
  const size_t sm = (size_t)(kN + kN * kW) * sizeof(Cx<T>);
  const cudaError_t err = allow_smem({{stage_tile<T>, sm}});
  if (err != cudaSuccess) return err;
  stage_tile<T><<<dim3(kN / kW, (unsigned)batch), kThreads, sm, st>>>(
      z, out, tab, kcase, param);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). z, out: [batch, 512, 512]
// complex of the entry's type, 1 <= batch <= 65535 (the sweeps' grid);
// table: the 512 roots, or for cmul the [512, 512] table. Each launches on `stream`, allocates nothing, does not
// synchronize, and returns the launch error.
#define LOWCUT_STAGES_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* z, void* out, const void* table,          \
                      long long batch, int kcase, int param, void* stream) { \
    return run<T>(z, out, table, batch, kcase, param,                       \
                  static_cast<cudaStream_t>(stream));                       \
  }

LOWCUT_STAGES_ENTRY(lowcut_probe_stages_f32, float)
LOWCUT_STAGES_ENTRY(lowcut_probe_stages_f64, double)
