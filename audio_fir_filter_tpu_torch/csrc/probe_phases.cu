// Decomposition probes of the block convolution on Hopper (sm_90a): the
// shipped block kernel's passes launched one at a time and with phases
// switched off, and the TPU probe's own design, a fused block kernel that
// keeps each block on chip from its one read to its one write.
//
// Replaces two TPU probes of the fused Pallas conv kernel:
//   experiments/fused_phase_decomp.py make_variant (the pallas_call at
//     :152): the kernel with phases disabled (full, no_tr, ac_only,
//     b_only, copy);
//   experiments/pallas_micro.py tiled_call (the pallas_call at :73): each
//     pass alone (K1, K2, K2a, K3).
// The TPU's double-float (df64) arithmetic is not carried over: f32 and
// native f64, as the port ships.
//
// The three-pass variants (ids 0-8) are not a copy of the shipped code:
// the passes are conv_blocks.cuh's pairs_forward / pairs_inverse and
// fourstep.cuh's rows_multiply, instantiated with their ablation switches,
// so a time there is a time of the kernel that ships. Blocks [2 * pairs,
// B] float32 in and out, scratch [pairs, B] of the compute type:
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
// To keep the build short they instantiate the splits of their own shapes
// only: B = 2^16 .. 2^20 (N1 x N2 = 256 x 256 .. 1024 x 1024); any other B
// returns cudaErrorInvalidValue, which the wrappers raise.
//
// The fused block kernel (ids 9-13, fused_block below) computes what the
// TPU probe's kernel computes, the circular convolution of each real block
// of x [nb, 2^18] float32 with a real kernel's spectrum, y [nb, 2^18]
// float32, and reads x once and writes y once with no device-memory
// scratch: the TPU held a pair of blocks in VMEM (its zA / zB scratches)
// through both transposes and every FFT; here one thread-block cluster
// holds one real block in its CTAs' shared memory. The five TPU switches
// are compile-time variants of it:
//   full     the convolution;
//   no_tr    no exchange through distributed shared memory: each CTA runs
//            the row phase on its own band as if it were its slab (a
//            defined permutation, the same operations);
//   ac_only  the column phase and its inverse only: x / 256;
//   b_only   the row phase only (columns moved with no arithmetic), the
//            exchanges kept;
//   copy     load and store only: the identity.
//
// What bounds it, and the design. The work is bytes: x and y once each,
// 2 MB a block (0.0801 ms for 128 blocks at 3.35 TB/s; the FFTs' ~2.8
// Gflop in either precision are 0.042 ms at 67 TFLOP/s). The three-pass
// kernel crosses a device-memory scratch four times; the TPU kept the
// block in VMEM. A real block of 2^18 is a complex sequence z[n] = x[2n] +
// i x[2n+1] of M = 2^17 points (1 MB in complex64, 2 MB in complex128),
// which fits a cluster: f32 in 8 CTAs (portable), f64 in 16 (non-portable),
// 128 KB of shared memory each either way, one CTA a SM. Its FFT is
// four-step, z as [512, 256] (512 rows n1 x 256 columns n2), with
// fourstep.cuh's register engine (Fft<T, 9> on columns, Fft<T, 8> on rows,
// its stages, exchange swizzle and stage tables):
//   A  CTA r loads its band, columns [kCols r, +kCols) of all 512 rows, by
//      2-D tensor-map copies (two 256-row boxes a batch of kW columns);
//      column FFTs x the four-step twiddle, batch by batch, each batch in
//      its own region [512][kW] of the CTA's 128 KB;
//   X  every row comes to the CTA that owns it straight from the peers'
//      bands through distributed shared memory (ld.shared::cluster, 16-byte
//      units, the starting peer rotated by rank) into registers, and is
//      written into the CTA's slab ([kRows][256] over the same 128 KB) once
//      a cluster barrier says no peer reads the band any more;
//   B  row FFTs, one row in registers at a time, each in its own slab row;
//      then the real-input split step, the product with the kernel's
//      spectrum and the inverse split as one widely linear step,
//      Zy[k] = alpha[k] Z[k] + beta[k] conj(Z[M - k]) (alpha and beta from
//      the half spectrum, laid out once on the host like a twiddle table,
//      in the threads' order: one coalesced read a bin); inverse row FFTs;
//   X  the way back: the rows into registers, a cluster barrier, and
//      st.shared::cluster into the bands that hold their columns;
//   C  conjugate twiddle, inverse column FFTs, 1/M, and each thread's
//      results stored straight to y.
// Bin k and its partner M - k sit in rows k1 and 512 - k1: slabs are dealt
// out so that each CTA holds both rows of every pair (prow), and each warp
// takes whole pairs (warp_rows), so the split step reads its partners from
// the pair's two slab rows. The grid is persistent (as many clusters as
// are resident, cudaOccupancyMaxActiveClusters, each walking blocks cid,
// cid + G, ...), and the next block's input lands while this one is worked
// on: a 64 KB stage beside the 128 KB holds its first batches (f64: all
// four; f32: four of eight, the other four load into their regions once
// this block's last phase has left them). A CTA has 256 threads (see
// Fused): with fewer registers a thread, the row phase spilled. A launch
// the card refuses, or an occupancy of 0 clusters, returns its error and
// the wrapper raises: there is no fallback to the three-pass variants or
// the plain version.
//
// Neither family allocates or synchronizes.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "conv_blocks.cuh"
#include "tma.cuh"

namespace {

enum Variant {
  kFull = 0, kAcOnly = 1, kBOnly = 2, kNoTr = 3, kCopy = 4,
  kK1 = 5, kK2 = 6, kK2a = 7, kK3 = 8,
};

template <typename T, class S>
cudaError_t allow_variants() {
  const size_t c = Cols<T, S>::kSmem, r = Rows<T, S>::kSmem;
  cudaError_t err = allow_block_smem<T, S>();
  if (err == cudaSuccess)
    err = allow_smem({{pairs_forward<T, S, false>, c},
                      {pairs_inverse<T, S, false>, c},
                      {pairs_forward<T, S, true, false>, c},
                      {pairs_inverse<T, S, true, false>, c},
                      {rows_multiply<T, S, kRowsForward>, r}});
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

// ------------------------------------------------------ the fused block

// The block as M = 2^17 complex points z[n1 * 256 + n2], [512, 256].
constexpr int kFLog1 = 9, kFLog2 = 8;
constexpr int kFN1 = 1 << kFLog1, kFN2 = 1 << kFLog2;
constexpr int kFM = kFN1 * kFN2;
constexpr int kFBoxRows = 256;  // rows of a tensor-map box (its limit)

enum FusedVariant {
  kFusedFull = 9, kFusedNoTr = 10, kFusedAcOnly = 11, kFusedBOnly = 12,
  kFusedCopy = 13,
};

// Geometry of one CTA of a block's cluster: 256 threads, so a thread may
// hold 255 registers (ptxas: 153 in f32, 210 in f64, no spill). At 1024 and
// 512 threads (64 and 128 registers) the row phase spilled, f32 a few
// bytes and f64 hundreds; f32 at 512 ran faster, but every change moved a
// spill of a few bytes from one variant to another (PERF.md, PR 13).
// Column threads (t, w) = tid >> kLogW, & (kW - 1) run Fft<T, 9> on column
// w of a batch of kW; warp wr of the row phase runs Fft<T, 8> on its
// kPairs pairs of rows, one row at a time, lane t holding 8 points.
template <typename T>
struct Fused {
  using F1 = Fft<T, kFLog1>;
  using F2 = Fft<T, kFLog2>;
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int kC = kF64 ? 16 : 8;           // CTAs a cluster
  static constexpr int kThreads = 256;
  static constexpr int kW = kThreads / F1::kNT;      // columns a batch: 4
  static constexpr int kLogW = ilog2(kW);
  static constexpr int kCols = kFN2 / kC;            // band columns: 32 / 16
  static constexpr int kBatches = kCols / kW;        // 8 / 4
  static constexpr int kRows = kFN1 / kC;            // slab rows: 64 / 32
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPairs = kRows / 2 / kWarps;  // row pairs a warp: 4 / 2
  static constexpr int kRegion = kFN1 * kW;          // a batch's elements
  static constexpr int kHome = kBatches * kRegion;
  static_assert(kHome == kRows * kFN2 && F2::kNT == 32 && kPairs >= 1,
                "the band and the slab fill the same 128 KB");
  static constexpr size_t kHomeBytes = kHome * sizeof(Cx<T>);  // 128 KB
  // The exchanges move 16-byte units: kU elements, kUnits a lane a row.
  static constexpr int kU = 16 / sizeof(Cx<T>);
  static constexpr int kUnits = kFN2 / kU / 32;
  static constexpr int kBoxCols = 2 * kW;            // floats: 32 B
  static constexpr unsigned kBatchBytes = kFN1 * kBoxCols * sizeof(float);
  // The stage (64 KB) holds the next block's first batches: f64's four,
  // f32's first four of eight (its batches 4-7 load into their own regions
  // once this block is out).
  static constexpr int kStaged = cmin(kBatches, 65536 / kBatchBytes);
  static constexpr size_t kStageBytes = (size_t)kStaged * kBatchBytes;
  static constexpr size_t kSmem =
      kHomeBytes + kStageBytes +
      (size_t)(F1::kTableElems + F2::kTableElems) * sizeof(Cx<T>) +
      2 * sizeof(Bar);
  static_assert(kSmem <= 232448, "a CTA's shared memory");
};

__device__ __forceinline__ int high_bit(int v) { return 1 << (31 - __clz(v)); }
// v, as a value the compiler cannot see through. The kernel takes its
// thread index through this at each phase and FFT, so the addresses
// derived from it (the swizzled places of every exchange) are recomputed
// there: computed once, they stayed live across every phase and spilled.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ int brev8(int v) { return (int)(__brev(v) >> 24); }

// Row (of the 512) that slab row j of CTA r holds. CTA 0 holds rows
// [0, R); CTA r >= 1 holds, of the rows [G, 2G) with G = R hb(r), the
// R / 2 from G + cl R / 2 up and their mirrors 3G - 1 - p (cl = r - hb(r)).
// Row p's bins k1 = bitrev9(p) pair with 512 - k1, which is row p ^ (hb(p)
// - 1), the mirror within [hb(p), 2 hb(p)): so each slab holds both rows
// of every pair (tests/test_torch_probes.py checks the maps).
template <int R>
__device__ __forceinline__ int prow(int r, int j) {
  if (r == 0) return j;
  const int h = high_bit(r), g = R * h, cl = r - h;
  return j < R / 2 ? g + cl * (R / 2) + j : 2 * g - R - cl * (R / 2) + j;
}

// The two slab rows (jA, jB) of warp w in the row phase: a pair whose
// bins pair up, so the split step's partners are in one warp. CTA r >= 1:
// j and R - 1 - j; CTA 0: rows 0 and 1 (each its own pair), then the
// mirrors w + h and 5h - 1 - w within [2h, 4h), h = hb(w).
template <int R>
__device__ __forceinline__ int2 warp_rows(int r, int w) {
  if (r != 0) return make_int2(w, R - 1 - w);
  if (w == 0) return make_int2(0, 1);
  const int h = high_bit(w);
  return make_int2(w + h, 5 * h - 1 - w);
}

// alpha and beta of one bin, read as one access.
template <typename T>
struct alignas(4 * sizeof(T)) Ab {
  Cx<T> a, b;
};

template <typename T>
__device__ __forceinline__ Cx<T> widely(Ab<T> c, Cx<T> z, Cx<T> zp) {
  return cadd(cmul(c.a, z), cmulc(c.b, zp));
}

// The barrier of a tile shared by the CTA's warps, or (kWarp) by one warp.
template <bool kWarp>
__device__ __forceinline__ void tile_sync() {
  if constexpr (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Fft<T, LOG>::forward / inverse (fourstep.cuh), stage for stage, with
// each exchange taking the thread's index t = opaque(tid) >> shift afresh:
// the shipped drivers take t once, and here the compiler then kept every
// exchange's addresses live across the butterflies and spilled them.
template <typename T, int LOG, int STRIDE, int SF, int ST, bool kWarp>
__device__ __forceinline__ void xchg(Cx<T> (&v)[Fft<T, LOG>::kE], Cx<T>* s,
                                     int t) {
  using F = Fft<T, LOG>;
  tile_sync<kWarp>();
#pragma unroll
  for (int m = 0; m < F::kE; ++m) s[F::swz(F::template pos<SF>(t, m)) * STRIDE] = v[m];
  tile_sync<kWarp>();
#pragma unroll
  for (int m = 0; m < F::kE; ++m) v[m] = s[F::swz(F::template pos<ST>(t, m)) * STRIDE];
}

// Forward DIF in registers: natural order in, bit-reversed out; every
// exchange first waits for the tile's earlier reads (kLead throughout).
// The transform's thread index is opaque(u) >> kShift; kWarp: the tile is
// one warp's (a row), so its exchanges need only the warp's barrier.
template <typename T, int LOG, int STRIDE, int kShift, bool kWarp, int S = 0>
__device__ __forceinline__ void fwd(Cx<T> (&v)[Fft<T, LOG>::kE], Cx<T>* s,
                                    const Cx<T>* tw, int u) {
  using F = Fft<T, LOG>;
  if constexpr (S > 0)
    xchg<T, LOG, STRIDE, S - 1, S, kWarp>(v, s, opaque(u) >> kShift);
  F::template stage<S, false>(v, tw, opaque(u) >> kShift);
  if constexpr (S + 1 < F::kStages)
    fwd<T, LOG, STRIDE, kShift, kWarp, S + 1>(v, s, tw, u);
}

// Inverse DIT, unscaled: bit-reversed in, natural out.
template <typename T, int LOG, int STRIDE, int kShift, bool kWarp,
          int S = Fft<T, LOG>::kStages - 1>
__device__ __forceinline__ void inv(Cx<T> (&v)[Fft<T, LOG>::kE], Cx<T>* s,
                                    const Cx<T>* tw, int u) {
  using F = Fft<T, LOG>;
  if constexpr (S < F::kStages - 1)
    xchg<T, LOG, STRIDE, S + 1, S, kWarp>(v, s, opaque(u) >> kShift);
  F::template stage<S, true>(v, tw, opaque(u) >> kShift);
  if constexpr (S > 0) inv<T, LOG, STRIDE, kShift, kWarp, S - 1>(v, s, tw, u);
}

// Row h (256 points, natural order) -> its spectrum in place, bin q at
// h[swz(q)] (bit-reversed q, the exchange tile's own order); lane t =
// tid & 31. The row is the calling warp's alone.
template <typename T>
__device__ __forceinline__ void row_forward(Cx<T>* h, const Cx<T>* tab, int tid) {
  using F2 = Fft<T, kFLog2>;
  Cx<T> v[F2::kE];
  int t = opaque(tid) & (F2::kNT - 1);
#pragma unroll
  for (int m = 0; m < F2::kE; ++m) v[m] = h[F2::template pos<0>(t, m)];
  fwd<T, kFLog2, 1, 0, true>(v, h, tab, tid & (F2::kNT - 1));
  __syncwarp();  // the last exchange's reads
  t = opaque(tid) & (F2::kNT - 1);
#pragma unroll
  for (int m = 0; m < F2::kE; ++m)
    h[F2::swz(F2::template pos<F2::kStages - 1>(t, m))] = v[m];
}

// Columns [n2, n2 + kU) of band row p (a 16-byte unit), in the CTA that
// holds them: the shared::cluster address of place p kW + n2 % kW of its
// region.
template <typename T, class P>
__device__ __forceinline__ unsigned band_addr(const Cx<T>* home, int p, int n2) {
  const int c = n2 % P::kCols;
  return cluster_addr(home + (c / P::kW) * P::kRegion + p * P::kW + c % P::kW,
                      n2 / P::kCols);
}

// Cluster blockIdx.x / kC walks blocks cid, cid + G, ... of x (G clusters).
// kV selects the phases (FusedVariant); thread 0 issues the bulk copies.
// ab and tw4 are not __restrict__: as read-only data their loads could be
// hoisted phases ahead of their use, across the barriers, and spilled.
template <typename T, int kV>
__global__ void __launch_bounds__(Fused<T>::kThreads, 1)
fused_block(const __grid_constant__ CUtensorMap xmap, float* __restrict__ y,
            const Ab<T>* ab, const Cx<T>* tw4, const Cx<T>* __restrict__ w1,
            const Cx<T>* __restrict__ w2, int nblocks) {
  using P = Fused<T>;
  using F1 = typename P::F1;
  using F2 = typename P::F2;
  constexpr bool kCols =
      kV == kFusedFull || kV == kFusedNoTr || kV == kFusedAcOnly;
  constexpr bool kXchg = kV == kFusedFull || kV == kFusedBOnly;
  constexpr bool kRowsOn =
      kV == kFusedFull || kV == kFusedNoTr || kV == kFusedBOnly;
  constexpr int kLast1 = F1::kStages - 1, kLast2 = F2::kStages - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  // The home (kBatches regions [512][kW], or the slab [kRows][256]), the
  // stage, the twiddle tables, the barriers (stage; f32: regions 4-7).
  Cx<T>* home = reinterpret_cast<Cx<T>*>(smem);
  Cx<float>* stage = reinterpret_cast<Cx<float>*>(smem + P::kHomeBytes);
  Cx<T>* tab1 = reinterpret_cast<Cx<T>*>(smem + P::kHomeBytes + P::kStageBytes);
  Cx<T>* tab2 = tab1 + F1::kTableElems;
  Bar* bar = reinterpret_cast<Bar*>(tab2 + F2::kTableElems);
  cg::cluster_group cluster = cg::this_cluster();
  const int cid = blockIdx.x / P::kC;
  // G, the clusters of the grid, taken afresh where used (kept, it spilled).
  auto ncl = [] { return opaque((int)gridDim.x) / P::kC; };
  const int tid = threadIdx.x;
  const CUtensorMap* xm = &xmap;
  // The rank, and in the loop the thread's indices, through opaque().
  const int rank = (int)cluster.block_rank();

  // Batch b of block blk's band (floats [2 n2, 2 n2 + kBoxCols) of 512
  // rows, n2 = kCols rank + kW b) into dst as [512][kW] complex64.
  auto load_batch = [&](int blk, int b, Cx<float>* dst, Bar* br) {
    for (int h = 0; h < kFN1 / kFBoxRows; ++h)
      tile_load(dst + h * kFBoxRows * P::kW, xm,
                P::kBoxCols * (P::kBatches * rank + b),
                blk * kFN1 + h * kFBoxRows, br);
  };
  auto load_stage = [&](int blk) {
    mbar_expect_tx(&bar[0], (unsigned)P::kStageBytes);
    for (int b = 0; b < P::kStaged; ++b)
      load_batch(blk, b, stage + b * P::kRegion, &bar[0]);
  };
  auto load_in_place = [&](int blk) {  // f32: batches 4-7 into their regions
    mbar_expect_tx(&bar[1], (P::kBatches - P::kStaged) * P::kBatchBytes);
    for (int b = P::kStaged; b < P::kBatches; ++b)
      load_batch(blk, b, reinterpret_cast<Cx<float>*>(home + b * P::kRegion),
                 &bar[1]);
  };

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // cid < nblocks: the grid has at most one cluster a block
    load_stage(cid);
    if constexpr (P::kBatches > P::kStaged) load_in_place(cid);
  }
  if constexpr (kCols) F1::build_table(tab1, w1, tid, P::kThreads);
  if constexpr (kRowsOn) F2::build_table(tab2, w2, tid, P::kThreads);
  __syncthreads();  // the twiddle tables

  // blk is the only value the loop carries (with more, f32 spilled them).
  for (int blk = cid; blk < nblocks; blk += ncl()) {
    const unsigned par = ((blk - cid) / ncl()) & 1;
    const int r = opaque(rank);

    // A: column FFTs x the four-step twiddle (rows left bit-reversed).
    mbar_wait(&bar[0], par);
#pragma unroll 1
    for (int b = 0; b < P::kBatches; ++b) {
      const Cx<float>* src = stage + b * P::kRegion;
      if constexpr (P::kBatches > P::kStaged) {
        if (b >= P::kStaged) {
          if (b == P::kStaged) mbar_wait(&bar[1], par);
          src = reinterpret_cast<const Cx<float>*>(home + b * P::kRegion);
        }
      }
      Cx<T>* reg = home + b * P::kRegion;
      const int ti = opaque(tid), tc = ti >> P::kLogW, wc = ti & (P::kW - 1);
      const int n2 = P::kCols * r + P::kW * b + wc;
      Cx<T> v[F1::kE];
#pragma unroll
      for (int m = 0; m < F1::kE; ++m) {
        const Cx<float> a = src[F1::template pos<0>(tc, m) * P::kW + wc];
        v[m] = {static_cast<T>(a.re), static_cast<T>(a.im)};
      }
      if constexpr (kCols) {
        // kLead: every thread has read the source before the region is
        // written (f32's batches 4-7 are their own sources).
        fwd<T, kFLog1, P::kW, P::kLogW, false>(v, reg + wc, tab1, tid);
        __syncthreads();  // the last exchange's reads
        const int tl = opaque(tid) >> P::kLogW;
#pragma unroll
        for (int m = 0; m < F1::kE; ++m) {
          const int p = F1::template pos<kLast1>(tl, m);
          reg[p * P::kW + wc] = cmul(v[m], tw4[p * kFN2 + n2]);
        }
      } else {
        __syncthreads();
#pragma unroll
        for (int m = 0; m < F1::kE; ++m)
          reg[F1::template pos<0>(tc, m) * P::kW + wc] = v[m];
      }
    }
    fence_async_shared();
    __syncthreads();  // the stage is read: the next block's input may land
    if (tid == 0 && blk + ncl() < nblocks) load_stage(blk + ncl());

    // B: the row phase. Warp wr holds the pairs of slab rows wr + kWarps s
    // (rows pa, pb of the block, whose bins pair up), one row in registers
    // at a time between the exchanges.
    if constexpr (kRowsOn) {
      // Slab rows of the warp's pair s.
      auto rows = [&](int s) {
        return warp_rows<P::kRows>(r, (opaque(tid) >> F2::kLogNT) + P::kWarps * s);
      };
      if constexpr (kXchg) {
        // The rows from the peers' bands, into the slab once no peer reads
        // this CTA's band any more: lane tr moves the 16-byte units u = tr +
        // 32 ((k + r) mod kUnits) of each row (columns [u kU, +kU)), the
        // rotation by rank spreading the CTAs over the peers.
        float4 ua[P::kPairs][P::kUnits], ub[P::kPairs][P::kUnits];
        cluster.sync();  // every band of the block is written
        int tr = opaque(tid) & 31, rr = opaque(rank);
#pragma unroll
        for (int k = 0; k < P::kUnits; ++k) {
          const int u = tr + 32 * ((k + rr) & (P::kUnits - 1));
          const unsigned at = band_addr<T, P>(home, 0, u * P::kU);
#pragma unroll
          for (int s = 0; s < P::kPairs; ++s) {
            const int2 jj = rows(s);
            const int pa = prow<P::kRows>(r, jj.x), pb = prow<P::kRows>(r, jj.y);
            ua[s][k] = ld_cluster(at + pa * P::kW * sizeof(Cx<T>));
            ub[s][k] = ld_cluster(at + pb * P::kW * sizeof(Cx<T>));
          }
        }
        cluster.sync();  // no peer reads this band any more
        tr = opaque(tid) & 31;
        rr = opaque(rank);
#pragma unroll
        for (int s = 0; s < P::kPairs; ++s) {
          const int2 jj = rows(s);
          float4* ha = reinterpret_cast<float4*>(home + jj.x * kFN2);
          float4* hb = reinterpret_cast<float4*>(home + jj.y * kFN2);
#pragma unroll
          for (int k = 0; k < P::kUnits; ++k) {
            const int u = tr + 32 * ((k + rr) & (P::kUnits - 1));
            ha[u] = ua[s][k];
            hb[u] = ub[s][k];
          }
        }
        __syncwarp();  // a unit holds other lanes' points
      }
      // A pair's rows are its warp's alone: from here to exchange 2 the
      // warps need only their own barriers.
#pragma unroll 1
      for (int s = 0; s < P::kPairs; ++s) {
        // The rows' tiles, taken afresh at each step (rows(s) is opaque).
        auto ha = [&] { return home + rows(s).x * kFN2; };
        auto hb = [&] { return home + rows(s).y * kFN2; };
        row_forward(ha(), tab2, tid);
        row_forward(hb(), tab2, tid);
        __syncwarp();  // both rows' spectra are in place
        // Bin k = k1 + 512 k2 at q = bitrev8(k2) = pos<last>(tr, m) of row
        // pa pairs with M - k at 255 - q of row pb, and the other way
        // round; CTA 0's first pair is rows 0 and 1, each its own pair:
        // row 1 the same way, row 0 (k1 = 0) with k2' = (256 - k2) mod 256.
        Cx<T> v[F2::kE], v2[F2::kE];
        {
          const int2 jj = rows(s);
          const int tr = opaque(tid) & (F2::kNT - 1);
          const bool own = r == 0 && jj.x == 0;
          const Cx<T>* a = home + jj.x * kFN2;
          const Cx<T>* b = home + jj.y * kFN2;
          const Cx<T>* pra = own ? a : b;
          const Cx<T>* prb = own ? b : a;
          // alpha, beta in the threads' order: [row][m][lane]
          const Ab<T>* aba = ab + (size_t)prow<P::kRows>(r, jj.x) * kFN2 + tr;
          const Ab<T>* abb = ab + (size_t)prow<P::kRows>(r, jj.y) * kFN2 + tr;
#pragma unroll
          for (int m = 0; m < F2::kE; ++m) {
            const int q = F2::template pos<kLast2>(tr, m);
            const int qa = own ? brev8((kFN2 - brev8(q)) & (kFN2 - 1)) : kFN2 - 1 - q;
            v[m] = widely(aba[m * F2::kNT], a[F2::swz(q)], pra[F2::swz(qa)]);
            v2[m] = widely(abb[m * F2::kNT], b[F2::swz(q)],
                           prb[F2::swz(kFN2 - 1 - q)]);
          }
        }
        __syncwarp();  // every partner is read
        int tr = opaque(tid) & (F2::kNT - 1);
#pragma unroll
        for (int m = 0; m < F2::kE; ++m)  // row pb's product waits in its tile
          hb()[F2::swz(F2::template pos<kLast2>(tr, m))] = v2[m];
        inv<T, kFLog2, 1, 0, true>(v, ha(), tab2, tid & (F2::kNT - 1));
        __syncwarp();  // the last exchange's reads
        tr = opaque(tid) & (F2::kNT - 1);
        {
          Cx<T>* a = ha();
          const Cx<T>* b = hb();
#pragma unroll
          for (int m = 0; m < F2::kE; ++m) {
            a[F2::template pos<0>(tr, m)] = v[m];
            v2[m] = b[F2::swz(F2::template pos<kLast2>(tr, m))];
          }
        }
        inv<T, kFLog2, 1, 0, true>(v2, hb(), tab2, tid & (F2::kNT - 1));
        __syncwarp();  // the last exchange's reads
        tr = opaque(tid) & (F2::kNT - 1);
        Cx<T>* b = hb();
#pragma unroll
        for (int m = 0; m < F2::kE; ++m) b[F2::template pos<0>(tr, m)] = v2[m];
      }
      if constexpr (kXchg) {
        // Every row back to the bands that hold its columns, once every
        // CTA is done with its slab; the units of exchange 1.
        float4 ua[P::kPairs][P::kUnits], ub[P::kPairs][P::kUnits];
        __syncwarp();  // a unit holds other lanes' points
        int tr = opaque(tid) & 31, rr = opaque(rank);
#pragma unroll
        for (int s = 0; s < P::kPairs; ++s) {
          const int2 jj = rows(s);
          const float4* ha = reinterpret_cast<const float4*>(home + jj.x * kFN2);
          const float4* hb = reinterpret_cast<const float4*>(home + jj.y * kFN2);
#pragma unroll
          for (int k = 0; k < P::kUnits; ++k) {
            const int u = tr + 32 * ((k + rr) & (P::kUnits - 1));
            ua[s][k] = ha[u];
            ub[s][k] = hb[u];
          }
        }
        cluster.sync();  // every slab is done
        tr = opaque(tid) & 31;
        rr = opaque(rank);
#pragma unroll
        for (int k = 0; k < P::kUnits; ++k) {
          const int u = tr + 32 * ((k + rr) & (P::kUnits - 1));
          const unsigned at = band_addr<T, P>(home, 0, u * P::kU);
#pragma unroll
          for (int s = 0; s < P::kPairs; ++s) {
            const int2 jj = rows(s);
            const int pa = prow<P::kRows>(r, jj.x), pb = prow<P::kRows>(r, jj.y);
            st_cluster(at + pa * P::kW * sizeof(Cx<T>), ua[s][k]);
            st_cluster(at + pb * P::kW * sizeof(Cx<T>), ub[s][k]);
          }
        }
        cluster.sync();  // every band of the block is whole again
      } else {
        __syncthreads();
      }
    }

    // C: conjugate twiddle, inverse column FFTs, 1/M; straight to y.
#pragma unroll 1
    for (int b = 0; b < P::kBatches; ++b) {
      Cx<T>* reg = home + b * P::kRegion;
      const int ti = opaque(tid), tc = ti >> P::kLogW, wc = ti & (P::kW - 1);
      const int n2 = P::kCols * r + P::kW * b + wc;
      Cx<T> v[F1::kE];
      if constexpr (kCols) {
#pragma unroll
        for (int m = 0; m < F1::kE; ++m) {
          const int p = F1::template pos<kLast1>(tc, m);
          v[m] = cmulc(reg[p * P::kW + wc], tw4[p * kFN2 + n2]);
        }
        inv<T, kFLog1, P::kW, P::kLogW, false>(v, reg + wc, tab1, tid);
        const T scale = T(1) / static_cast<T>(kFM);
#pragma unroll
        for (int m = 0; m < F1::kE; ++m) v[m] = scl(v[m], scale);
      } else {
#pragma unroll
        for (int m = 0; m < F1::kE; ++m)
          v[m] = reg[F1::template pos<0>(tc, m) * P::kW + wc];
      }
      float2* yb = reinterpret_cast<float2*>(y) + (size_t)blk * kFM + n2;
      const int tl = opaque(tid) >> P::kLogW;
#pragma unroll
      for (int m = 0; m < F1::kE; ++m)
        yb[(size_t)F1::template pos<0>(tl, m) * kFN2] =
            make_float2(static_cast<float>(v[m].re), static_cast<float>(v[m].im));
    }
    if constexpr (P::kBatches > P::kStaged) {
      fence_async_shared();
      __syncthreads();  // regions 4-7 are read: the next input may land
      if (tid == 0 && blk + ncl() < nblocks) load_in_place(blk + ncl());
    }
  }
}

template <typename T, int kV>
cudaError_t fused_occupancy(int* clusters) {
  using P = Fused<T>;
  return max_active_clusters(fused_block<T, kV>, P::kC, P::kThreads, P::kSmem,
                             clusters);
}

// x, y: [nblocks, 2^18] float32; ab: [512, 256, 2] (alpha, beta); tw4 the
// M = 2^17 four-step twiddle [512, 256]; w1, w2 the 512- and 256-point half
// tables.
template <typename T, int kV>
int launch_fused(const float* x, float* y, const Ab<T>* ab, const Cx<T>* tw4,
                 const Cx<T>* w1, const Cx<T>* w2, long long nblocks,
                 cudaStream_t st) {
  using P = Fused<T>;
  if (nblocks < 1 || nblocks > (1LL << 22)) return cudaErrorInvalidValue;
  int clusters = 0;
  cudaError_t err = fused_occupancy<T, kV>(&clusters);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorInvalidConfiguration;
  CUtensorMap xmap{};
  // x as [nblocks * 512, 512] floats; a box is 256 rows of a batch's
  // 2 kW floats.
  err = tile_map<float>(&xmap, x, (unsigned long long)nblocks * kFN1, 2 * kFN2,
                        kFBoxRows, P::kBoxCols);
  if (err != cudaSuccess) return err;
  const long long g = clusters < nblocks ? clusters : nblocks;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      (unsigned)(g * P::kC), P::kThreads, P::kSmem, P::kC, &attr, st);
  err = cudaLaunchKernelEx(&cfg, fused_block<T, kV>, xmap, y, ab, tw4, w1, w2,
                           (int)nblocks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int run_fused(const float* x, float* y, const Ab<T>* ab, const Cx<T>* tw4,
              const Cx<T>* w1, const Cx<T>* w2, long long nblocks, int log_n1,
              int log_n2, int variant, cudaStream_t st) {
  if (log_n1 != kFLog1 || log_n2 != kFLog2) return cudaErrorInvalidValue;
  switch (variant) {
    case kFusedFull:
      return launch_fused<T, kFusedFull>(x, y, ab, tw4, w1, w2, nblocks, st);
    case kFusedNoTr:
      return launch_fused<T, kFusedNoTr>(x, y, ab, tw4, w1, w2, nblocks, st);
    case kFusedAcOnly:
      return launch_fused<T, kFusedAcOnly>(x, y, ab, tw4, w1, w2, nblocks, st);
    case kFusedBOnly:
      return launch_fused<T, kFusedBOnly>(x, y, ab, tw4, w1, w2, nblocks, st);
    case kFusedCopy:
      return launch_fused<T, kFusedCopy>(x, y, ab, tw4, w1, w2, nblocks, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// [clusters, registers, local bytes] of fused_block<T, full>.
template <typename T>
cudaError_t fused_resources(int* out) {
  cudaError_t err = fused_occupancy<T, kFusedFull>(&out[0]);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fused_block<T, kFusedFull>);
  if (err != cudaSuccess) return err;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  return cudaSuccess;
}

template <typename T>
int run(const float* blocks, float* out, const void* H, const void* tw4,
        const void* w1, const void* w2, void* scratch, long long pairs,
        int log_n1, int log_n2, int variant, cudaStream_t st) {
  if (variant >= kFusedFull)  // pairs is the count of real blocks
    return run_fused<T>(blocks, out, static_cast<const Ab<T>*>(H),
                        static_cast<const Cx<T>*>(tw4),
                        static_cast<const Cx<T>*>(w1),
                        static_cast<const Cx<T>*>(w2), pairs, log_n1, log_n2,
                        variant, st);
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
// allocate nothing, do not synchronize, return the launch error. Variants
// 0-8 take pairs of blocks and a scratch; the fused ones (9-13) take
// `pairs` = the count of real blocks, H = the [512, 256, 2] alpha / beta
// table, the tables of the split 2^9 x 2^8 (log_n1, log_n2 = 9, 8) and no
// scratch.
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

// out (int [6]): [clusters, registers, local bytes] of the fused full
// kernel in f32, then in f64. The other arguments are unused.
extern "C" int lowcut_probe_fused_occupancy(const void*, void* out, const void*,
                                            const void*, const void*,
                                            const void*, void*, long long, int,
                                            int, int, void*) {
  int* o = static_cast<int*>(out);
  cudaError_t err = fused_resources<float>(o);
  return err != cudaSuccess ? err : fused_resources<double>(o + 3);
}
