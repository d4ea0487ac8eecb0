// Floor probes on Hopper (sm_90a): the launch floor, the bandwidth floor
// of staged copies, and the copy floor of the block kernel's own data
// movement. float32; every output is a defined function of the input, so
// no load or store can be dropped by the compiler.
//
// Replaces three TPU probes:
//   experiments/dispatch_floor_probe.py make_passthru (pallas_call at :67):
//     passthrough by grid step. Here: `passthru`, x [g, 2, 512, 512] ->
//     y = x, kPassCtas CTAs per [2, 512, 512] block, 16-byte accesses; and
//     `empty`, a kernel that does nothing (the launch floor).
//   experiments/dma_bw_micro.py bw_kernel (pallas_calls at :105 and
//     :123): double-buffered HBM <-> VMEM DMA, the TPU's copy engine. Here:
//     `bw`, the card's copy engine: TMA bulk copies (cp.async.bulk) through
//     a ring of kBwStages 32 KB shared-memory stages, each completing on its
//     own mbarrier, over x [steps, rows, 512] cut into 32 KB tiles (16 rows).
//     `split` (1 or 4) is the number of bulk copies a stage is issued as
//     (the counterpart of the DMA chunking). Modes:
//       both  global -> shared -> global: y = x;
//       in    global -> shared only: sums[step] = the step's sum (float64);
//       out   shared -> global only: y[step, r, c] = step * 8192
//             + (r % 16) * 512 + c, written by the threads into each stage;
//       none  no traffic: y = ones [steps, 8, 512].
//   experiments/copy_floor_probe.py make_variant (pallas_call at :134):
//     the fused kernel's data movement with no arithmetic. Here: the block
//     kernel's pattern at B = 2^18 (N1 = N2 = 512), x [pairs, 2, 512, 512]
//     -> y = x through a [pairs, B] complex64 scratch:
//       passthru  global -> global (the `passthru` kernel);
//       1buf      pass 1's gather + column-strided store, pass 3's
//                 strided load + scatter; no pass 2;
//       copy      pass 1 and 3 storing / loading each tile contiguously,
//                 with pass 2's row round trip (fourstep.cuh rows_multiply
//                 in its copy mode: each row loaded into registers,
//                 through the shipped exchanges, stored);
//       tr        copy, with pass 1's and 3's column-strided scratch
//                 access (the shipped layout; the card's plane transpose);
//       notiles   one element per thread, no shared-memory tile;
//       hint      copy with 16-byte vector loads and stores;
//       lt256     copy at tc = 32 columns per tile;
//       lt512     copy at tc = 8 (tc = 64 would need 256 KB of shared
//                 memory, above the 227 KB a CTA may use). The cf_ tiles
//                 are this probe's own (tc = 16 elsewhere), as the TPU
//                 probe's were; the shipped column passes gather into
//                 and store from registers.
//     and, with no scratch, the TPU probe's own design, a block resident on
//     chip between one read and one write (its VMEM blocks and scratches):
//       cluster   one thread-block cluster per real [512, 512] plane, its
//                 data in the CTAs' shared memory; both transposes are
//                 all-to-alls through distributed shared memory (below);
//       cluster16 the same in a non-portable cluster of 16 CTAs.
//
// What bounds `bw`, and the design. The work is bytes: 2 x 537 MB at rows
// 2048 in `both`, 0.321 ms at 3.35 TB/s. The cp.async design before it
// (one CTA per step: 128 CTAs on 132 SMs, two 32 KB stages, every thread
// issuing 16-byte copies and a __syncthreads per stage) ran 5 % behind
// x.clone(). Here one elected thread per CTA issues every copy: loads with
// cp.async.bulk ... mbarrier::complete_tx::bytes into the ring (expect_tx
// of 32 KB a stage, far under the 2^20 an mbarrier phase counts), stores
// straight from shared memory with cp.async.bulk ... bulk_group, and a
// stage is refilled only after cp.async.bulk.wait_group.read says its
// store has read it. Threads wait on a stage's phase parity, (use count)
// & 1; no __syncthreads per stage. The grid is persistent: as many CTAs as
// occupancy allows on every SM (a ring of 4 x 32 KB leaves room for one a
// SM: 132 CTAs; a second ring a SM would need stages under 32 KB). CTA c of
// G walks the tiles c, c + G, c + 2 G, ... of the T = steps x rows / 16
// tiles, so no SM idles and the tiles of a step spread over CTAs: `in`
// writes one float64 partial a tile (warps summed in a fixed order), and a
// second kernel sums a step's partials in tile order, so a step's sum does
// not depend on timing. Every bulk copy is 16-byte aligned and a multiple
// of 16 bytes (8 KB or 32 KB). `in` and `out` add 8 consumer warps: `in`
// reduces the stage that landed and releases it on the stage's `empty`
// mbarrier; `out` writes the pattern, fences it for the async proxy
// (fence.proxy.async.shared::cta) and arrives on `full`, and the store of
// a stage releases it to the writers through `empty`. The sweep behind the
// choice (lowcut_probe_bw_ring; PERF.md, H100 80GB HBM3 at 700 W): 2, 4 and
// 6 stages and 128 or 132 CTAs read within 1.6 % of each other, 64 CTAs
// 7-35 % slower, the strided walk 0.5-1.6 % faster than one contiguous run
// a CTA. What is left is the copy engine's own rate: read-only (`in`)
// 2.80-2.87 TB/s, write-only (`out`) 3.08-3.14, and `both` takes about
// the sum of the two times, 3-4 % behind x.clone().
//
// What bounds `cluster`, and the design. Bytes again: x and y once each
// (2 x 2.11 GB at the headline's 1008 pairs, 1.262 ms at 3.35 TB/s). The
// scratch variants cross device memory six times (tr); the TPU kept the
// block in VMEM. The card's counterpart of a VMEM-resident 2^18 block is a
// thread-block cluster's distributed shared memory: 8 CTAs of 1024 threads
// hold one 1 MB plane, 64 contiguous rows (128 KB, one bulk copy) each.
// Then cluster.sync; the first transpose: CTA r reads its 64-column band,
// the 64 x 64 block (p, r) of every peer p, in round k from peer (r + k)
// mod 8 (no two CTAs read one peer in a round), 16 bytes a thread, into
// registers (1024 threads x 32 floats = 128 KB: a second 128 KB buffer
// would exceed the 227 KB a CTA may use); cluster.sync (no peer reads the
// slab any more), the band written over the slab ([512, 64] row-major: a
// column pass would read it with lanes on columns, conflict-free);
// cluster.sync; the second transpose back in the same way; the bulk store
// of the rows; a final cluster.sync, so no CTA exits while a peer might
// still read it. Every shared-memory access is 16 bytes on consecutive
// addresses, so no exchange has a bank conflict. Cluster size: `cluster16`
// is the non-portable alternative, 16 CTAs of 32 rows (64 KB, 512 threads,
// two CTAs a SM). lowcut_probe_cluster_occupancy reports
// cudaOccupancyMaxActiveClusters for both: 15 clusters of 8 (120 SMs busy)
// against 14 of 16 (224 CTAs on 112 SMs) on the card, so `cluster` keeps 8,
// portable; `cluster16` measured 2-6 % slower, because either holds ~15
// planes (15 MB of shared memory) in flight and a plane's load, exchanges
// and store run one after another (PERF.md). A launch the card refuses, or an occupancy
// of 0 clusters, returns its error and the wrapper raises: there is no
// fallback to another variant.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fourstep.cuh"
#include "tma.cuh"

namespace {

// ------------------------------------------------------------ launch floor

__global__ void empty_kernel() {}

constexpr int kPassCtas = 64;

// y = x over nblk blocks of `per` float4, kPassCtas CTAs per block.
__global__ void __launch_bounds__(kThreads)
passthru(const float4* __restrict__ x, float4* __restrict__ y, long long per) {
  const size_t base = (size_t)blockIdx.y * per;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (long long)gridDim.x * blockDim.x)
    y[base + i] = x[base + i];
}

// ---------------------------------------------------------- staged copies

constexpr int kBwCols = 512;
constexpr int kBwTileRows = 16;
constexpr int kBwTile = kBwTileRows * kBwCols;  // floats per stage: 32 KB
constexpr unsigned kBwTileBytes = kBwTile * sizeof(float);
constexpr int kBwNone = 0, kBwIn = 1, kBwOut = 2, kBwBoth = 3;
constexpr int kBwStages = 4;  // the ring's depth
constexpr bool kBwStrided = true;  // the walk over the tiles (bw_ring)
constexpr int kBwWarps = 8;   // consumer warps of `in` and `out`

constexpr int bw_threads(int mode) {
  return mode == kBwBoth ? 32 : 32 * (1 + kBwWarps);
}
constexpr size_t bw_smem(int stages) {
  return (size_t)stages * kBwTileBytes + 2 * stages * sizeof(Bar) +
         (size_t)stages * kBwWarps * sizeof(double);
}

// y = ones [steps, 8, 512]: the grid floor, one CTA a step.
__global__ void __launch_bounds__(kThreads) bw_none(float* __restrict__ y) {
  for (int i = threadIdx.x; i < 8 * kBwCols; i += blockDim.x)
    y[(size_t)blockIdx.x * 8 * kBwCols + i] = 1.0f;
}

// The CTA's j-th tile of x (tile t: floats [t kBwTile, (t + 1) kBwTile))
// uses stage j % kStages. Walks: kStrided, tiles c, c + G, c + 2 G, ... of
// CTA c of G (all CTAs in one window of G tiles at a time); else the
// contiguous run [c T / G, (c + 1) T / G). Thread 0 issues every bulk copy;
// warps 1 .. kBwWarps consume (in) or produce (out) stages.
template <int kMode, int kSplit, int kStages, bool kStrided>
__global__ void __launch_bounds__(bw_threads(kMode), 1)
bw_ring(const float* __restrict__ x, float* __restrict__ y,
        double* __restrict__ part, long long tiles, int per_step) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  Bar* full = reinterpret_cast<Bar*>(smem + kStages * kBwTileBytes);
  Bar* empty = full + kStages;
  double* wsum = reinterpret_cast<double*>(empty + kStages);  // [kStages][kBwWarps]
  const long long t0 = kStrided ? blockIdx.x : tiles * blockIdx.x / gridDim.x;
  const int n = kStrided
      ? (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
      : (int)(tiles * (blockIdx.x + 1) / gridDim.x - t0);
  auto tile = [&](int j) {
    return kStrided ? t0 + (long long)j * gridDim.x : t0 + j;
  };
  constexpr unsigned kPiece = kBwTileBytes / kSplit;  // bytes a bulk copy
  static_assert(kPiece % 16 == 0 && kBwTileBytes < (1u << 20), "bulk copy");
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kMode == kBwOut ? kBwWarps : 1);
      mbar_init(&empty[s], kMode == kBwIn ? kBwWarps : 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto stage = [&](int j) { return ring + (j % kStages) * kBwTile; };
  auto load = [&](int j) {
    Bar* bar = &full[j % kStages];
    mbar_expect_tx(bar, kBwTileBytes);
    const float* src = x + tile(j) * kBwTile;
    for (int g = 0; g < kSplit; ++g)
      bulk_load(stage(j) + g * (kBwTile / kSplit), src + g * (kBwTile / kSplit),
                kPiece, bar);
  };
  auto store = [&](int j) {
    float* dst = y + tile(j) * kBwTile;
    for (int g = 0; g < kSplit; ++g)
      bulk_store(dst + g * (kBwTile / kSplit), stage(j) + g * (kBwTile / kSplit),
                 kPiece);
    bulk_commit();
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kMode == kBwBoth) {
    // One thread: tile j's store, then the refill of tile j - 1's stage
    // once that store has read it (wait_group.read 1 leaves tile j's).
    if (threadIdx.x) return;
    for (int j = 0; j < kStages && j < n; ++j) load(j);
    for (int j = 0; j < n; ++j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      store(j);
      if (j >= 1 && j - 1 + kStages < n) {
        bulk_wait_read<1>();
        load(j - 1 + kStages);
      }
    }
    bulk_wait_read<0>();
  } else if constexpr (kMode == kBwIn) {
    if (warp == 0) {
      if (lane) return;
      // The tile partial: the warps' sums in warp order.
      auto partial = [&](int j) {
        const double* w = wsum + (j % kStages) * kBwWarps;
        double t = 0.0;
        for (int i = 0; i < kBwWarps; ++i) t += w[i];
        part[tile(j)] = t;
      };
      for (int j = 0; j < n; ++j) {
        if (j >= kStages) {
          mbar_wait(&empty[j % kStages], (j / kStages - 1) & 1);
          partial(j - kStages);
        }
        load(j);
      }
      for (int j = n > kStages ? n - kStages : 0; j < n; ++j) {
        mbar_wait(&empty[j % kStages], (j / kStages) & 1);
        partial(j);
      }
      return;
    }
    const int w = warp - 1;
    for (int j = 0; j < n; ++j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      const float4* c4 = reinterpret_cast<const float4*>(stage(j));
      float sum = 0.0f;
      for (int v = w * 32 + lane; v < kBwTile / 4; v += kBwWarps * 32) {
        const float4 a = c4[v];
        sum += (a.x + a.y) + (a.z + a.w);
      }
      double d = sum;
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) {
        wsum[(j % kStages) * kBwWarps + w] = d;
        mbar_arrive(&empty[j % kStages]);
      }
    }
  } else {  // kBwOut
    if (warp == 0) {
      if (lane) return;
      for (int j = 0; j < n; ++j) {
        mbar_wait(&full[j % kStages], (j / kStages) & 1);
        store(j);
        // Tile j + 1 reuses tile j + 1 - kStages's stage: release it to the
        // writers once that store (kStages - 1 groups back) has read it.
        if (j + 1 >= kStages && j + 1 < n) {
          bulk_wait_read<kStages - 1>();
          mbar_arrive(&empty[(j + 1) % kStages]);
        }
      }
      bulk_wait_read<0>();
      return;
    }
    const int w = warp - 1;
    for (int j = 0; j < n; ++j) {
      if (j >= kStages) mbar_wait(&empty[j % kStages], (j / kStages - 1) & 1);
      const float base = (float)(tile(j) / per_step * kBwTile);
      float4* d4 = reinterpret_cast<float4*>(stage(j));
      for (int v = w * 32 + lane; v < kBwTile / 4; v += kBwWarps * 32) {
        const float i = (float)(4 * v);
        d4[v] = make_float4(base + i, base + i + 1.0f, base + i + 2.0f,
                            base + i + 3.0f);
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[j % kStages]);
    }
  }
}

// sums[s] = the tile partials of step s, in tile order.
__global__ void bw_step_sums(const double* __restrict__ part,
                             double* __restrict__ sums, long long steps,
                             int per_step) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= steps) return;
  double t = 0.0;
  for (int k = 0; k < per_step; ++k) t += part[s * per_step + k];
  sums[s] = t;
}

// ctas = 0: as many as are resident at once (at most one a tile).
template <int kMode, int kSplit, int kStages, bool kStrided = kBwStrided>
int launch_bw(const float* x, float* y, double* aux, long long steps,
              int rows, int ctas, cudaStream_t st) {
  auto kernel = bw_ring<kMode, kSplit, kStages, kStrided>;
  constexpr size_t sm = bw_smem(kStages);
  cudaError_t err = allow_smem({{kernel, sm}});
  if (err == cudaSuccess && ctas == 0)
    err = resident_ctas(kernel, bw_threads(kMode), sm, &ctas);
  if (err != cudaSuccess) return err;
  const int per_step = rows / kBwTileRows;
  const long long tiles = steps * per_step;
  if (ctas > tiles) ctas = (int)tiles;
  // `in`: aux holds sums [steps] then the tile partials [tiles].
  double* part = kMode == kBwIn ? aux + steps : nullptr;
  bw_ring<kMode, kSplit, kStages, kStrided><<<ctas, bw_threads(kMode), sm, st>>>(
      x, y, part, tiles, per_step);
  if constexpr (kMode == kBwIn)
    bw_step_sums<<<(unsigned)((steps + 127) / 128), 128, 0, st>>>(
        part, aux, steps, per_step);
  return cudaGetLastError();
}

template <int kSplit>
int run_bw(const float* x, float* y, double* aux, long long steps, int rows,
           int mode, cudaStream_t st) {
  switch (mode) {
    case kBwNone:
      bw_none<<<(unsigned)steps, kThreads, 0, st>>>(y);
      return cudaGetLastError();
    case kBwIn:
      return launch_bw<kBwIn, kSplit, kBwStages>(x, y, aux, steps, rows, 0, st);
    case kBwOut:
      return launch_bw<kBwOut, kSplit, kBwStages>(x, y, aux, steps, rows, 0, st);
    case kBwBoth:
      return launch_bw<kBwBoth, kSplit, kBwStages>(x, y, aux, steps, rows, 0, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------- copy-floor variants

constexpr int kLog = 9;             // N1 = N2 = 512: B = 2^18
constexpr int kSide = 1 << kLog;
constexpr size_t kB = (size_t)kSide * kSide;

// Pass 1's memory pattern: pair blockIdx.y, columns [c0, c0 + kTc) of its
// two blocks gathered into a shared tile, then stored to the scratch
// column-strided (kStrided) or as one contiguous run.
template <int kTc, bool kStrided, bool kVec>
__global__ void __launch_bounds__(kThreads)
cf_gather(const float* __restrict__ x, Cx<float>* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<float>* s = reinterpret_cast<Cx<float>*>(smem_raw);
  const float* x0 = x + (size_t)blockIdx.y * 2 * kB;
  const float* x1 = x0 + kB;
  Cx<float>* out = scratch + (size_t)blockIdx.y * kB;
  const int c0 = blockIdx.x * kTc;
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSide * kTc / 4; i += blockDim.x) {
      const int row = i / (kTc / 4), q = 4 * (i % (kTc / 4));
      const size_t n = (size_t)row * kSide + c0 + q;
      const float4 a = *reinterpret_cast<const float4*>(x0 + n);
      const float4 b = *reinterpret_cast<const float4*>(x1 + n);
      float4* d = reinterpret_cast<float4*>(s + row * kTc + q);
      d[0] = make_float4(a.x, b.x, a.y, b.y);
      d[1] = make_float4(a.z, b.z, a.w, b.w);
    }
  } else {
    for (int i = threadIdx.x; i < kSide * kTc; i += blockDim.x) {
      const int row = i / kTc, w = i % kTc;
      const size_t n = (size_t)row * kSide + c0 + w;
      s[i] = {x0[n], x1[n]};
    }
  }
  __syncthreads();
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSide * kTc / 2; i += blockDim.x) {
      const int e = 2 * i, pos = e / kTc, w = e % kTc;
      const size_t at = kStrided ? (size_t)pos * kSide + c0 + w
                                 : (size_t)c0 * kSide + e;
      *reinterpret_cast<float4*>(out + at) =
          *reinterpret_cast<const float4*>(s + e);
    }
  } else {
    for (int i = threadIdx.x; i < kSide * kTc; i += blockDim.x) {
      const int pos = i / kTc, w = i % kTc;
      const size_t at = kStrided ? (size_t)pos * kSide + c0 + w
                                 : (size_t)c0 * kSide + i;
      out[at] = s[i];
    }
  }
}

// Pass 3's memory pattern, the inverse of cf_gather.
template <int kTc, bool kStrided, bool kVec>
__global__ void __launch_bounds__(kThreads)
cf_scatter(const Cx<float>* __restrict__ scratch, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<float>* s = reinterpret_cast<Cx<float>*>(smem_raw);
  const Cx<float>* in = scratch + (size_t)blockIdx.y * kB;
  float* y0 = y + (size_t)blockIdx.y * 2 * kB;
  float* y1 = y0 + kB;
  const int c0 = blockIdx.x * kTc;
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSide * kTc / 2; i += blockDim.x) {
      const int e = 2 * i, pos = e / kTc, w = e % kTc;
      const size_t at = kStrided ? (size_t)pos * kSide + c0 + w
                                 : (size_t)c0 * kSide + e;
      *reinterpret_cast<float4*>(s + e) =
          *reinterpret_cast<const float4*>(in + at);
    }
  } else {
    for (int i = threadIdx.x; i < kSide * kTc; i += blockDim.x) {
      const int pos = i / kTc, w = i % kTc;
      const size_t at = kStrided ? (size_t)pos * kSide + c0 + w
                                 : (size_t)c0 * kSide + i;
      s[i] = in[at];
    }
  }
  __syncthreads();
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSide * kTc / 4; i += blockDim.x) {
      const int row = i / (kTc / 4), q = 4 * (i % (kTc / 4));
      const size_t n = (size_t)row * kSide + c0 + q;
      const float4 d0 = *reinterpret_cast<const float4*>(s + row * kTc + q);
      const float4 d1 = *reinterpret_cast<const float4*>(s + row * kTc + q + 2);
      *reinterpret_cast<float4*>(y0 + n) = make_float4(d0.x, d0.z, d1.x, d1.z);
      *reinterpret_cast<float4*>(y1 + n) = make_float4(d0.y, d0.w, d1.y, d1.w);
    }
  } else {
    for (int i = threadIdx.x; i < kSide * kTc; i += blockDim.x) {
      const int row = i / kTc, w = i % kTc;
      const size_t n = (size_t)row * kSide + c0 + w;
      y0[n] = s[i].re;
      y1[n] = s[i].im;
    }
  }
}

// No tile: one element per thread, pair blockIdx.y.
__global__ void __launch_bounds__(kThreads)
cf_flat_gather(const float* __restrict__ x, Cx<float>* __restrict__ scratch) {
  const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* x0 = x + (size_t)blockIdx.y * 2 * kB;
  scratch[(size_t)blockIdx.y * kB + n] = {x0[n], x0[kB + n]};
}

__global__ void __launch_bounds__(kThreads)
cf_flat_scatter(const Cx<float>* __restrict__ scratch, float* __restrict__ y) {
  const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Cx<float> v = scratch[(size_t)blockIdx.y * kB + n];
  float* y0 = y + (size_t)blockIdx.y * 2 * kB;
  y0[n] = v.re;
  y0[kB + n] = v.im;
}

// ------------------------------------------- the cluster-resident plane

// A plane of kC CTAs: each holds a slab of kSide / kC rows. kC = 8: 128 KB
// and 1024 threads a CTA, one CTA a SM; kC = 16 (non-portable): 64 KB and
// 512 threads, two CTAs a SM. Either way a thread stages 8 float4.
template <int kC>
struct Plane {
  static constexpr int kRows = kSide / kC;            // slab rows, band columns
  static constexpr int kRow4 = kRows / 4;             // float4 of a band row
  static constexpr int kBlock4 = kRows * kRows / 4;   // float4 of a block (p, r)
  static constexpr int kThreads = kC == 8 ? 1024 : 512;
  static constexpr int kGroups = kThreads / kBlock4;  // peers read at once
  static constexpr int kPerThread = kC / kGroups;     // = 8
  static constexpr unsigned kSlabBytes = kRows * kSide * sizeof(float);
  static constexpr size_t kSmem = kSlabBytes + 16;    // the slab, one mbarrier
  static_assert(kThreads % kBlock4 == 0 && kPerThread == 8, "layout");
};

// Plane blockIdx.x / kC of x (pairs x 2 real [512, 512] planes) to y. CTA r
// holds slab r (rows [R r, R r + R), [R][128] float4, R = kSide / kC), then
// band r (columns [R r, R r + R) of every row, [512][R / 4] float4), then
// slab r again. Thread t = g * kBlock4 + e moves, in round K = kGroups k
// + g, element (lr, q) = (e / (R / 4), e % (R / 4)) of the R x R block it
// shares with peer p = (r + K) % kC.
template <int kC>
__global__ void __launch_bounds__(Plane<kC>::kThreads, kC == 8 ? 1 : 2)
cf_cluster(const float* __restrict__ x, float* __restrict__ y) {
  using P = Plane<kC>;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* own = reinterpret_cast<float4*>(smem);
  Bar* bar = reinterpret_cast<Bar*>(smem + P::kSlabBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const size_t at = (size_t)(blockIdx.x / kC) * kB +
                    (size_t)r * P::kRows * kSide;
  const int t = threadIdx.x, g = t / P::kBlock4, e = t % P::kBlock4;
  const int lr = e / P::kRow4, q = e % P::kRow4;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, P::kSlabBytes);
    bulk_load(own, x + at, P::kSlabBytes, bar);
  }
  mbar_wait(bar, 0);
  cluster.sync();  // every slab of the plane has landed
  float4 v[P::kPerThread];
  // First transpose: block (p, r), row lr of peer p's slab.
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k) {
    const int p = (r + P::kGroups * k + g) % kC;
    v[k] = cluster.map_shared_rank(own, p)[lr * (kSide / 4) + r * P::kRow4 + q];
  }
  cluster.sync();  // no peer reads this slab any more
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k)  // band row R p + lr
    own[((r + P::kGroups * k + g) % kC) * P::kBlock4 + e] = v[k];
  cluster.sync();  // every band is written
  // Second transpose: block (r, p), band row R r + lr of peer p.
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k) {
    const int p = (r + P::kGroups * k + g) % kC;
    v[k] = cluster.map_shared_rank(own, p)[r * P::kBlock4 + e];
  }
  cluster.sync();  // no peer reads this band any more
#pragma unroll
  for (int k = 0; k < P::kPerThread; ++k)
    own[lr * (kSide / 4) + ((r + P::kGroups * k + g) % kC) * P::kRow4 + q] = v[k];
  fence_async_shared();
  __syncthreads();
  if (t == 0) {
    bulk_store(y + at, own, P::kSlabBytes);
    bulk_commit();
  }
  cluster.sync();  // no CTA exits while a peer might still read it
  if (t == 0) bulk_wait_read<0>();
}

template <int kC>
cudaLaunchConfig_t cluster_config(long long planes, cudaLaunchAttribute* attr,
                                  cudaStream_t st) {
  return cluster_launch_config((unsigned)(planes * kC), Plane<kC>::kThreads,
                               Plane<kC>::kSmem, kC, attr, st);
}

// cudaOccupancyMaxActiveClusters of cf_cluster<kC>.
template <int kC>
cudaError_t cluster_occupancy(int* clusters) {
  return max_active_clusters(cf_cluster<kC>, kC, Plane<kC>::kThreads,
                             Plane<kC>::kSmem, clusters);
}

template <int kC>
int run_cluster(const float* x, float* y, long long pairs, cudaStream_t st) {
  int clusters = 0;
  cudaError_t err = cluster_occupancy<kC>(&clusters);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<kC>(2 * pairs, &attr, st);
  err = cudaLaunchKernelEx(&cfg, cf_cluster<kC>, x, y);
  return err != cudaSuccess ? err : cudaGetLastError();
}

enum CopyVariant {
  kCfPassthru = 0, kCf1buf = 1, kCfCopy = 2, kCfTr = 3, kCfNotiles = 4,
  kCfHint = 5, kCfLt256 = 6, kCfLt512 = 7, kCfCluster = 8, kCfCluster16 = 9,
};

// Gather, optional row round trip, scatter.
template <int kTc, bool kStrided, bool kVec>
int tiled_copy(const float* x, float* y, Cx<float>* sc, long long pairs,
               bool rows, cudaStream_t st) {
  const size_t sm = (size_t)kTc * kSide * sizeof(Cx<float>);
  using S = Split<kLog, kLog>;
  using RW = Rows<float, S>;
  cudaError_t err = allow_smem({{cf_gather<kTc, kStrided, kVec>, sm},
                                {cf_scatter<kTc, kStrided, kVec>, sm},
                                {rows_multiply<float, S, kRowsCopy>,
                                 RW::kSmem}});
  if (err != cudaSuccess) return err;
  const dim3 gc(kSide / kTc, (unsigned)pairs);
  cf_gather<kTc, kStrided, kVec><<<gc, kThreads, sm, st>>>(x, sc);
  if (rows) {
    const dim3 gr(kSide / RW::kR, (unsigned)pairs);
    rows_multiply<float, S, kRowsCopy><<<gr, RW::kThreads, RW::kSmem, st>>>(
        sc, nullptr, nullptr);
  }
  cf_scatter<kTc, kStrided, kVec><<<gc, kThreads, sm, st>>>(sc, y);
  return cudaGetLastError();
}

int run_copy_floor(const float* x, float* y, Cx<float>* sc, long long pairs,
                   int variant, cudaStream_t st) {
  switch (variant) {
    case kCfPassthru: {
      const long long per = (long long)(2 * kB / 4);
      passthru<<<dim3(kPassCtas, (unsigned)pairs), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
          per);
      return cudaGetLastError();
    }
    case kCf1buf: return tiled_copy<16, true, false>(x, y, sc, pairs, false, st);
    case kCfCopy: return tiled_copy<16, false, false>(x, y, sc, pairs, true, st);
    case kCfTr: return tiled_copy<16, true, false>(x, y, sc, pairs, true, st);
    case kCfHint: return tiled_copy<16, false, true>(x, y, sc, pairs, true, st);
    case kCfLt256: return tiled_copy<32, false, false>(x, y, sc, pairs, true, st);
    case kCfLt512: return tiled_copy<8, false, false>(x, y, sc, pairs, true, st);
    case kCfNotiles: {
      const dim3 g((unsigned)(kB / kThreads), (unsigned)pairs);
      cf_flat_gather<<<g, kThreads, 0, st>>>(x, sc);
      cf_flat_scatter<<<g, kThreads, 0, st>>>(sc, y);
      return cudaGetLastError();
    }
    case kCfCluster: return run_cluster<8>(x, y, pairs, st);
    case kCfCluster16: return run_cluster<16>(x, y, pairs, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes), one signature for the family:
// (x, y, aux, a, b, c, mode, stream). Each launches on `stream`, allocates
// nothing, does not synchronize, and returns the launch error.

// Launches nothing else: the launch floor.
extern "C" int lowcut_probe_empty(const void*, void*, void*, long long,
                                  long long, long long, int, void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// x, y: [nblk = a, 2, 512, 512] float32.
extern "C" int lowcut_probe_passthru(const void* x, void* y, void*,
                                     long long nblk, long long, long long, int,
                                     void* stream) {
  passthru<<<dim3(kPassCtas, (unsigned)nblk), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y),
      (long long)(2 * kB / 4));
  return cudaGetLastError();
}

// x: [steps = a, rows = b, 512] float32 (rows a multiple of 16); split = c
// (1 or 4); mode 0 none, 1 in, 2 out, 3 both; y as the mode says; aux (in):
// float64 [steps + steps * rows / 16], the sums then the tile partials.
extern "C" int lowcut_probe_bw(const void* x, void* y, void* aux,
                               long long steps, long long rows,
                               long long split, int mode, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  double* ad = static_cast<double*>(aux);
  if (rows % kBwTileRows) return cudaErrorInvalidValue;
  if (split == 1) return run_bw<1>(xf, yf, ad, steps, (int)rows, mode, st);
  if (split == 4) return run_bw<4>(xf, yf, ad, steps, (int)rows, mode, st);
  return cudaErrorInvalidValue;
}

// `both` at split 1 through ring `variant` = mode (0-2: 2, 4 or 6 stages
// with the strided walk; 3: 4 stages with the contiguous one) on `ctas` =
// c CTAs (0: as many as are resident); x, y as lowcut_probe_bw.
extern "C" int lowcut_probe_bw_ring(const void* x, void* y, void*,
                                    long long steps, long long rows,
                                    long long ctas, int variant, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (rows % kBwTileRows || ctas < 0 || ctas > (1 << 20))
    return cudaErrorInvalidValue;
  const int r = (int)rows, c = (int)ctas;
  switch (variant) {
    case 0: return launch_bw<kBwBoth, 1, 2, true>(xf, yf, nullptr, steps, r, c, st);
    case 1: return launch_bw<kBwBoth, 1, 4, true>(xf, yf, nullptr, steps, r, c, st);
    case 2: return launch_bw<kBwBoth, 1, 6, true>(xf, yf, nullptr, steps, r, c, st);
    case 3: return launch_bw<kBwBoth, 1, 4, false>(xf, yf, nullptr, steps, r, c, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, y: [pairs = a, 2, 512, 512] float32; scratch (aux): [pairs, 2^18]
// complex64 (unused by `cluster`); variant = mode (CopyVariant).
extern "C" int lowcut_probe_copy_floor(const void* x, void* y, void* scratch,
                                       long long pairs, long long, long long,
                                       int variant, void* stream) {
  return run_copy_floor(static_cast<const float*>(x), static_cast<float*>(y),
                        static_cast<Cx<float>*>(scratch), pairs, variant,
                        static_cast<cudaStream_t>(stream));
}

// out (y): int [2], cudaOccupancyMaxActiveClusters of the cluster
// variants: 8 CTAs of 128 KB (cluster), 16 of 64 KB (cluster16).
extern "C" int lowcut_probe_cluster_occupancy(const void*, void* out, void*,
                                              long long, long long, long long,
                                              int, void*) {
  int* n = static_cast<int*>(out);
  cudaError_t err = cluster_occupancy<8>(&n[0]);
  return err != cudaSuccess ? err : cluster_occupancy<16>(&n[1]);
}
