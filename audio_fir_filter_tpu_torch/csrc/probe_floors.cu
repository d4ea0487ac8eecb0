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
//     :123): double-buffered HBM <-> VMEM DMA. Here: `bw`, one CTA per
//     step of x [steps, rows, 512]; each step streams its rows through two
//     32 KB shared-memory stages with cp.async, `split` commit groups per
//     stage (the counterpart of the DMA chunking). Modes:
//       both  global -> shared -> global: y = x;
//       in    global -> shared only: sums[step] = the step's sum (float64);
//       out   shared -> global only: y[step, r, c] = step * 8192
//             + (r % 16) * 512 + c, from a pattern written once to shared;
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

#include <cuda_runtime.h>

#include "fourstep.cuh"

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
constexpr int kBwNone = 0, kBwIn = 1, kBwOut = 2, kBwBoth = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage's loads, as kSplit commit groups.
template <int kSplit>
__device__ void issue_stage(float* buf, const float* src) {
  constexpr int per = kBwTile / 4 / kSplit;  // float4 per group
  for (int g = 0; g < kSplit; ++g) {
    for (int i = threadIdx.x; i < per; i += blockDim.x) {
      const int v = 4 * (g * per + i);
      cp_async16(buf + v, src + v);
    }
    cp_commit();
  }
}

template <int kMode, int kSplit>
__global__ void __launch_bounds__(kThreads)
bw(const float* __restrict__ x, float* __restrict__ y,
   double* __restrict__ sums, int rows) {
  extern __shared__ __align__(16) float buf[];  // 2 stages of kBwTile
  const int step = blockIdx.x;
  const int stages = rows / kBwTileRows;
  const size_t base = (size_t)step * rows * kBwCols;
  if constexpr (kMode == kBwNone) {
    for (int i = threadIdx.x; i < 8 * kBwCols; i += blockDim.x)
      y[(size_t)step * 8 * kBwCols + i] = 1.0f;
    return;
  }
  if constexpr (kMode == kBwOut) {
    for (int i = threadIdx.x; i < kBwTile; i += blockDim.x)
      buf[i] = static_cast<float>(step * kBwTile + i);
    __syncthreads();
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    for (int k = 0; k < stages; ++k) {
      float4* y4 = reinterpret_cast<float4*>(y + base + (size_t)k * kBwTile);
      for (int v = threadIdx.x; v < kBwTile / 4; v += blockDim.x) y4[v] = b4[v];
    }
    return;
  }
  double acc = 0.0;
  issue_stage<kSplit>(buf, x + base);
  for (int k = 0; k < stages; ++k) {
    const float* cur = buf + (k & 1) * kBwTile;
    if (k + 1 < stages) {
      issue_stage<kSplit>(buf + ((k + 1) & 1) * kBwTile,
                          x + base + (size_t)(k + 1) * kBwTile);
      cp_wait<kSplit>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float4* c4 = reinterpret_cast<const float4*>(cur);
    if constexpr (kMode == kBwBoth) {
      float4* y4 = reinterpret_cast<float4*>(y + base + (size_t)k * kBwTile);
      for (int v = threadIdx.x; v < kBwTile / 4; v += blockDim.x) y4[v] = c4[v];
    } else {
      float part = 0.0f;
      for (int v = threadIdx.x; v < kBwTile / 4; v += blockDim.x) {
        const float4 a = c4[v];
        part += (a.x + a.y) + (a.z + a.w);
      }
      acc += part;
    }
    __syncthreads();  // the next issue overwrites this stage's buffer
  }
  if constexpr (kMode == kBwIn) {
    __shared__ double warp_sums[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
      sums[step] = t;
    }
  }
}

template <int kMode, int kSplit>
int launch_bw(const float* x, float* y, double* sums, long long steps,
              int rows, cudaStream_t st) {
  const size_t sm = 2 * kBwTile * sizeof(float);
  cudaError_t err = smem_limit(bw<kMode, kSplit>, sm);
  if (err != cudaSuccess) return err;
  bw<kMode, kSplit><<<(unsigned)steps, kThreads, sm, st>>>(x, y, sums, rows);
  return cudaGetLastError();
}

template <int kSplit>
int run_bw(const float* x, float* y, double* sums, long long steps, int rows,
           int mode, cudaStream_t st) {
  switch (mode) {
    case kBwNone: return launch_bw<kBwNone, kSplit>(x, y, sums, steps, rows, st);
    case kBwIn: return launch_bw<kBwIn, kSplit>(x, y, sums, steps, rows, st);
    case kBwOut: return launch_bw<kBwOut, kSplit>(x, y, sums, steps, rows, st);
    case kBwBoth: return launch_bw<kBwBoth, kSplit>(x, y, sums, steps, rows, st);
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

enum CopyVariant {
  kCfPassthru = 0, kCf1buf = 1, kCfCopy = 2, kCfTr = 3, kCfNotiles = 4,
  kCfHint = 5, kCfLt256 = 6, kCfLt512 = 7,
};

// Gather, optional row round trip, scatter.
template <int kTc, bool kStrided, bool kVec>
int tiled_copy(const float* x, float* y, Cx<float>* sc, long long pairs,
               bool rows, cudaStream_t st) {
  const size_t sm = (size_t)kTc * kSide * sizeof(Cx<float>);
  cudaError_t err = smem_limit(cf_gather<kTc, kStrided, kVec>, sm);
  if (err == cudaSuccess) err = smem_limit(cf_scatter<kTc, kStrided, kVec>, sm);
  using S = Split<kLog, kLog>;
  using RW = Rows<float, S>;
  if (err == cudaSuccess)
    err = smem_limit(rows_multiply<float, S, kRowsCopy>, RW::kSmem);
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
// (1 or 4); mode 0 none, 1 in, 2 out, 3 both; y and sums (aux, [steps]
// float64) as the mode says.
extern "C" int lowcut_probe_bw(const void* x, void* y, void* sums,
                               long long steps, long long rows,
                               long long split, int mode, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  double* sd = static_cast<double*>(sums);
  if (rows % kBwTileRows) return cudaErrorInvalidValue;
  if (split == 1) return run_bw<1>(xf, yf, sd, steps, (int)rows, mode, st);
  if (split == 4) return run_bw<4>(xf, yf, sd, steps, (int)rows, mode, st);
  return cudaErrorInvalidValue;
}

// x, y: [pairs = a, 2, 512, 512] float32; scratch (aux): [pairs, 2^18]
// complex64; variant = mode (CopyVariant).
extern "C" int lowcut_probe_copy_floor(const void* x, void* y, void* scratch,
                                       long long pairs, long long, long long,
                                       int variant, void* stream) {
  return run_copy_floor(static_cast<const float*>(x), static_cast<float*>(y),
                        static_cast<Cx<float>*>(scratch), pairs, variant,
                        static_cast<cudaStream_t>(stream));
}
