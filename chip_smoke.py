#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero and prints no
result line):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; a CUDA card is required;
2. build: one nvcc per kernel source (segment filter, block convolution,
   and the probes' floors, phases, stages and segment ablations), all
   started together, from the checkout;
3. segment kernel vs its plain PyTorch version on the card at the main
   path's shapes (2 channels, 30 s of audio, B = 2^18): high (M = 38,400 at
   96 kHz), fast (M = 38,400) and i16 (M = 17,640 at 44.1 kHz) — error,
   peak, launch count, the ``kernels`` count held against the kernels the
   entry point launched in a ``torch.profiler`` trace of the call (the
   passes that ran on the card, as far as the trace kept them, may not
   exceed it), and median device times
   (CUDA events around each call queued behind a sleep kernel,
   ``experiments/_probe.event_ms``); the three passes' occupancy at
   B = 2^18 in each mode, and in f64 at B = 2^19 (the 1024 x 512 split of
   M = 76,800) (ring depth, CTAs per SM, registers), which must have no
   local (stack or spill) bytes (passes 1 and 3, and pass 2 in f64), pass
   2 a ring of 2 at four CTAs of 128 threads an SM in f64 and none in f32
   and i16, pass 3 the ring of ``PASS3_F64_RING`` at one CTA of 512
   threads an SM in f64 and none in f32 and i16; each mode's four-step
   twiddle layout at B = 2^18 and 2^19 (the full table, or two factor
   tables where it would exceed 4 MiB), failing where the library's
   compile-time rule and
   ``kernel_tables``' rule disagree at any B = 2^2 .. 2^26; the long
   filter at 1024 x 512 in f64 (factored twiddle): the segment kernel
   through ``same_filter_peak`` and the block kernel against their plain
   versions within 1 LSB@24, the call's launch span at 10x9;
4. a float64 direct-convolution oracle on excerpts (head, a block seam,
   tail) of the phase-3 kernel outputs; then kernel vs plain version at
   small edge shapes (B 256-2048, 1-3 channels, halo-extended input), and
   at every B = 2^k, k = 2 .. 26 (2 channels, 3 taps up to B = 256, 201
   above), so every compiled side 2^1 .. 2^13 runs as N1 and as N2;
5. block-convolution kernel vs its plain version at the block path's shape
   for the same 2 x 30 s at 96 kHz (M = 38,400, B = 2^18: blocks
   [28, 2^18]), f64 and f32, over full blocks — error, launch and
   ``kernels`` counts and median device times as in phase 3, and the
   passes' occupancy; then small
   edge shapes (B 256-2048, nb 2-6), every B = 2^k, k = 2 .. 26 (nb = 2),
   and the whole block path at T = 201, B = 256;
6. the main path through the CLI entry point, in-process: (a) a 10-minute
   96 kHz stereo 24-bit WAV with a metadata chunk (auto -> high, several
   segments), (b) a 5-minute 44.1 kHz stereo 16-bit WAV (the 16-bit-native
   route), (c) a loud 16-bit WAV that saturates, falls back to float32 and
   auto-normalizes. Launch counters are zeroed before (a) and read after
   (c), the launch spans recorded; every segment-kernel mode must have
   launched, one span a launch, each with its pass-2 ring depth (2 in
   f64, 0 in f32 and i16) and its pass-3 ring depth (``PASS3_F64_RING``'s
   in f64, 0 in f32 and i16), none at a split whose twiddle is
   factored (``twiddle_layout``); then (a) with the long filter (``-f 10
   -s 5``, B = 2^19): every launch f64, its span at 10x9 with its pass-3
   ring, where the twiddle is factored, oracle excerpts within 1 LSB@24;
7. the block path through the CLI, ``--engine fourstep``, on files (a)
   and (b): oracle excerpts, metadata, no 16-bit route; counters zeroed
   before and read after, both block-kernel modes must have launched and
   the segment kernel never;
8. the batch scenario through the CLI with ``--resume`` into a new
   directory: (a), (b), (c) and a 1-minute 48 kHz 24-bit AIFF (d). Each
   output equals its single-file output sample for sample and the launch
   counts equal the single-file runs' sum; a ``--resume`` rerun launches
   nothing and leaves the outputs' bytes as they were; a batch with a
   missing file in the middle exits 1 with exactly the files before it
   written and listed in the manifest, and its ``--resume`` rerun, with
   the file present, filters only the rest (the launch counts show it);
9. the probes of ``audio_fir_filter_tpu_torch/experiments/`` (the card
   counterparts of the TPU probes in ``experiments/``): each probe kernel
   against its plain version (bitwise for the copies, the zero and shift
   variants, the stated tolerance otherwise), then, with the launch
   counters zeroed before and read after, each probe's sweep through its
   ``run`` entry point, printing the decomposition tables; every probe
   kernel must have launched. ``fast_decomp_r05`` holds the segment
   kernel's seven ablation variants (``csrc/probe_segment.cu``) each
   against its plain version at 2 x 30 s, then times them at the bench's
   headline and fast16 shapes and at 2 x 30 s (failing a variant that
   beats its own traffic at 3.35 TB/s where the scratch streams through
   device memory), holds ``full`` bitwise against the shipped kernel at
   the headline, and times the shipped passes there under
   ``torch.profiler``. The two floor kernels redesigned for Hopper are
   checked bitwise everywhere they run: ``bw`` (TMA bulk copies through an
   ``mbarrier`` ring) in every mode and split at rows 512, 1024 and 2048,
   and the copy floor's ``cluster`` variant (one plane per thread-block
   cluster, both transposes through distributed shared memory) at 8 and
   1008 pairs; the cluster occupancy is printed and must be > 0. The
   512-point chain redesigned for Hopper (``probe_stages.cu``
   ``ring_chain``: a persistent grid of tensor-map-fed rings, the
   ``probe_stages`` and ``probe_stages2`` rows as ``fwd ring`` and ``fwd
   ring r8``) is held against its plain version at [8, 512, 512] and
   [256, 512, 512], its ``ptxas`` line must show no stack frame and no
   spill, and both stage sweeps print their tables at both batches. The
   fused block redesigned for Hopper (``probe_phases.cu`` ``fused_block``:
   one thread-block cluster holds a 2^18 block from its one read to its one
   write, the ``probe_phases`` rows) is held in all five TPU-probe variants
   against their plain versions at 128 and 2016 blocks; each mode's
   active-cluster count is printed and must be > 0, and its ``ptxas`` line
   must show no stack frame and no spill;
10. the bench contract as a user runs it, ``python3 -m
   audio_fir_filter_tpu_torch.bench`` in subprocesses: ``--fidelity
   --roofline --all --reps 3``, then ``--engine fourstep --reps 3``. Each
   exits 0 with one JSON stdout line (value > 0), the fidelity gate passes,
   every timed run's output was held against the float64 oracle at the
   timed shape, and each run's launch report names its kernels; the
   reports are printed;
11. ``--profile DIR`` through the CLI on file (a), counters zeroed before
   and read after: the Chrome trace exists and names the segment kernel's
   passes (``cols_forward``, ``rows_multiply``, ``cols_inverse``), and each
   ``lowcut.segment.launch`` span in it holds as many kernel launches as
   its call's ``kernels`` count; then
   file (a)'s samples through ``filter_array_streamed`` under
   ``torch.profiler`` in a ``record_function`` window: every host<->device
   copy in it is a pinned one, and the device's busy share over the window
   (the union of kernel and copy intervals) is printed, beside the
   synchronous per-segment loop's.

12. the mesh (``audio_fir_filter_tpu_torch/parallel``), counters zeroed
   before and read after each part: ``--mesh 1x1`` through the CLI on (a)
   and (b), byte-identical to phase 6's outputs with equal launch counts;
   through the API, meshes (1, 2), (1, 4) and (2, 2) with every cell on
   the one card at full width (2 channels, 96 kHz, M = 38,400, B = 2^18;
   ``high`` and ``fast``, and the block path once) against the unsharded
   port and float64 oracle excerpts across every shard seam, the peak
   equal to the unsharded peak, edge halos chaining two segments, and file
   (a)'s samples through ``sharded_filter_streamed``; an NCCL group of
   world size 1 in a subprocess (``sharded_filter`` on the default (1, 1)
   mesh, ``all_reduce(MAX)``); two processes that share the card in a gloo
   group (file rendezvous), one cell of a (1, 2) mesh each, halos staged
   through the host, each shard against the oracle; a 2-process batch of
   (a)-(d) through the CLI (``--coordinator`` on localhost), a disjoint
   cover whose outputs equal the single-file outputs byte for byte;
   ``bench --scaling`` in a subprocess (the model's table parsed, the
   measured halo cost printed); and ``--mesh 1x2`` through the CLI, which
   exits 1 naming 2 devices against 1.
13. the segment pipeline (``pipeline/stream``: one segment in flight,
   pinned buffers, ``non_blocking`` copies, events): each streamed route
   byte-identical to the synchronous per-segment loop it replaced, peaks
   and launch counts equal, on file (a) at the default segment, at 6 hops
   (dozens of segments) and at 6 hops with a ``torch.cuda._sleep`` queued
   before every launch; file (b) on the 16-bit route (default and 6 hops,
   delayed); ``--engine fourstep`` f64 on (a) and f32 on (b); a (1, 2) mesh
   of ``cuda:0`` cells on (a). Then the medians of three interleaved runs
   of each of (a) and (b) pipelined and synchronous, the device memory
   peak of each on (a), and the pinned buffers' allocation time in a fresh
   process.
14. the breakdown scripts of ``audio_fir_filter_tpu_torch/experiments/``,
   counters zeroed before and read after: ``segment_decomp`` (the
   headline call stage by stage on both engines, the block path's stages
   bitwise against its whole call), ``chunk_sweep`` (the block kernel on
   8-64 real blocks and the block path's headline call at each
   ``conv_chunk``, beside the segment kernel), both engines' kernels must
   have launched; then ``batch_cfg4``, the 64-file batch through
   ``bin/lowcut-torch`` in a subprocess (exit 0, 64 outputs, a metrics line
   each). Their tables are printed.

The build phase also checks that the native PCM codec loaded (its g++
build), so the host codec of phases 6-12 is the native one.

``--skip 3,4,5,7,9,10,11,12,14`` (any of them) leaves phases out while a
change is being worked on; such a run prints no result line.

Output: the phase reports, then a JSON line of per-kernel results (each
row with its launches on its path, error against its plain version, its
time, the plain version's, its roofline bound from ``ops/roofline``, and
the one PyTorch library call's time where there is one), then the last
line {"ok": true, "device": {...}}. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# The ulp-relative gate: max |a - b| in LSBs at ``bits``, relative to the
# output's binade above full scale.
from audio_fir_filter_tpu_torch.ops.oracle import (  # noqa: E402
    max_scaled_lsb_error as scaled_lsb_error)

SEED = 20261016
SEGMENT_SOURCE = "audio_fir_filter_tpu_torch/csrc/segment_filter.cu"
SEGMENT_REPLACES = "audio_fir_filter_tpu/ops/pallas_fft.py:753"
CONV_SOURCE = "audio_fir_filter_tpu_torch/csrc/conv_blocks.cu"
CONV_REPLACES = "audio_fir_filter_tpu/ops/pallas_fft.py:986"
_CSRC = "audio_fir_filter_tpu_torch/csrc/"
# Probe kernel rows: (source, the TPU probe it replaces).
PROBE_ROWS = {
    "probe_passthru": (_CSRC + "probe_floors.cu",
                       "experiments/dispatch_floor_probe.py:60"),
    "probe_bw": (_CSRC + "probe_floors.cu", "experiments/dma_bw_micro.py:31"),
    "probe_copy_floor": (_CSRC + "probe_floors.cu",
                         "experiments/copy_floor_probe.py:61"),
    **{f"probe_phases_{m}": (_CSRC + "probe_phases.cu",
                             "experiments/fused_phase_decomp.py:57")
       for m in ("f32", "f64")},
    **{f"probe_passes_{m}": (_CSRC + "probe_phases.cu",
                             "experiments/pallas_micro.py:41")
       for m in ("f32", "f64")},
    **{f"probe_stages_{m}": (_CSRC + "probe_stages.cu",
                             "experiments/mosaic_stages.py:65")
       for m in ("f32", "f64")},
    **{f"probe_stages2_{m}": (_CSRC + "probe_stages.cu",
                              "experiments/mosaic_stages2.py:50")
       for m in ("f32", "f64")},
    # The fused segment kernel's pallas_call under LOWCUT_ABLATE (:124-155).
    **{f"probe_segment_{m}": (_CSRC + "probe_segment.cu",
                              "audio_fir_filter_tpu/ops/pallas_fft.py:622")
       for m in ("f32", "f64", "i16")},
}
EXCERPT = 4096


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def oracle_excerpt(x: np.ndarray, taps: np.ndarray, i0: int, length: int):
    """Float64 direct 'same' convolution y[i0 : i0 + length] of one channel
    (x zero outside [0, N))."""
    mo2 = (len(taps) - 1) // 2
    lo, hi = i0 - mo2, i0 + length + mo2
    seg = np.zeros(hi - lo)
    s0, s1 = max(0, lo), min(len(x), hi)
    seg[s0 - lo : s1 - lo] = x[s0:s1]
    return np.convolve(seg, np.asarray(taps, np.float64)[::-1], mode="valid")


def excerpt_starts(n: int, seam: int) -> list[int]:
    return [0, max(0, min(n - EXCERPT, seam - EXCERPT // 2)), max(0, n - EXCERPT)]


# ----------------------------------------------------------------- phases

def phase_environment() -> dict:
    check(torch.cuda.is_available(),
          "no CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    return {"card": card}


def phase_build() -> None:
    from audio_fir_filter_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(force=True)
    for name in _build.FAMILIES:
        _build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.FAMILIES)} "
          f"sources in parallel (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in _build.FAMILIES:
        print(f"  ptxas {name}: "
              + _ptxas_summary((_build.BUILD_DIR / f"{name}.ptxas.log").read_text()))
    from audio_fir_filter_tpu_torch.native import pcm_codec

    check(pcm_codec.native_loaded(),
          "the native PCM codec did not load (its g++ build failed): the "
          "host codec fell back to NumPy")
    print(f"native PCM codec: loaded from {pcm_codec._SO}")


def _ptxas_kernels(log: str) -> list:
    """[mangled name, registers, stack bytes, spill-store bytes] of each
    kernel in a ``ptxas -v`` log."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append([m[1], 0, 0, 0])
        elif kernels and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            kernels[-1][2:] = [int(m[1]), int(m[2])]
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1][1] = int(m[1])
    return kernels


def _ptxas_summary(log: str) -> str:
    """One line from ``ptxas -v``: kernel count, register range, and each
    kernel with a stack frame (local memory: spills or an array the
    compiler could not keep in registers)."""
    kernels = _ptxas_kernels(log)
    if not kernels:
        return "no kernels"
    regs = [k[1] for k in kernels]
    local = []
    for name, _, stack, spill in kernels:
        if stack:
            m = re.search(r"\d+([a-z_]+)I(\w)\w*?SplitILi(\d+)ELi(\d+)E", name)
            short = f"{m[1]}<{m[2]}, 2^{m[3]} x 2^{m[4]}>" if m else name[:48]
            local.append(f"{short} {stack}/{spill}")
    return (f"{len(kernels)} kernels, {min(regs)}-{max(regs)} registers; "
            f"{len(local)} with a stack frame (stack/spill bytes)"
            + (": " + ", ".join(local) if local else ""))


def ring_chain_ptxas() -> str:
    """The ``ptxas`` line of ``probe_stages.cu``'s ``ring_chain`` kernels
    (types f32 / f64, output orders r2 / r8): registers, stack and spill
    bytes each. Fails on a stack frame or a spill: a thread's registers in
    local memory."""
    from audio_fir_filter_tpu_torch.ops import _build

    log = (_build.BUILD_DIR / "probe_stages.ptxas.log").read_text()
    ring = [k for k in _ptxas_kernels(log) if "ring_chain" in k[0]]
    check(len(ring) == 4, f"{len(ring)} ring_chain kernels in the ptxas log, "
          "want 4 (f32/f64 x r2/r8)")
    parts = []
    for name, regs, stack, spill in ring:
        m = re.search(r"ring_chainI(\w)Li(\d)E", name)
        tag = (f"{'f32' if m[1] == 'f' else 'f64'} {('r2', 'r8')[int(m[2])]}"
               if m else name[:40])
        parts.append(f"{tag} {regs} regs {stack}/{spill}")
        check(stack == 0 and spill == 0,
              f"ring_chain {tag}: {stack} bytes stack, {spill} spilled")
    return ("ptxas ring_chain (registers, stack/spill bytes): "
            + ", ".join(parts))


def fused_block_ptxas() -> str:
    """The ``ptxas`` line of ``probe_phases.cu``'s ``fused_block`` kernels
    (f32 / f64 x the five variants): registers, stack and spill bytes
    each. Fails on a stack frame or a spill."""
    from audio_fir_filter_tpu_torch.ops import _build

    log = (_build.BUILD_DIR / "probe_phases.ptxas.log").read_text()
    fused = [k for k in _ptxas_kernels(log) if "fused_block" in k[0]]
    check(len(fused) == 10, f"{len(fused)} fused_block kernels in the ptxas "
          "log, want 10 (f32/f64 x 5 variants)")
    names = ("full", "no_tr", "ac_only", "b_only", "copy")
    parts = []
    for name, regs, stack, spill in fused:
        m = re.search(r"fused_blockI(\w)Li(\d+)E", name)
        tag = (f"{'f32' if m[1] == 'f' else 'f64'} {names[int(m[2]) - 9]}"
               if m else name[:40])
        parts.append(f"{tag} {regs} regs {stack}/{spill}")
        check(stack == 0 and spill == 0,
              f"fused_block {tag}: {stack} bytes stack, {spill} spilled")
    return ("ptxas fused_block (registers, stack/spill bytes): "
            + ", ".join(sorted(parts)))


def _probe_modules() -> tuple:
    from audio_fir_filter_tpu_torch.experiments import (
        copy_floor_probe, dispatch_floor_probe, dma_bw_micro,
        fast_decomp_r05, fused_phase_decomp, mosaic_stages, mosaic_stages2,
        pallas_micro)

    return (dispatch_floor_probe, dma_bw_micro, copy_floor_probe,
            fused_phase_decomp, pallas_micro, mosaic_stages, mosaic_stages2,
            fast_decomp_r05)


def _zero_counts() -> None:
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    for counts in (sf.launches, cb.launches,
                   *(m.launches for m in _probe_modules())):
        for k in counts:
            counts[k] = 0


def _counts() -> dict:
    """Every kernel's launch count, by the kernels line's row name (the
    probes' counters are keyed so already)."""
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    out = {**{f"segment_filter_{k}": v for k, v in sf.launches.items()},
           **{f"conv_blocks_{k}": v for k, v in cb.launches.items()}}
    for m in _probe_modules():
        out.update(m.launches)
    return out


# The passes of the segment and block kernels' C loops, by kernel name.
PASSES = ("cols_forward", "rows_multiply", "cols_inverse", "pairs_forward",
          "pairs_inverse")


def _host_launches(events: list, span: str | None = None) -> list:
    """Trace us of every kernel launch the host made (CUDA runtime
    ``cudaLaunchKernel*`` events) in a Chrome trace, inside the events
    named ``span`` when given, one list per such event (all launches in
    one list when not)."""
    at = sorted(float(e["ts"]) for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaLaunchKernel"))
    if span is None:
        return [at]
    return [[a for a in at if t0 <= a <= t1]
            for t0, t1 in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                 for e in events if e.get("name") == span)]


def _device_passes(events: list) -> int | None:
    """Kernel passes (``PASSES``) that ran on the card in a Chrome trace;
    None when the trace holds no kernel at all. Late in a long process the
    profiler may keep only some of the card's kernel records (seen after
    phase 4), so this is a lower bound."""
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return None
    return sum(any(p in k for p in PASSES) for k in kernels)


def _traced_passes(fn, span: str | None = None):
    """``fn()``'s result, the kernels the host launched for it (inside the
    trace events ``span`` when given) and the passes that ran on the card
    (None: no device activity kept), from a ``torch.profiler`` trace."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return out, sum(map(len, _host_launches(events, span))), _device_passes(events)


def _time_ms(fn, reps: int = 10) -> float:
    """Median device ms of ``fn()``, each call queued behind a sleep kernel
    so the events do not count the wrapper's host latency."""
    from audio_fir_filter_tpu_torch.experiments._probe import event_ms

    return float(event_ms(fn, reps))


MODES = (
    # mode, precision, sample rate, i16 I/O, gate bits
    ("f64", "high", 96000.0, False, 24),
    ("f32", "fast", 96000.0, False, 16),
    ("i16", "fast", 44100.0, True, 16),
)


def _signal(fs: float, seconds: float, rng) -> np.ndarray:
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = (0.25 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 5.0 * t) + 0.05)
    return np.stack([x + rng.uniform(-0.05, 0.05, n),
                     0.5 * x + rng.uniform(-0.05, 0.05, n)]).astype(np.float32)


def phase_kernels() -> dict:
    from audio_fir_filter_tpu_torch.experiments._probe import library_conv_ms
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import roofline
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    rng = np.random.default_rng(SEED)
    results = {}
    for mode, precision, fs, i16, bits in MODES:
        model = LowCut(freq=15.0, slope=10.0)
        taps = model.taps(fs)
        plan = model.plan(fs, precision=precision, device="cuda")
        x = _signal(fs, 30.0, rng)
        if i16:
            x = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
        xd = torch.from_numpy(x).cuda()
        n = x.shape[1]
        before = sf.launches[mode], sf.kernels[mode]
        (yk, pk), host, ran = _traced_passes(
            lambda: sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16),
            "lowcut.segment.launch")
        check(sf.launches[mode] == before[0] + 1, f"{mode}: launch not counted")
        counted = sf.kernels[mode] - before[1]
        check(counted == host > 0 and (ran or 0) <= counted,
              f"{mode}: {counted} kernels counted, {host} launched by the entry "
              f"point and {ran} passes on the card in the trace")
        yp, pp = sf.reference(xd, plan, plan.mo2, n, i16_io=i16)
        yk_h = yk.cpu().numpy().astype(np.float64)
        yp_h = yp.cpu().numpy().astype(np.float64)
        check(yk.shape == (2, n) and bool(np.isfinite(yk_h).all()),
              f"{mode}: bad kernel output {tuple(yk.shape)}")
        if i16:
            yk_h /= 32768.0
            yp_h /= 32768.0
        err_abs = float(np.max(np.abs(yk_h - yp_h)))
        err_lsb = scaled_lsb_error(yk_h, yp_h, bits)
        peak_k = float(pk)
        peak_true = float(np.max(np.abs(yk.cpu().numpy().astype(np.float64))))
        check(abs(peak_k - peak_true) <= 1e-6 * peak_true,
              f"{mode}: kernel peak {peak_k} != max|y| {peak_true}")
        check(abs(peak_k - float(pp)) <= max(1e-5 * peak_true, 1.0 if i16 else 0),
              f"{mode}: kernel peak {peak_k} vs plain {float(pp)}")
        check(err_lsb <= 1.0, f"{mode}: kernel vs plain {err_lsb} LSB@{bits} > 1")

        ms = _time_ms(lambda: sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16))
        plain_ms = _time_ms(lambda: sf.reference(xd, plan, plan.mo2, n, i16_io=i16))
        ms2 = _time_ms(lambda: sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16))
        print(f"kernel {mode}: M={plan.m} B={plan.block_size} C=2 N={n}: "
              f"kernel vs plain {err_lsb:.4f} LSB@{bits} (max abs {err_abs:.3e}), "
              f"peak {peak_k:.6f}; kernel {ms:.3f}/{ms2:.3f} ms, "
              f"plain (cuFFT) {plain_ms:.3f} ms, "
              f"{2 * n / (min(ms, ms2) * 1e-3) / 1e9:.3f} Gsamples/s")
        _pass1_row(sf, mode, 18)
        _pass2_row(sf, mode, 18)
        _pass3_row(sf, mode, 18)
        if mode == "f64":
            _pass1_row(sf, mode, 19)
            _pass2_row(sf, mode, 19)
            _pass3_row(sf, mode, 19)

        # Float64 oracle on head, a pair seam and tail excerpts.
        xin = x.astype(np.float64) / (32768.0 if i16 else 1.0)
        seam = 2 * plan.hop * 3
        worst = 0.0
        for c in range(2):
            for i0 in excerpt_starts(n, seam):
                want = oracle_excerpt(xin[c], taps, i0, EXCERPT)
                if not i16:
                    want = want.astype(np.float32)
                worst = max(worst, scaled_lsb_error(
                    yk_h[c, i0 : i0 + EXCERPT], want, bits))
        print(f"oracle {mode}: head/seam/tail excerpts {worst:.4f} LSB@{bits}")
        check(worst <= 1.0, f"{mode}: oracle excerpt {worst} LSB@{bits} > 1")
        lib_ms = None
        if not i16:
            lib_ms, lib_err = library_conv_ms(xd, taps, precision, plan.mo2, n, yp)
            print(f"library {mode}: F.conv1d (cuDNN, TF32 off) {lib_ms:.3f} ms, "
                  f"max abs diff from the plain version {lib_err:.3e}")
        w = roofline.work(plan, 2, n, n, sample_bytes=2 if i16 else 4)
        results[mode] = {"max_abs_err": err_abs, "ms": min(ms, ms2),
                         "plain_ms": plain_ms, **roofline.bound_keys(w),
                         "library_ms": lib_ms}
    _twiddle_rows()
    _long_split_kernels()
    return results


# The compute type of each segment-kernel mode's tables.
TABLE_TYPES = {"f32": torch.complex64, "f64": torch.complex128,
               "i16": torch.complex64}


def _twiddle_rows() -> None:
    """Print each mode's four-step twiddle layout at B = 2^18 and 2^19;
    fail where the library's compile-time rule (``fourstep.cuh``
    ``Twiddle``, asked through ``lowcut_segment_twiddle_layout``) and
    ``kernel_tables``' rule (``segment_filter.twiddle_layout``) disagree
    at any B = 2^2 .. 2^26."""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    for mode, dtype in TABLE_TYPES.items():
        for k in range(2, 27):
            host = sf.twiddle_layout(1 << k, dtype)
            lib = sf.library_twiddle_layout(mode, 1 << k)
            check(lib == host, f"twiddle {mode} at B = 2^{k}: the library has "
                  f"{lib}, kernel_tables {host}")
        print(f"twiddle {mode}: " + "; ".join(
            f"B = 2^{k} " + ("factored, {lo_rows} + {hi_rows} rows".format(**lay)
                             if lay["factored"] else "full table")
            + f", {lay['bytes']} bytes"
            for k, lay in ((k, sf.twiddle_layout(1 << k, dtype)) for k in (18, 19)))
            + "; the library's rule agrees at B = 2^2 .. 2^26")


def _launch_splits() -> list:
    """(log_n1, log_n2) of each recorded ``segment.launch`` span, oldest
    first."""
    from audio_fir_filter_tpu_torch.utils import spans

    return [(s["info"]["log_n1"], s["info"]["log_n2"]) for s in spans.spans()
            if s["name"] == "segment.launch"]


def _long_split_kernels() -> None:
    """The long filter's split, 1024 x 512 in f64 (M = 76,800 at 96 kHz,
    B = 2^19), where the column passes take the factored twiddle: the
    segment kernel through ``same_filter_peak`` on 2 x 30 s and the block
    kernel on 4 blocks, each against its plain version within the
    ``high`` gate (1 LSB@24); the segment call's launch span at 10x9."""
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.utils import spans

    rng = np.random.default_rng(SEED + 7)
    model = LowCut(freq=10.0, slope=5.0)
    plan = model.plan(96000.0, precision="high", device="cuda")
    check(sf.split(plan.block_size) == (10, 9) and plan.m == 76800,
          f"long filter: M = {plan.m}, split {sf.split(plan.block_size)}")
    check(sf.twiddle_layout(plan.block_size, plan.H.dtype)["factored"],
          "long filter: the twiddle is not factored")
    x = torch.from_numpy(_signal(96000.0, 30.0, rng)).cuda()
    before = sf.launches["f64"]
    spans.clear()
    with spans.recording():
        y, pk = osv.same_filter_peak(x, plan)
    check(sf.launches["f64"] == before + 1 and _launch_splits() == [(10, 9)],
          f"long filter: launches {before} -> {sf.launches['f64']}, launch "
          f"spans at {_launch_splits()}")
    yp, _ = sf.reference(x, plan, plan.mo2, x.shape[1])
    a = y.cpu().numpy().astype(np.float64)
    err = scaled_lsb_error(a, yp.cpu().numpy().astype(np.float64), 24)
    check(err <= 1.0, f"long filter: segment kernel vs plain {err} LSB@24 > 1")
    top = float(np.abs(a).max())
    check(abs(float(pk) - top) <= 1e-6 * top, f"long filter: peak {float(pk)} != {top}")
    bplan = model.plan(96000.0, precision="high", device="cuda", engine="fourstep")
    check(bplan.block_size == plan.block_size, "long filter: the block path's B differs")
    blocks = torch.from_numpy(
        rng.uniform(-1, 1, (4, bplan.block_size)).astype(np.float32)).cuda()
    ak = cb.conv_real_blocks(blocks, bplan).cpu().numpy().astype(np.float64)
    ap = cb.reference(blocks, bplan).cpu().numpy().astype(np.float64)
    berr = scaled_lsb_error(ak, ap, 24)
    check(berr <= 1.0, f"long filter: block kernel vs plain {berr} LSB@24 > 1")
    del x, y, yp, blocks
    torch.cuda.empty_cache()
    print(f"long filter (M = {plan.m}, B = 2^19, 1024 x 512, f64, factored "
          f"twiddle): segment kernel vs plain {err:.4f} LSB@24 (2 x 30 s, "
          f"its launch at 10x9), block kernel vs plain {berr:.4f} "
          "LSB@24 (4 blocks)")


def _pass1_row(sf, mode: str, log_b: int) -> None:
    """Print pass 1's occupancy of ``mode`` at B = 2^``log_b``; fail on
    local bytes (a stack frame or a spill) or no CTA an SM."""
    occ = sf.pass1_occupancy(mode, 1 << log_b)
    l1, l2 = sf.split(1 << log_b)
    print(f"pass 1 {mode} at B = 2^{log_b} ({1 << l1} x {1 << l2}): ring depth "
          f"{occ['ring_depth']}, {occ['ctas_per_sm']} CTAs per SM "
          f"({occ['resident_ctas']} resident), {occ['threads']} threads, "
          f"{occ['smem_bytes']} shared bytes, {occ['registers']} registers, "
          f"{occ['local_bytes']} local bytes")
    # Pass 1's registers, the persistent loop's state beside the FFT's
    # included, must stay out of local memory.
    check(occ["local_bytes"] == 0 and occ["ctas_per_sm"] >= 1,
          f"pass 1 {mode} at 2^{log_b}: {occ['local_bytes']} local bytes per "
          f"thread, {occ['ctas_per_sm']} CTAs per SM")


def _pass2_row(sf, mode: str, log_b: int) -> None:
    """Print pass 2's occupancy of ``mode`` at B = 2^``log_b``; fail unless
    f64 runs the persistent row pass (a ring of 2 stages, four CTAs of 128
    threads an SM) with no local bytes, and f32 and i16 rows_multiply (no
    ring; its local bytes are printed)."""
    occ = sf.pass2_occupancy(mode, 1 << log_b)
    l1, l2 = sf.split(1 << log_b)
    print(f"pass 2 {mode} at B = 2^{log_b} ({1 << l1} x {1 << l2}): ring depth "
          f"{occ['ring_depth']}, {occ['ctas_per_sm']} CTAs per SM "
          f"({occ['resident_ctas']} resident), {occ['threads']} threads, "
          f"{occ['smem_bytes']} shared bytes, {occ['registers']} registers, "
          f"{occ['local_bytes']} local bytes")
    if mode == "f64":
        ok = ((occ["ring_depth"], occ["ctas_per_sm"], occ["threads"]) == (2, 4, 128)
              and occ["local_bytes"] == 0)
    else:
        ok = occ["ring_depth"] == 0 and occ["ctas_per_sm"] >= 1
    check(ok, f"pass 2 {mode} at 2^{log_b}: ring depth {occ['ring_depth']}, "
          f"{occ['ctas_per_sm']} CTAs of {occ['threads']} threads per SM, "
          f"{occ['local_bytes']} local bytes per thread")


# Pass 3's ring depth in f64 at B = 2^18 and 2^19 (segment_filter.cuh
# Pass3: two stages wherever Cols runs one CTA an SM); none in f32 and i16.
PASS3_F64_RING = {18: 2, 19: 2}


def _pass3_row(sf, mode: str, log_b: int) -> None:
    """Print pass 3's occupancy of ``mode`` at B = 2^``log_b``; fail unless
    f64 runs the ring ``PASS3_F64_RING`` names (one 512-thread CTA an SM
    where it runs one) and f32 and i16 cols_inverse with no ring, or on
    local bytes (a stack frame or a spill) or no CTA an SM."""
    occ = sf.pass3_occupancy(mode, 1 << log_b)
    l1, l2 = sf.split(1 << log_b)
    print(f"pass 3 {mode} at B = 2^{log_b} ({1 << l1} x {1 << l2}): ring depth "
          f"{occ['ring_depth']}, {occ['ctas_per_sm']} CTAs per SM "
          f"({occ['resident_ctas']} resident), {occ['threads']} threads, "
          f"{occ['smem_bytes']} shared bytes, {occ['registers']} registers, "
          f"{occ['local_bytes']} local bytes")
    ring = PASS3_F64_RING[log_b] if mode == "f64" else 0
    ok = occ["ring_depth"] == ring and occ["local_bytes"] == 0 and occ["ctas_per_sm"] >= 1
    if ring:
        ok = ok and (occ["ctas_per_sm"], occ["threads"]) == (1, 512)
    check(ok, f"pass 3 {mode} at 2^{log_b}: ring depth {occ['ring_depth']} (want "
          f"{ring}), {occ['ctas_per_sm']} CTAs of {occ['threads']} threads per "
          f"SM, {occ['local_bytes']} local bytes per thread")


def _check_pass3_rings(tag: str) -> None:
    """Fail unless the recorded ``segment.launch`` spans include an f64 one
    and each carries its pass-3 ring depth: ``PASS3_F64_RING``'s at its B
    in f64, 0 in f32 and i16."""
    from audio_fir_filter_tpu_torch.utils import spans

    got = {(s["info"]["mode"], s["info"]["log_n1"] + s["info"]["log_n2"],
            s["info"].get("pass3_ring")) for s in spans.spans()
           if s["name"] == "segment.launch"}
    want = {(m, lb, PASS3_F64_RING[lb] if m == "f64" else 0) for m, lb, _ in got}
    print(f"{tag}: pass 3 ring depths of the launch spans (mode, log2 B, "
          f"pass3_ring): {sorted(got, key=str)}")
    check(got == want and any(m == "f64" for m, _, _ in got),
          f"{tag}: pass 3 ring depths {sorted(got, key=str)}, want "
          f"{sorted(want, key=str)}")


def phase_edge_shapes() -> None:
    """Kernel vs plain version at the CPU tests' small shapes: square and
    non-square four-step splits, 3 channels, lengths around the hop, a
    kernel longer than the signal, halo-extended input (left = 0)."""
    from audio_fir_filter_tpu_torch.ops import kernel_design as kd
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    rng = np.random.default_rng(SEED + 2)
    taps = kd.highpass_taps(0.05, 200)              # M = 200
    worst = {}
    for mode, precision, _, i16, bits in MODES:
        for b in (256, 512, 1024, 2048):
            plan = osv.make_plan(taps, precision, b, "cuda")
            for c, n in ((3, 100), (1, plan.hop - 1), (2, plan.hop + 1),
                         (3, 5 * plan.hop + 37)):
                x = rng.uniform(-1, 1, (c, n)).astype(np.float32)
                if i16:
                    x = np.rint(x * 30000).astype(np.int16)
                xd = torch.from_numpy(x).cuda()
                for left, out_len in ((plan.mo2, n), (0, max(0, n - plan.m))):
                    yk, pk = sf.segment_filter(xd, plan, left, out_len, i16_io=i16)
                    yp, _ = sf.reference(xd, plan, left, out_len, i16_io=i16)
                    a = yk.cpu().numpy().astype(np.float64)
                    r = yp.cpu().numpy().astype(np.float64)
                    if i16:
                        a, r = a / 32768.0, r / 32768.0
                    err = scaled_lsb_error(a, r, bits) if a.size else 0.0
                    check(err <= 1.0, f"{mode} B={b} C={c} N={n} left={left}: "
                          f"kernel vs plain {err} LSB@{bits}")
                    top = float(np.abs(yk.cpu().numpy().astype(np.float64)).max()) \
                        if a.size else 0.0
                    check(abs(float(pk) - top) <= 1e-6 * max(top, 1e-30),
                          f"{mode} B={b} C={c} N={n}: peak {float(pk)} != {top}")
                    worst[mode] = max(worst.get(mode, 0.0), err)
    torch.cuda.synchronize()
    print("edge shapes (B 256-2048, C 1-3, halos): kernel vs plain "
          + ", ".join(f"{k} {v:.4f} LSB" for k, v in worst.items()))
    phase_every_side()


def _edge_taps(b: int) -> np.ndarray:
    from audio_fir_filter_tpu_torch.ops import kernel_design as kd

    return kd.highpass_taps(0.05, 2 if b <= 256 else 200)


def phase_every_side() -> None:
    """The segment kernel at every B = 2^k, k = 2 .. 26, in all three
    modes: 2 channels of 2 hops + 1 frames (two pairs per channel)."""
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    rng = np.random.default_rng(SEED + 5)
    worst = {}
    for k in range(2, 27):
        b = 1 << k
        check(sf.qualifies(len(_edge_taps(b)), b), f"B=2^{k} does not qualify")
        for mode, precision, _, i16, bits in MODES:
            plan = osv.make_plan(_edge_taps(b), precision, b, "cuda")
            n = 2 * plan.hop + 1
            x = rng.uniform(-0.9, 0.9, (2, n)).astype(np.float32)
            if i16:
                x = np.rint(x * 30000).astype(np.int16)
            xd = torch.from_numpy(x).cuda()
            yk, pk = sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16)
            yp, _ = sf.reference(xd, plan, plan.mo2, n, i16_io=i16)
            a = yk.cpu().numpy().astype(np.float64)
            r = yp.cpu().numpy().astype(np.float64)
            del xd, yk, yp
            top = float(np.abs(a).max())
            check(abs(float(pk) - top) <= 1e-6 * max(top, 1e-30),
                  f"{mode} B=2^{k}: peak {float(pk)} != {top}")
            if i16:
                a, r = a / 32768.0, r / 32768.0
            err = scaled_lsb_error(a, r, bits)
            check(err <= 1.0, f"{mode} B=2^{k}: kernel vs plain {err} LSB@{bits}")
            if err >= worst.get(mode, (-1.0, 0))[0]:
                worst[mode] = (err, k)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("every side (B = 2^2 .. 2^26, C = 2): kernel vs plain, worst "
          + ", ".join(f"{m} {e:.4f} LSB (B=2^{k})" for m, (e, k) in worst.items()))


CONV_MODES = (
    # mode, precision, gate bits
    ("f64", "high", 24),
    ("f32", "fast", 16),
)


def phase_conv_kernels() -> dict:
    """The block kernel on the block path's own input for 2 x 30 s at
    96 kHz: the overlapped blocks that ``--engine fourstep`` builds, all B
    positions compared (the aliased head [0, M) included)."""
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import roofline
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(_signal(96000.0, 30.0, rng)).cuda()
    n = x.shape[1]
    results = {}
    for mode, precision, bits in CONV_MODES:
        plan = LowCut().plan(96000.0, precision=precision, device="cuda",
                             engine="fourstep")
        nb = -(-n // plan.hop)
        nb += nb & 1
        blocks = sf.windows(x, plan.block_size, plan.hop, plan.mo2,
                            nb).contiguous().view(-1, plan.block_size)
        check(tuple(blocks.shape) == (28, 1 << 18),
              f"conv {mode}: blocks {tuple(blocks.shape)} != (28, 2^18)")
        before = cb.launches[mode], cb.kernels[mode]
        yk, host, ran = _traced_passes(lambda: cb.conv_real_blocks(blocks, plan))
        check(cb.launches[mode] == before[0] + 1, f"conv {mode}: launch not counted")
        counted = cb.kernels[mode] - before[1]
        check(counted == host > 0 and (ran or 0) <= counted,
              f"conv {mode}: {counted} kernels counted, {host} launched and "
              f"{ran} passes on the card in the trace")
        yp = cb.reference(blocks, plan)
        yk_h = yk.cpu().numpy().astype(np.float64)
        yp_h = yp.cpu().numpy().astype(np.float64)
        check(bool(np.isfinite(yk_h).all()), f"conv {mode}: non-finite output")
        err_abs = float(np.max(np.abs(yk_h - yp_h)))
        err_lsb = scaled_lsb_error(yk_h, yp_h, bits)
        check(err_lsb <= 1.0, f"conv {mode}: kernel vs plain {err_lsb} LSB@{bits} > 1")
        head = scaled_lsb_error(yk_h[:, : plan.m], yp_h[:, : plan.m], bits)

        ms = _time_ms(lambda: cb.conv_real_blocks(blocks, plan))
        plain_ms = _time_ms(lambda: cb.reference(blocks, plan))
        ms2 = _time_ms(lambda: cb.conv_real_blocks(blocks, plan))
        print(f"conv kernel {mode}: M={plan.m} B={plan.block_size} blocks "
              f"{tuple(blocks.shape)}: kernel vs plain {err_lsb:.4f} LSB@{bits} "
              f"over full blocks (head [0, M) {head:.4f}; max abs "
              f"{err_abs:.3e}); kernel {ms:.3f}/{ms2:.3f} ms, plain (cuFFT) "
              f"{plain_ms:.3f} ms")
        # No one PyTorch call convolves blocks circularly: library_ms null.
        w = roofline.roofline(
            2 * blocks.numel() * 4,
            roofline.fft_conv_flops(plan.block_size, blocks.shape[0]), precision)
        results[mode] = {"max_abs_err": err_abs, "ms": min(ms, ms2),
                         "plain_ms": plain_ms, **roofline.bound_keys(w),
                         "library_ms": None}
        occ = cb.occupancy(plan.block_size, precision)
        print(f"conv kernel {mode} occupancy at B = 2^18 (CTAs per SM, "
              "threads, shared bytes, registers, local bytes): "
              + "; ".join(f"{p} {o['ctas_per_sm']}, {o['threads']}, "
                          f"{o['smem_bytes']}, {o['registers']}, "
                          f"{o['local_bytes']}" for p, o in occ.items()))
        # A thread's 8 complex registers in local memory (an index the
        # compiler could not fold) made every pass 2.3x slower once.
        v_bytes = 8 * 2 * (8 if precision == "high" else 4)
        for p, o in occ.items():
            check(o["local_bytes"] < v_bytes,
                  f"conv {mode} {p}: {o['local_bytes']} local bytes per thread, "
                  f"the FFT's {v_bytes} register bytes left the registers")
    return results


def phase_conv_edge_shapes() -> None:
    """Block kernel vs plain version at small shapes (B 256-2048, nb 2-6,
    square and non-square splits), and the whole block path at T = 201,
    B = 256 (hop 56) against the segment filter's plain version."""
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import kernel_design as kd
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    rng = np.random.default_rng(SEED + 4)
    taps = kd.highpass_taps(0.05, 200)              # T = 201
    worst = {}
    for mode, precision, bits in CONV_MODES:
        for b in (256, 512, 1024, 2048):
            plan = osv.make_plan(taps, precision, b, "cuda", engine="fourstep")
            for nb in (2, 4, 6):
                x = torch.from_numpy(
                    rng.uniform(-1, 1, (nb, b)).astype(np.float32)).cuda()
                a = cb.conv_real_blocks(x, plan).cpu().numpy().astype(np.float64)
                r = cb.reference(x, plan).cpu().numpy().astype(np.float64)
                err = scaled_lsb_error(a, r, bits)
                check(err <= 1.0, f"conv {mode} B={b} nb={nb}: {err} LSB@{bits}")
                worst[mode] = max(worst.get(mode, 0.0), err)
        plan = osv.make_plan(taps, precision, 256, "cuda", engine="fourstep")
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 3001)).astype(np.float32)).cuda()
        y, pk = osv.same_filter_peak(x, plan)
        r, _ = sf.reference(x, plan, plan.mo2, x.shape[1])
        a = y.cpu().numpy().astype(np.float64)
        err = scaled_lsb_error(a, r.cpu().numpy().astype(np.float64), bits)
        check(err <= 1.0, f"block path {mode} T=201 B=256: {err} LSB@{bits}")
        top = float(np.abs(a).max())
        check(float(pk) == top, f"block path {mode}: peak {float(pk)} != {top}")
        worst[f"{mode} T=201/B=256 path"] = err
    torch.cuda.synchronize()
    print("conv edge shapes (B 256-2048, nb 2-6; block path T=201 B=256): "
          + ", ".join(f"{k} {v:.4f} LSB" for k, v in worst.items()))
    phase_conv_every_side()


def phase_conv_every_side() -> None:
    """The block kernel at every B = 2^k, k = 2 .. 26, nb = 2, both modes,
    all B positions."""
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv

    rng = np.random.default_rng(SEED + 6)
    worst = {}
    for k in range(2, 27):
        b = 1 << k
        x = torch.from_numpy(rng.uniform(-1, 1, (2, b)).astype(np.float32)).cuda()
        for mode, precision, bits in CONV_MODES:
            plan = osv.make_plan(_edge_taps(b), precision, b, "cuda",
                                 engine="fourstep")
            a = cb.conv_real_blocks(x, plan).cpu().numpy().astype(np.float64)
            r = cb.reference(x, plan).cpu().numpy().astype(np.float64)
            check(bool(np.isfinite(a).all()), f"conv {mode} B=2^{k}: non-finite")
            err = scaled_lsb_error(a, r, bits)
            check(err <= 1.0, f"conv {mode} B=2^{k}: {err} LSB@{bits}")
            if err >= worst.get(mode, (-1.0, 0))[0]:
                worst[mode] = (err, k)
        del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("conv every side (B = 2^2 .. 2^26, nb = 2): kernel vs plain, worst "
          + ", ".join(f"{m} {e:.4f} LSB (B=2^{k})" for m, (e, k) in worst.items()))


def _cli_rc(args: list[str]) -> tuple[int, str]:
    """Exit code and standard error of the port's CLI, in-process."""
    from audio_fir_filter_tpu_torch.cli import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, err.getvalue()


def _run_cli(args: list[str]) -> dict:
    """Run the CLI with --json-metrics; it must exit 0. Returns the last
    file's metrics."""
    rc, text = _cli_rc([*args, "--json-metrics"])
    check(rc == 0, f"lowcut {' '.join(args)} exited {rc}: {text}")
    return json.loads(text.strip().splitlines()[-1])


def _file_excerpts(inp, out, taps, seam, bits) -> float:
    from audio_fir_filter_tpu_torch import audio

    din, dout = audio.read_audio(inp), audio.read_audio(out)
    check(dout.samples.shape == din.samples.shape, "output shape differs")
    check(bool(np.isfinite(dout.samples).all()), "non-finite output")
    n = din.num_frames
    worst = 0.0
    for c in range(din.num_channels):
        x = din.samples[c].astype(np.float64)
        for i0 in excerpt_starts(n, seam):
            want = oracle_excerpt(x, taps, i0, EXCERPT)
            worst = max(worst, scaled_lsb_error(
                dout.samples[c, i0 : i0 + EXCERPT], want, bits))
    return worst


STAGES = ("read", "design", "filter", "normalize", "write")


def _timed_cli(args: list[str]) -> tuple[dict, float, dict]:
    """(metrics, wall seconds, launches made) of one CLI run."""
    before = _counts()
    t0 = time.perf_counter()
    m = _run_cli(args)
    wall = time.perf_counter() - t0
    after = _counts()
    return m, wall, {k: after[k] - before[k] for k in after}


def _print_stages(tag: str, m: dict, card: str) -> None:
    stages = ", ".join(f"{k} {m[k]:.3f} s" for k in STAGES)
    print(f"stages ({tag}) on {card}: {stages}; "
          f"{m['frames']} frames x {m['channels']} ch")


def _check_metadata(inp: Path, out: Path, tag: str) -> None:
    from audio_fir_filter_tpu_torch import audio

    cin = audio.read_audio(inp).container
    cout = audio.read_audio(out).container
    check([c.ckid for c in cin.chunks] == [c.ckid for c in cout.chunks],
          f"({tag}) chunk order changed")
    for x, y in zip(cin.chunks, cout.chunks):
        if x.ckid != b"data":
            check(bytes(x.data) == bytes(y.data),
                  f"({tag}) chunk {x.ckid!r} not byte-identical")


def make_inputs(tmp: Path) -> dict:
    """(a) 10 min 96 kHz stereo 24-bit WAV with a metadata chunk, (b) 5 min
    44.1 kHz stereo 16-bit WAV, (c) a loud 10 s 44.1 kHz 16-bit WAV that
    saturates, (d) 1 min 48 kHz stereo 24-bit AIFF."""
    from audio_fir_filter_tpu_torch.audio import Encoding
    from audio_fir_filter_tpu_torch.audio.chunks import Chunk
    from audio_fir_filter_tpu_torch.audio.synth import create_audio_file

    rng = np.random.default_rng(SEED + 1)
    meta = Chunk(b"bext", bytes(range(256)) * 3 + b"lowcut chip smoke")
    files = {"a": tmp / "long96k24.wav", "b": tmp / "mid44k16.wav",
             "c": tmp / "loud44k16.wav", "d": tmp / "short48k24.aif"}
    t0 = time.perf_counter()
    create_audio_file(files["a"], _signal(96000.0, 600.0, rng), 96000.0,
                      encoding=Encoding.PCM_24, extra_chunks=[meta])
    create_audio_file(files["b"], _signal(44100.0, 300.0, rng), 44100.0,
                      encoding=Encoding.PCM_16)
    fs = 44100.0
    t = np.arange(int(fs * 10)) / fs
    pulses = ((t * 100.0) % 1.0) < 0.05      # 5% duty, 100 Hz
    loud = (1.98 * pulses - 0.99).astype(np.float32)
    create_audio_file(files["c"], np.stack([loud, loud]), fs,
                      encoding=Encoding.PCM_16)
    create_audio_file(files["d"], _signal(48000.0, 60.0, rng), 48000.0,
                      encoding=Encoding.PCM_24)
    print(f"synthesized inputs: {time.perf_counter() - t0:.1f} s")
    return files


def _out(path: Path, tag: str) -> Path:
    return path.with_name(f"{path.stem}_{tag}{path.suffix}")


def phase_main_path(card: str, files: dict) -> dict:
    """Scenario 1 on (a), (b), (c) with the default engine. Returns the
    path's launch counts and, per file, (output, wall s, launches)."""
    from audio_fir_filter_tpu_torch import audio
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.pipeline.stream import default_segment_len
    from audio_fir_filter_tpu_torch.utils import spans

    single = {}
    _zero_counts()
    spans.clear()
    with spans.recording():
        for tag in "abc":
            out = _out(files[tag], "out")
            m, wall, made = _timed_cli([str(files[tag]), str(out)])
            single[tag] = (out, wall, made, m)
    counts = _counts()
    got = _launch_splits()
    splits = {f"{a}x{b}": got.count((a, b)) for a, b in sorted(set(got))}
    print(f"main-path launches: {counts}; segment kernel calls by split: "
          f"{splits}")
    n = sum(sf.launches.values())
    check(len(got) == n, f"{n} launches, {splits} launch spans")
    rings = [s["info"].get("pass2_ring") for s in spans.spans()
             if s["name"] == "segment.launch"]
    check(None not in rings and set(rings) == {0, 2},
          f"pass 2 ring depths of the launch spans: {sorted(set(map(str, rings)))} "
          "(every span carries one: 2 in f64, 0 in f32 and i16)")
    _check_pass3_rings("main path")
    for k, v in counts.items():
        if k.startswith("segment_filter_"):
            check(v > 0, f"kernel {k} never launched on the main path")
        else:
            check(v == 0, f"kernel {k} launched on the segment path")
    (a_out, _, _, ma), (b_out, _, _, mb), (c_out, _, _, mc) = (
        single["a"], single["b"], single["c"])

    # (a) 10 minutes, 96 kHz, 24-bit: high precision across segments.
    check(ma["precision"] == "high", f"(a) precision {ma['precision']}")
    _check_metadata(files["a"], a_out, "a")
    plan96 = LowCut().plan(96000.0, precision="high", device="cuda")
    seam = default_segment_len(plan96, channels=2)
    frames = ma["frames"]
    check(frames > 2 * seam, f"(a) {frames} frames do not span 3 segments")
    err_a = _file_excerpts(files["a"], a_out, LowCut().taps(96000.0), seam, 24)
    print(f"(a) 96 kHz 24-bit {frames} frames x 2 ch, M={plan96.m}, "
          f"B={plan96.block_size}, segment {seam} frames: excerpts "
          f"{err_a:.4f} LSB@24 (output quantized to 24 bits)")
    check(err_a <= 1.0, f"(a) excerpt error {err_a} LSB@24 > 1")

    # (b) 5 minutes, 44.1 kHz, 16-bit: the 16-bit-native route.
    check(mb["precision"] == "fast", f"(b) precision {mb['precision']}")
    check(single["b"][2]["segment_filter_i16"] > 0, "(b) took no i16 route")
    plan44 = LowCut().plan(44100.0, precision="fast", device="cuda")
    err_b = _file_excerpts(files["b"], b_out, LowCut().taps(44100.0),
                           default_segment_len(plan44, channels=2), 16)
    print(f"(b) 44.1 kHz 16-bit {mb['frames']} frames: excerpts "
          f"{err_b:.4f} LSB@16")
    check(err_b <= 1.0, f"(b) excerpt error {err_b} LSB@16 > 1")

    # (c) loud 16-bit: saturates, refilters in f32, auto-normalizes.
    out_peak = float(np.max(np.abs(audio.read_audio(c_out).samples)))
    print(f"(c) loud 16-bit: filtered peak {mc['peak']:.4f}, "
          f"output peak {out_peak:.6f}")
    check(mc["peak"] > 1.0, f"(c) peak {mc['peak']} did not exceed 1")
    check(out_peak <= 1.0 + 2.0 ** -15, f"(c) output peak {out_peak}")

    for tag in "abc":
        _print_stages(tag, single[tag][3], card)

    # (a) again with the long filter (-f 10 -s 5: M = 76,800, B = 2^19):
    # the f64 kernel at the 1024 x 512 split, whose column passes take the
    # factored twiddle; the default runs above took none (complex128 is
    # factored from the smallest B).
    def factored(split):
        return sf.twiddle_layout(1 << sum(split), torch.complex128)["factored"]

    check(not any(map(factored, got)),
          f"the default runs took the factored twiddle: {splits}")
    _zero_counts()
    spans.clear()
    long_out = _out(files["a"], "long")
    with spans.recording():
        ml, _, _ = _timed_cli([str(files["a"]), str(long_out), "-f", "10",
                               "-s", "5"])
    n = sf.launches["f64"]
    check(n > 0 and sum(sf.launches.values()) == n
          and _launch_splits() == [(10, 9)] * n and factored((10, 9)),
          f"(a long) {n} f64 launches of {dict(sf.launches)}, launch spans "
          f"at {sorted(set(_launch_splits()))}")
    long96 = LowCut(freq=10.0, slope=5.0)
    plan_long = long96.plan(96000.0, precision="high", device="cuda")
    err_l = _file_excerpts(files["a"], long_out, long96.taps(96000.0),
                           default_segment_len(plan_long, channels=2), 24)
    print(f"(a long) -f 10 -s 5, M={plan_long.m}, B={plan_long.block_size}: "
          f"{n} f64 launches, all at 10x9 with the factored twiddle; "
          f"excerpts {err_l:.4f} LSB@24")
    check(err_l <= 1.0, f"(a long) excerpt error {err_l} LSB@24 > 1")
    _check_pass3_rings("(a long)")
    _print_stages("a long", ml, card)
    long_out.unlink()
    return {"counts": counts, "single": single}


def phase_fourstep(card: str, files: dict) -> dict:
    """Scenario 1 with ``--engine fourstep`` on (a) and (b): the block path.
    Returns its launch counts."""
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.pipeline.stream import default_segment_len

    _zero_counts()
    ma, _, _ = _timed_cli([str(files["a"]), str(_out(files["a"], "four")),
                           "--engine", "fourstep"])
    mb, _, _ = _timed_cli([str(files["b"]), str(_out(files["b"], "four")),
                           "--engine", "fourstep"])
    counts = _counts()
    print(f"fourstep-path launches: {counts}")
    for k, v in counts.items():
        if k.startswith("conv_blocks_"):
            check(v > 0, f"kernel {k} never launched on the fourstep path")
        else:
            check(v == 0, f"kernel {k} launched on the fourstep path")

    check(ma["precision"] == "high", f"(a four) precision {ma['precision']}")
    _check_metadata(files["a"], _out(files["a"], "four"), "a four")
    plan = LowCut().plan(96000.0, precision="high", device="cuda",
                         engine="fourstep")
    seam = default_segment_len(plan, channels=2)
    check(ma["frames"] > 2 * seam, "(a four) fewer than 3 segments")
    err_a = _file_excerpts(files["a"], _out(files["a"], "four"),
                           LowCut().taps(96000.0), seam, 24)
    print(f"(a four) --engine fourstep, 96 kHz 24-bit, segment {seam} frames: "
          f"excerpts {err_a:.4f} LSB@24")
    check(err_a <= 1.0, f"(a four) excerpt error {err_a} LSB@24 > 1")

    check(mb["precision"] == "fast", f"(b four) precision {mb['precision']}")
    plan44 = LowCut().plan(44100.0, precision="fast", device="cuda",
                           engine="fourstep")
    err_b = _file_excerpts(files["b"], _out(files["b"], "four"),
                           LowCut().taps(44100.0),
                           default_segment_len(plan44, channels=2), 16)
    print(f"(b four) --engine fourstep, 44.1 kHz 16-bit (no 16-bit route): "
          f"excerpts {err_b:.4f} LSB@16")
    check(err_b <= 1.0, f"(b four) excerpt error {err_b} LSB@16 > 1")
    _print_stages("a four", ma, card)
    _print_stages("b four", mb, card)
    return counts


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _add(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_batch(card: str, files: dict, single: dict, tmp: Path) -> dict:
    """The batch scenario with ``--resume`` (default filter settings).
    Returns the single-file runs of (a)-(d)."""
    from audio_fir_filter_tpu_torch import audio
    from audio_fir_filter_tpu_torch.pipeline.manifest import MANIFEST_NAME

    out_d = _out(files["d"], "out")
    md, wall_d, made_d = _timed_cli([str(files["d"]), str(out_d)])
    single = {**single, "d": (out_d, wall_d, made_d, md)}
    inputs = [files[t] for t in "abcd"]

    dest = tmp / "batch_new"
    argv = [*map(str, inputs), str(dest), "--resume"]
    _zero_counts()
    t0 = time.perf_counter()
    _run_cli(argv)
    wall = time.perf_counter() - t0
    counts = _counts()
    print(f"batch launches: {counts}")
    want = _add(*(single[t][2] for t in "abcd"))
    check(counts == want, f"batch launches {counts} != single-file sum {want}")
    for k in ("segment_filter_f32", "segment_filter_f64", "segment_filter_i16"):
        check(counts[k] > 0, f"kernel {k} never launched in the batch")
    for t in "abcd":
        got = audio.read_audio(dest / files[t].name).samples
        ref = audio.read_audio(single[t][0]).samples
        check(got.shape == ref.shape and bool(np.array_equal(got, ref)),
              f"batch output of ({t}) differs from its single-file output")
    singles = sum(single[t][1] for t in "abcd")
    print(f"batch of 4 files (a-d) on {card}: wall {wall:.3f} s vs "
          f"{singles:.3f} s for the four single-file runs "
          f"({', '.join(f'{t} {single[t][1]:.3f}' for t in 'abcd')}); "
          "outputs equal the single-file outputs sample for sample")

    # --resume rerun: nothing to do.
    before = {p.name: (_sha(dest / p.name), (dest / p.name).stat().st_mtime_ns)
              for p in inputs}
    _zero_counts()
    rc, err = _cli_rc(argv)
    check(rc == 0 and not err, f"--resume rerun exited {rc}: {err}")
    check(all(v == 0 for v in _counts().values()),
          f"--resume rerun launched {_counts()}")
    after = {p.name: (_sha(dest / p.name), (dest / p.name).stat().st_mtime_ns)
             for p in inputs}
    check(after == before, "--resume rerun changed an output")
    print("batch --resume rerun: 0 launches, outputs byte-identical")

    # A missing file in the middle aborts; files before it stay written.
    late = tmp / "late48k24.aif"
    dest2 = tmp / "batch_abort"
    argv2 = [str(files["d"]), str(files["b"]), str(late), str(files["c"]),
             str(dest2), "--resume"]
    rc, err = _cli_rc(argv2)
    check(rc == 1 and "not found" in err.lower(),
          f"batch with a missing file exited {rc}: {err}")
    written = sorted(p.name for p in dest2.iterdir()
                     if not p.name.startswith(MANIFEST_NAME))
    check(written == sorted([files["d"].name, files["b"].name]),
          f"after the abort {written} are written")
    done = json.loads((dest2 / MANIFEST_NAME).read_text())["done"]
    check(sorted(done) == sorted([str(files["d"]), str(files["b"])]),
          f"manifest after the abort lists {sorted(done)}")

    # With the file present, --resume filters only the rest.
    shutil.copyfile(files["d"], late)
    _zero_counts()
    _run_cli(argv2)
    rest = _counts()
    want = _add(made_d, single["c"][2])
    check(rest == want, f"resume after abort launched {rest}, want {want}")
    check(bool(np.array_equal(audio.read_audio(dest2 / late.name).samples,
                              audio.read_audio(out_d).samples)),
          "resumed output of the late file differs from its single-file output")
    print(f"batch abort at a missing file: exit 1, 2 files written and in the "
          f"manifest; --resume with it present launched {rest} (the rest only)")
    return single


def phase_probes(card: str) -> dict:
    """Phase 9: the probe kernels against their plain versions, then their
    sweeps with the counters zeroed before and read after. Returns the
    probe rows of the kernels line."""
    mods = _probe_modules()
    t0 = time.perf_counter()
    errs = {}
    for mod in mods:
        errs.update(mod.verify("cuda"))
    print("probes vs plain versions: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    from audio_fir_filter_tpu_torch.experiments import fused_phase_decomp as fpd
    from audio_fir_filter_tpu_torch.experiments.copy_floor_probe import (
        cluster_occupancy, occupancy_line)

    print(ring_chain_ptxas())
    print(fused_block_ptxas())
    occ = cluster_occupancy("cuda")
    print(occupancy_line(occ))
    check(occ["cluster"] > 0 and occ["cluster16"] > 0,
          "a copy-floor cluster cannot be resident")
    focc = fpd.fused_occupancy("cuda")
    print(fpd.occupancy_line(focc))
    check(all(o["clusters"] > 0 for o in focc.values()),
          "a fused-block cluster cannot be resident")
    _zero_counts()
    timed = {}
    for mod in mods:
        r = mod.run("cuda", reps=3)
        print("\n".join(r["lines"]))
        timed.update(r["kernels"])
    counts = _counts()
    print(f"probe-path launches on {card}: "
          f"{ {k: counts[k] for k in counts if k.startswith('probe_')} }")
    for k in [*PROBE_ROWS, "probe_empty"]:
        check(counts[k] > 0, f"probe kernel {k} never launched by its sweep")
    check(set(errs) == set(PROBE_ROWS) == set(timed),
          f"probe rows {sorted(errs)} / {sorted(timed)} != {sorted(PROBE_ROWS)}")
    print(f"probes: {time.perf_counter() - t0:.1f} s")
    return {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "launches": counts[name],
                   "max_abs_err": errs[name], **timed[name]}
            for name, (src, rep) in PROBE_ROWS.items()}


BENCH_RUNS = (
    # arguments, the kernels each run must report launched
    (["--fidelity", "--roofline", "--all", "--reps", "3"],
     ("segment_filter_f64", "segment_filter_i16")),
    (["--engine", "fourstep", "--reps", "3"],
     ("conv_blocks_f64",)),
)


def phase_bench(card: str) -> None:
    """Phase 10: ``python3 -m audio_fir_filter_tpu_torch.bench`` as a user
    runs it, in subprocesses: each exits 0 with one JSON line on stdout
    (the four keys, value > 0), the fidelity gate passes, and each run's
    own launch report shows its kernels launched (counts of that run)."""
    for args, kernels in BENCH_RUNS:
        cmd = [sys.executable, "-m", "audio_fir_filter_tpu_torch.bench", *args]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           timeout=600)
        wall = time.perf_counter() - t0
        print(f"--- bench {' '.join(args)} ({wall:.1f} s, exit {r.returncode}) "
              f"on {card}:")
        print(r.stderr.rstrip())
        check(r.returncode == 0, f"bench {' '.join(args)} exited {r.returncode}")
        lines = r.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench printed {len(lines)} stdout lines")
        result = json.loads(lines[0])
        print(f"bench result: {lines[0]}")
        check(set(result) == {"metric", "value", "unit", "vs_baseline"},
              f"bench result keys {sorted(result)}")
        check(result["value"] > 0, f"bench value {result['value']}")
        if "--fidelity" in args:
            check(r.stderr.count("PASS") == 2 and "FAIL" not in r.stderr,
                  "bench fidelity gate did not pass twice")
        # Every timed run's warm-up output against the float64 oracle at
        # the timed shape (the bench raises on a miss).
        timed = r.stderr.count("launched ")
        checked = r.stderr.count("(head/seam/tail excerpts)")
        check(timed > 0 and checked == timed,
              f"bench {' '.join(args)}: {checked} of {timed} timed runs held "
              "against the oracle")
        launched = {}
        for name, n in re.findall(r"(\w+) launched (\d+) times", r.stderr):
            launched[name] = launched.get(name, 0) + int(n)
        for k in kernels:
            check(launched.get(k, 0) > 0, f"bench {' '.join(args)}: {k} "
                  f"never launched ({launched})")


def phase_profile(card: str, files: dict, tmp: Path) -> None:
    """Phase 11: file (a) through the CLI with ``--profile DIR``, counters
    zeroed before and read after; the Chrome trace must exist and name the
    segment kernel's three passes, and each of the program's
    ``lowcut.segment.launch`` spans in it must hold as many kernel launches
    as that call's ``kernels`` count says. (Late in a long process the
    profiler may keep only some of the card's kernel records, so the
    passes on the card bound the count from below.)"""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.utils import spans

    prof = tmp / "profile"
    out = _out(files["a"], "prof")
    _zero_counts()
    kernels0 = sf.kernels["f64"]
    spans.clear()
    t0 = time.perf_counter()
    rc, err = _cli_rc([str(files["a"]), str(out), "--profile", str(prof), "-v"])
    wall = time.perf_counter() - t0
    counts = _counts()
    kernels = sf.kernels["f64"] - kernels0
    recorded = [s["info"]["kernels"] for s in spans.spans()
                if s["name"] == "segment.launch"]
    check(rc == 0, f"--profile run exited {rc}: {err}")
    check(counts["segment_filter_f64"] > 0,
          f"--profile run launched no segment kernel: {counts}")
    trace = prof / "trace.json"
    check(trace.is_file(), f"no trace at {trace}")
    events = json.loads(trace.read_text())["traceEvents"]
    per_pass = {}
    for e in events:
        for p in ("cols_forward", "rows_multiply", "cols_inverse"):
            if p in e.get("name", "") and e.get("cat") == "kernel":
                n, us = per_pass.get(p, (0, 0.0))
                per_pass[p] = (n + 1, us + float(e.get("dur", 0.0)))
    check(set(per_pass) == {"cols_forward", "rows_multiply", "cols_inverse"},
          f"trace names {sorted(per_pass)} of the segment kernel's passes")
    per_call = list(map(len, _host_launches(events, "lowcut.segment.launch")))
    check(per_call == recorded and sum(per_call) == kernels > 0
          and sum(n for n, _ in per_pass.values()) <= kernels,
          f"kernels launched in each lowcut.segment.launch span {per_call}, the "
          f"spans' kernels {recorded}, {kernels} counted, passes on the card "
          f"{per_pass}")
    print(f"--profile (a) on {card}: {wall:.1f} s with the profiler, trace "
          f"{trace.stat().st_size / 1e6:.1f} MB, {len(events)} events; launches "
          f"{ {k: v for k, v in counts.items() if v} }; kernels a call "
          f"{per_call}; kernel passes (count, "
          f"device us): {per_pass}; host<->device copies in the whole run "
          f"(count, MB) {_copies(events)}")
    _profile_filter_window(card, files, tmp)


MEMCPY = re.compile(r"Memcpy (HtoD|DtoH) \((\w+) -> (\w+)\)")
WINDOW = "lowcut filter window"


def _copies(events: list) -> dict:
    """{CUPTI memcpy name: (count, MB)} of the host<->device copies."""
    out = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy" and MEMCPY.search(e.get("name", "")):
            n, mb = out.get(e["name"], (0, 0.0))
            mb += e.get("args", {}).get("bytes", 0) / 1e6
            out[e["name"]] = (n + 1, round(mb, 3))
    return out


def _busy_share(events: list, t0: float, t1: float) -> tuple[float, list]:
    """Share of [t0, t1] (trace us) covered by the union of device kernel,
    memcpy and memset intervals, and those events (started in the
    window)."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and t0 <= float(e["ts"]) <= t1), key=lambda e: float(e["ts"]))
    busy, end = 0.0, t0
    for e in dev:
        a = max(float(e["ts"]), end)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
        if b > a:
            busy += b - a
            end = b
    return busy / (t1 - t0), dev


def _profile_filter_window(card: str, files: dict, tmp: Path) -> None:
    """File (a)'s samples through ``filter_array_streamed`` under
    ``torch.profiler``, the call marked by a ``record_function`` window:
    every host<->device copy in the window must be a pinned one. Prints the
    device's busy share over the window (union of kernel and copy
    intervals), beside the synchronous loop's under the same profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from audio_fir_filter_tpu_torch import audio
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.pipeline.stream import (
        default_segment_len, filter_array_streamed)

    xa = audio.read_audio(files["a"]).samples
    plan = LowCut().plan(96000.0, precision="high", device="cuda")
    seg = default_segment_len(plan, channels=2)
    for tag, fn in (("pipelined", lambda: filter_array_streamed(xa, plan)),
                    ("synchronous", lambda: sync_streamed(xa, plan, seg))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                fn()
        path = tmp / f"window_{tag}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        check(len(win) == 1, f"{tag}: {len(win)} filter windows in the trace")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        share, dev = _busy_share(events, t0, t1)
        copies = [e for e in dev if MEMCPY.search(e["name"])]
        kinds = _copies(dev)
        kernels = sum(float(e["dur"]) for e in dev if e["cat"] == "kernel")
        host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        print(f"filter window, (a) {tag}, under torch.profiler on {card}: "
              f"{(t1 - t0) / 1e6:.4f} s, device busy {100 * share:.2f} % "
              f"(kernels {kernels / 1e6:.4f} s), copies (count, MB) {kinds}; "
              "host self time (calls, s): "
              + ", ".join(f"{a.key} ({a.count}, {a.self_cpu_time_total / 1e6:.4f})"
                          for a in host[:6]))
        check(copies, f"{tag}: no host<->device copy in the filter window")
        if tag == "pipelined":
            check(all(MEMCPY.search(e["name"])[2 if "HtoD" in e["name"] else 3]
                      == "Pinned" for e in copies),
                  f"the pipelined filter made a copy that is not pinned: {kinds}")


# ------------------------------------------------------------ phase 12: mesh

MESH_HOPS = 8           # frames per channel of the API mesh runs, in hops
MESH_EXCERPT = 1024     # frames per oracle excerpt across a shard seam
WORKER_TIMEOUT_S = 300


def _mesh_signal() -> tuple[np.ndarray, object]:
    """2 channels x 8 hops at 96 kHz (M = 38,400, B = 2^18: 1,789,952
    frames, 18.6 s of audio), and the model."""
    from audio_fir_filter_tpu_torch.models import LowCut

    model = LowCut(freq=15.0, slope=10.0)
    n = MESH_HOPS * model.plan(96000.0, precision="high", device="cuda").hop
    x = _signal(96000.0, 19.0, np.random.default_rng(SEED + 7))[:, :n]
    return np.ascontiguousarray(x), model


def _seam_excerpts(y: np.ndarray, x: np.ndarray, taps, starts, bits: int,
                   offset: int = 0) -> float:
    """Worst error of ``y`` (whose column 0 is frame ``offset`` of the
    whole output) against the float64 oracle of ``x`` on excerpts of
    MESH_EXCERPT frames from each of ``starts`` (whole-output frames)."""
    worst = 0.0
    for c in range(y.shape[0]):
        for i0 in starts:
            i0 = max(offset, min(offset + y.shape[1] - MESH_EXCERPT, i0))
            want = oracle_excerpt(x[c].astype(np.float64), taps, i0,
                                  MESH_EXCERPT).astype(np.float32)
            got = y[c, i0 - offset : i0 - offset + MESH_EXCERPT]
            worst = max(worst, scaled_lsb_error(got, want, bits))
    return worst


def _seam_starts(n: int, t: int) -> list[int]:
    """Head, tail, and an excerpt centred on every seam of ``t`` shards."""
    return [0, *(j * (n // t) - MESH_EXCERPT // 2 for j in range(1, t)),
            n - MESH_EXCERPT]


def _delta(before: dict) -> dict:
    after = _counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _mesh_api(files: dict) -> None:
    """sharded_filter on meshes of cells that all lie on the one card."""
    from audio_fir_filter_tpu_torch import audio
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.parallel import make_mesh, sharded_filter
    from audio_fir_filter_tpu_torch.pipeline import (filter_array_streamed,
                                                     sharded_filter_streamed)

    x, model = _mesh_signal()
    taps = model.taps(96000.0)
    n = x.shape[1]
    xd = torch.from_numpy(x).cuda()
    card0 = torch.device("cuda", 0)
    runs = [(shape, precision, "auto") for precision in ("high", "fast")
            for shape in ((1, 2), (1, 4), (2, 2))] + [((1, 4), "high", "fourstep")]
    for shape, precision, engine in runs:
        bits = 24 if precision == "high" else 16
        mode = "f64" if precision == "high" else "f32"
        plan = model.plan(96000.0, precision=precision, device="cuda",
                          engine=engine)
        ref, ref_peak = osv.same_filter_peak(xd, plan)
        mesh = make_mesh(shape, [card0] * (shape[0] * shape[1]))
        before = _counts()
        y, peak = sharded_filter(xd, plan, mesh)
        torch.cuda.synchronize()
        made = _delta(before)
        cells = shape[0] * shape[1]
        if engine == "auto":
            # One launch of the segment kernel a cell.
            check(made == {f"segment_filter_{mode}": cells},
                  f"mesh {shape} {precision}: launches {made}, want {cells}")
        else:
            per_cell = osv.launches_per_call(plan, 2 // shape[0], n // shape[1])
            check(made == {f"conv_blocks_{mode}": cells * per_cell},
                  f"mesh {shape} {engine}: launches {made}")
        check(y.device == card0 and tuple(y.shape) == (2, n)
              and bool(torch.isfinite(y).all()), f"mesh {shape}: bad output")
        yh, rh = y.cpu().numpy(), ref.cpu().numpy()
        err = scaled_lsb_error(yh, rh, bits)
        seam = _seam_excerpts(yh, x, taps, _seam_starts(n, shape[1]), bits)
        print(f"mesh {shape} {precision} engine={engine}: {cells} cells on "
              f"cuda:0, launches {made}; vs unsharded {err:.4f} LSB@{bits}, "
              f"oracle across every shard seam {seam:.4f} LSB@{bits}; peak "
              f"{peak:.7f} vs unsharded {float(ref_peak):.7f}")
        check(err <= 1.0, f"mesh {shape} {precision}: vs unsharded {err} LSB")
        check(seam <= 1.0, f"mesh {shape} {precision}: oracle seam {seam} LSB")
        check(abs(peak - float(ref_peak)) <= 1e-5 * float(ref_peak),
              f"mesh {shape} {precision}: peak {peak} != {float(ref_peak)}")

    # Edge halos chain two segments of 4 hops, each on a (1, 2) mesh.
    plan = model.plan(96000.0, precision="high", device="cuda")
    mesh = make_mesh((1, 2), [card0] * 2)
    half, mo2 = n // 2, plan.mo2
    y0, p0 = sharded_filter(x[:, :half], plan, mesh,
                            edge_right=x[:, half : half + mo2], auto_scale=False)
    y1, p1 = sharded_filter(x[:, half:], plan, mesh,
                            edge_left=x[:, half - mo2 : half], auto_scale=False)
    yh = torch.cat([y0, y1], dim=1).cpu().numpy()
    ref, ref_peak = osv.same_filter_peak(xd, plan)
    err = scaled_lsb_error(yh, ref.cpu().numpy(), 24)
    seam = _seam_excerpts(yh, x, taps, _seam_starts(n, 4), 24)
    print(f"mesh (1, 2), two segments chained by edge halos: vs unsharded "
          f"{err:.4f} LSB@24, oracle across the segment and shard seams "
          f"{seam:.4f} LSB@24; peak {max(p0, p1):.7f} vs {float(ref_peak):.7f}")
    check(err <= 1.0 and seam <= 1.0, f"chained segments: {err} / {seam} LSB")
    check(abs(max(p0, p1) - float(ref_peak)) <= 1e-5 * float(ref_peak),
          "chained segments: peak differs")

    # File (a)'s samples through the streamed mesh path, as --mesh 1x2
    # would run them on two cards.
    xa = audio.read_audio(files["a"]).samples
    before = _counts()
    t0 = time.perf_counter()
    ys, ps = sharded_filter_streamed(xa, plan, mesh)
    t_mesh = time.perf_counter() - t0
    made = _delta(before)
    t0 = time.perf_counter()
    yr, pr = filter_array_streamed(xa, plan)
    t_one = time.perf_counter() - t0
    err = scaled_lsb_error(ys, yr, 24)
    print(f"sharded_filter_streamed, file (a) {xa.shape[1]} frames x 2 ch on a "
          f"(1, 2) mesh of cuda:0 cells: {t_mesh:.3f} s, launches {made}; "
          f"filter_array_streamed {t_one:.3f} s; {err:.4f} LSB@24, peak "
          f"{ps:.7f} vs {pr:.7f}")
    check(err <= 1.0, f"streamed mesh vs unsharded: {err} LSB@24")
    check(abs(ps - pr) <= 1e-5 * pr, f"streamed mesh peak {ps} != {pr}")
    check(made.get("segment_filter_f64", 0) >= 2 and len(made) == 1,
          f"streamed mesh launches {made}")


def worker_nccl(port: str) -> None:
    """Subprocess: an NCCL group of world size 1, sharded_filter on the
    default (1, 1) mesh (this rank's card), all_reduce(MAX) of the peak."""
    import torch.distributed as dist

    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.parallel import (distributed, make_mesh,
                                                     sharded_filter)

    distributed.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        check(distributed.process_info() == (0, 1)
              and dist.get_backend() == "nccl", "not an NCCL group of 1")
        x, model = _mesh_signal()
        plan = model.plan(96000.0, precision="high", device="cuda")
        mesh = make_mesh((1, 1))
        check(mesh.cells[0][0].device == torch.device("cuda", 0),
              f"default mesh cell {mesh.cells[0][0]}")
        y, peak = sharded_filter(x, plan, mesh)
        top = torch.tensor(peak, dtype=torch.float32, device="cuda")
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        torch.cuda.synchronize()
        ref, ref_peak = osv.same_filter_peak(torch.from_numpy(x).cuda(), plan)
        print(json.dumps({
            "equal": bool(torch.equal(y, ref)),
            "err": scaled_lsb_error(y.cpu().numpy(), ref.cpu().numpy(), 24),
            "peak": peak,
            "reduced": float(top), "ref_peak": float(ref_peak),
            "launches": sf.launches["f64"]}))
    finally:
        distributed.shutdown()


def worker_halo(rank: int, world: int, rendezvous: str) -> None:
    """Subprocess: one cell of a (1, world) mesh on the shared card, in a
    gloo group; this rank's shard against the float64 oracle."""
    import torch.distributed as dist

    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.parallel import (LocalShards, assemble,
                                                     distributed, make_mesh,
                                                     sharded_filter)

    distributed.initialize(f"file://{rendezvous}", world, rank, backend="gloo")
    try:
        check(dist.get_backend() == "gloo", "not a gloo group")
        x, model = _mesh_signal()
        taps = model.taps(96000.0)
        plan = model.plan(96000.0, precision="high", device="cuda")
        n = x.shape[1]
        s = n // world
        mesh = make_mesh((1, world), [(r, "cuda:0") for r in range(world)])
        # Only this rank's slice is real: a halo that did not come from the
        # other process would show as NaN.
        mine = np.full_like(x, np.nan)
        mine[:, rank * s : (rank + 1) * s] = x[:, rank * s : (rank + 1) * s]
        y, peak = sharded_filter(mine, plan, mesh)
        torch.cuda.synchronize()
        check(isinstance(y, LocalShards) and list(y.parts) == [(0, rank)],
              f"rank {rank} holds {y}")
        part = y.parts[(0, rank)]
        check(part.is_cuda and bool(torch.isfinite(part).all()),
              f"rank {rank}: shard not finite (a halo did not arrive)")
        err = _seam_excerpts(part.cpu().numpy(), x, taps,
                             [rank * s, (rank + 1) * s - MESH_EXCERPT // 2,
                              (rank + 1) * s - MESH_EXCERPT], 24,
                             offset=rank * s)
        whole = assemble(y, mesh, dst=0)
        whole_err = None
        if rank == 0:
            whole_err = _seam_excerpts(whole, x, taps, _seam_starts(n, world), 24)
        print(json.dumps({"rank": rank, "err": err, "peak": peak,
                          "whole_err": whole_err,
                          "launches": sf.launches["f64"]}))
    finally:
        distributed.shutdown()


def _workers(argvs: list[list[str]], what: str) -> list[tuple[str, str]]:
    """Run the commands at once; each one's (stdout, stderr). Fails if one
    exits non-zero or outlasts its limit; leaves none running."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT) for a in argvs]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            check(p.returncode == 0,
                  f"{what} {i} exited {p.returncode}: {err[-3000:]}")
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_processes(card: str, files: dict, single: dict, tmp: Path) -> None:
    me = [sys.executable, str(ROOT / "chip_smoke.py"), "--worker"]

    # An NCCL group of world size 1.
    t0 = time.perf_counter()
    (out, _), = _workers([[*me, "nccl", str(_free_port())]], "NCCL worker")
    r = json.loads(out.strip().splitlines()[-1])
    print(f"NCCL group of world size 1 ({time.perf_counter() - t0:.1f} s): "
          f"sharded_filter on the default (1, 1) mesh {r}")
    check(r["err"] <= 1.0, f"(1, 1) mesh under NCCL vs unsharded: {r['err']} LSB@24")
    check(r["peak"] == r["reduced"] and
          abs(r["peak"] - r["ref_peak"]) <= 1e-6 * r["ref_peak"],
          f"NCCL all_reduce(MAX): {r}")
    check(r["launches"] == 2, f"NCCL worker launched {r['launches']} times")

    # Two processes share the card; halos over gloo, staged through the host.
    t0 = time.perf_counter()
    rendezvous = str(tmp / "halo_rendezvous")
    outs = _workers([[*me, "halo", str(rank), "2", rendezvous]
                     for rank in range(2)], "halo worker")
    rows = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    print(f"2 processes on {card}, gloo group, (1, 2) mesh, one cell a rank "
          f"({time.perf_counter() - t0:.1f} s): {rows}")
    for r in rows:
        check(r["err"] <= 1.0, f"rank {r['rank']}: shard vs oracle {r['err']} LSB@24")
        check(r["launches"] == 1, f"rank {r['rank']} launched {r['launches']} times")
    check(rows[0]["peak"] == rows[1]["peak"], "the ranks' peaks differ")
    check(rows[0]["whole_err"] <= 1.0, f"assembled output {rows[0]['whole_err']} LSB")

    # A 2-process batch of (a)-(d) through the CLI.
    t0 = time.perf_counter()
    dest = tmp / "batch_2proc"
    port = _free_port()
    inputs = [files[t] for t in "abcd"]
    outs = _workers([[sys.executable, str(ROOT / "bin" / "lowcut-torch"),
                      *map(str, inputs), str(dest), "-v", "--coordinator",
                      f"127.0.0.1:{port}", "--num-processes", "2",
                      "--process-id", str(rank)] for rank in range(2)],
                    "batch process")
    done = [[ln.split(": ")[1] for ln in out.splitlines()
             if ln.startswith("Processing file: ")] for out, _ in outs]
    check(done == [[inputs[0].name, inputs[2].name],
                   [inputs[1].name, inputs[3].name]],
          f"2-process batch dealt {done}")
    for t in "abcd":
        check(_sha(dest / files[t].name) == _sha(single[t][0]),
              f"2-process batch output of ({t}) differs from its single-file "
              "output")
    print(f"2-process batch of (a)-(d) through the CLI "
          f"({time.perf_counter() - t0:.1f} s): process 0 {done[0]}, process 1 "
          f"{done[1]}; every output byte-identical to its single-file output")


def _mesh_scaling(card: str) -> None:
    cmd = [sys.executable, "-m", "audio_fir_filter_tpu_torch.bench",
           "--scaling", "--reps", "3"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    print(f"--- bench --scaling --reps 3 ({time.perf_counter() - t0:.1f} s, "
          f"exit {r.returncode}) on {card}:")
    print(r.stderr.rstrip())
    check(r.returncode == 0, f"bench --scaling exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    check(len(lines) == 1 and json.loads(lines[0])["value"] > 0,
          f"bench --scaling stdout: {lines}")
    print(f"bench result: {lines[0]}")
    rows = [ln.split() for ln in r.stderr.splitlines()
            if len(ln.split()) == 7 and ln.split()[0].isdigit()]
    check(len(rows) == 12, f"scaling model: {len(rows)} rows, want 2 x 6")
    check(all(0.0 < float(x[4]) <= 1.0 and 0.0 < float(x[6]) <= 1.0
              for x in rows), f"scaling model rows {rows}")
    check(r.stderr.count("model, not measured: one card") >= 3,
          "the scaling model is not marked as a model")
    check(r.stderr.count(f"measured in this run on {card}") == 2,
          "the scaling rates do not name the card and its power limit")
    halo = [ln for ln in r.stderr.splitlines() if "halo exchange (production" in ln]
    check(len(halo) == 1, "no measured halo line")
    print(f"measured halo cost on {card}: {halo[0].strip()}")


def phase_mesh(card: str, files: dict, single: dict, tmp: Path) -> dict:
    """Phase 12. Returns the in-process launches of the mesh paths."""
    _zero_counts()
    for tag in "ab":
        out = _out(files[tag], "mesh11")
        m, wall, made = _timed_cli([str(files[tag]), str(out), "--mesh", "1x1"])
        ref_out, _, ref_made, ref_m = single[tag]
        check(_sha(out) == _sha(ref_out),
              f"--mesh 1x1 output of ({tag}) differs from phase 6's")
        check(made == ref_made, f"--mesh 1x1 on ({tag}) launched {made}, "
              f"phase 6 {ref_made}")
        _print_stages(f"{tag}, --mesh 1x1", m, card)
        _print_stages(f"{tag}, phase 6", ref_m, card)
    print("--mesh 1x1 on (a) and (b): byte-identical to phase 6's outputs, "
          "equal launch counts")
    _mesh_api(files)
    counts = _counts()
    print(f"mesh-path launches (in this process): "
          f"{ {k: v for k, v in counts.items() if v} }")
    for k in ("segment_filter_f64", "segment_filter_f32", "segment_filter_i16",
              "conv_blocks_f64"):
        check(counts[k] > 0, f"kernel {k} never launched on the mesh paths")

    _mesh_processes(card, files, single, tmp)
    _mesh_scaling(card)

    rc, err = _cli_rc([str(files["d"]), str(_out(files["d"], "mesh12")),
                       "--mesh", "1x2"])
    check(rc == 1 and "needs 2 devices, have 1" in err,
          f"--mesh 1x2 on one card exited {rc}: {err}")
    check(not _out(files["d"], "mesh12").exists(), "--mesh 1x2 wrote a file")
    print(f"--mesh 1x2 on one card: exit 1, {err.strip()!r}")
    return counts


# ------------------------------------------- phase 13: the segment pipeline

SLEEP_CYCLES = 4_000_000    # ~2 ms of torch.cuda._sleep at the H100's clocks
PIPE_HOPS = 6               # the many-segment runs: segments of 6 hops


def _edge_slice(x: np.ndarray, g0: int, g1: int) -> np.ndarray:
    """x[:, g0:g1] with zeros outside [0, N)."""
    buf = np.zeros((x.shape[0], g1 - g0), x.dtype)
    s0, s1 = max(0, g0), min(x.shape[1], g1)
    if s1 > s0:
        buf[:, s0 - g0 : s1 - g0] = x[:, s0:s1]
    return buf


def _segments(n: int, seg: int):
    return [(s, min(n, s + seg)) for s in range(0, n, seg)]


def sync_streamed(x: np.ndarray, plan, seg: int):
    """The synchronous loop that ``filter_array_streamed`` ran before it
    kept a segment in flight: each segment sliced on the host, copied up
    from pageable memory, filtered, copied back and its peak read before
    the next."""
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv

    out, peak, mo2 = np.empty_like(x), 0.0, plan.mo2
    for s, e in _segments(x.shape[1], seg):
        xe = torch.from_numpy(_edge_slice(x, s - mo2, e + mo2)).to(plan.device)
        y, p = osv.extended_filter_peak(xe, plan, e - s)
        out[:, s:e] = y.cpu().numpy()
        peak = max(peak, float(p))
    return out, peak


def sync_streamed_i16(x16: np.ndarray, plan, seg: int):
    """The synchronous loop of ``filter_array_streamed_i16`` before."""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    c, n = x16.shape
    out, peak, mo2 = np.empty_like(x16), 0, plan.mo2
    for s, e in _segments(n, seg):
        if (s, e) == (0, n):
            xe, left = x16, mo2
        else:
            xe, left = _edge_slice(x16, s - mo2, e + mo2), 0
        xd = torch.from_numpy(np.ascontiguousarray(xe)).to(plan.device)
        y, p = sf.segment_filter(xd, plan, left, e - s, i16_io=True)
        out[:, s:e] = y.cpu().numpy()
        peak = max(peak, int(p))
    return out, peak, peak >= 32767


def sync_sharded(x: np.ndarray, plan, mesh, seg: int):
    """The synchronous loop of ``sharded_filter_streamed`` before, at a
    segment length already rounded by it (a multiple of t * hop)."""
    from audio_fir_filter_tpu_torch.parallel import sharded_filter

    c, n = x.shape
    mo2 = plan.mo2
    out, peak = np.empty_like(x), 0.0
    for s, e in _segments(n, seg):
        y, p = sharded_filter(_edge_slice(x, s, s + seg), plan, mesh,
                              edge_left=_edge_slice(x, s - mo2, s),
                              edge_right=_edge_slice(x, s + seg, s + seg + mo2),
                              auto_scale=False, valid=(c, e - s))
        out[:, s:e] = y[:c, : e - s].cpu().numpy()
        peak = max(peak, p)
    return out, peak


@contextlib.contextmanager
def _delayed_launches(cycles: int):
    """A ``torch.cuda._sleep(cycles)`` queued before every launch of both
    program kernels: each segment's kernel, and so its download, lands
    later, so a drain that did not wait for its event would read a stale
    pinned buffer."""
    from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    real = {sf: sf._launch, cb: cb._launch}

    def delayed(launch):
        def run(*args, **kwargs):
            torch.cuda._sleep(cycles)
            return launch(*args, **kwargs)
        return run

    for mod, launch in real.items():
        mod._launch = delayed(launch)
    try:
        yield
    finally:
        for mod, launch in real.items():
            mod._launch = launch


def _timed_call(fn):
    """(result, host seconds, launches made) of ``fn()``; the result is on
    the host, so the card's work is done."""
    before = _counts()
    t0 = time.perf_counter()
    r = fn()
    wall = time.perf_counter() - t0
    return r, wall, _delta(before)


def _same(tag: str, piped, sync) -> None:
    """Pipelined and synchronous results and launches must be equal."""
    (ry, tp, mp), (rs, ts, ms) = piped, sync
    check(bool(np.array_equal(ry[0], rs[0])),
          f"{tag}: pipelined output differs from the synchronous loop's")
    check(ry[1:] == rs[1:], f"{tag}: pipelined peak {ry[1:]} != {rs[1:]}")
    check(mp == ms and mp, f"{tag}: launches {mp} pipelined, {ms} synchronous")
    print(f"{tag}: byte-identical, peak {ry[1]}, launches {mp}; "
          f"pipelined {tp:.3f} s, synchronous {ts:.3f} s")


def worker_pin(frames: str) -> None:
    """Subprocess: seconds to allocate, in a fresh process, the pinned
    buffers that one streamed call of ``frames`` x 2 float32 frames a
    segment takes (two slots of input with halos, two of output), then the
    same four again from PyTorch's caching host allocator."""
    from audio_fir_filter_tpu_torch.models import LowCut

    plan = LowCut().plan(96000.0, precision="high", device="cuda")
    seg = int(frames)
    torch.zeros(1, device="cuda")
    sizes = [2 * (seg + plan.m), 2 * (seg + plan.m), 2 * seg, 2 * seg]

    def alloc():
        t0 = time.perf_counter()
        bufs = [torch.empty(n, dtype=torch.float32, pin_memory=True)
                for n in sizes]
        return time.perf_counter() - t0, bufs

    first, bufs = alloc()
    del bufs
    again, _ = alloc()
    print(json.dumps({"bytes": 4 * sum(sizes), "first_s": first,
                      "cached_s": again}))


def phase_pipeline(card: str, files: dict) -> None:
    """Phase 13: the streamed routes keep one segment in flight. Each is
    byte-identical to the synchronous loop it replaced, with equal launch
    counts: file (a) at the default segment, at 6 hops (dozens of
    segments) and at 6 hops with every launch delayed; file (b) on the
    16-bit route at the default segment (one) and at 6 hops, delayed too;
    ``--engine fourstep`` f64 on (a) and f32 on (b) at 6 hops; a (1, 2)
    mesh of cuda:0 cells on (a). Then three interleaved timings of
    pipelined and synchronous ``filter`` on (a) (default segment and 6
    hops) and (b), device memory, and the pinned allocation in a fresh
    process."""
    from audio_fir_filter_tpu_torch import audio
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.parallel import make_mesh
    from audio_fir_filter_tpu_torch.pipeline.stream import (
        default_segment_len, filter_array_streamed, filter_array_streamed_i16,
        sharded_filter_streamed)

    t_phase = time.perf_counter()
    xa = audio.read_audio(files["a"]).samples
    xb = audio.read_audio(files["b"]).samples
    xb16 = np.asarray(xb * np.float32(32768.0), np.int16)
    high = LowCut().plan(96000.0, precision="high", device="cuda")
    fast = LowCut().plan(44100.0, precision="fast", device="cuda")
    seg_a = default_segment_len(high, channels=2)
    seg_b = default_segment_len(fast, channels=2)
    six_a, six_b = PIPE_HOPS * high.hop, PIPE_HOPS * fast.hop
    print(f"(a) {xa.shape[1]} frames: default segment {seg_a} frames "
          f"({len(_segments(xa.shape[1], seg_a))} segments), 6 hops {six_a} "
          f"({len(_segments(xa.shape[1], six_a))}); (b) {xb.shape[1]} frames: "
          f"default {seg_b} ({len(_segments(xb.shape[1], seg_b))}), 6 hops "
          f"({len(_segments(xb.shape[1], six_b))})")

    runs = [
        ("(a) high", lambda: filter_array_streamed(xa, high),
         lambda: sync_streamed(xa, high, seg_a), False),
        ("(a) high, 6 hops", lambda: filter_array_streamed(xa, high, six_a),
         lambda: sync_streamed(xa, high, six_a), False),
        ("(a) high, 6 hops, launches delayed",
         lambda: filter_array_streamed(xa, high, six_a),
         lambda: sync_streamed(xa, high, six_a), True),
        ("(b) i16", lambda: filter_array_streamed_i16(xb16, fast),
         lambda: sync_streamed_i16(xb16, fast, seg_b), False),
        ("(b) i16, 6 hops, launches delayed",
         lambda: filter_array_streamed_i16(xb16, fast, six_b),
         lambda: sync_streamed_i16(xb16, fast, six_b), True),
    ]
    four_a = LowCut().plan(96000.0, precision="high", device="cuda",
                           engine="fourstep")
    four_b = LowCut().plan(44100.0, precision="fast", device="cuda",
                           engine="fourstep")
    seg_fa = default_segment_len(four_a, channels=2)
    runs += [
        ("(a) fourstep f64", lambda: filter_array_streamed(xa, four_a),
         lambda: sync_streamed(xa, four_a, seg_fa), False),
        ("(b) fourstep f32, 6 hops", lambda: filter_array_streamed(
            xb, four_b, PIPE_HOPS * four_b.hop),
         lambda: sync_streamed(xb, four_b, PIPE_HOPS * four_b.hop), False),
    ]
    mesh = make_mesh((1, 2), [torch.device("cuda", 0)] * 2)
    quantum = 2 * high.hop
    seg_m = -(-seg_a // quantum) * quantum
    runs.append(("(a) mesh (1, 2) of cuda:0 cells",
                 lambda: sharded_filter_streamed(xa, high, mesh),
                 lambda: sync_sharded(xa, high, mesh, seg_m), False))
    for tag, piped, sync, delayed in runs:
        with _delayed_launches(SLEEP_CYCLES) if delayed else contextlib.nullcontext():
            _same(tag, _timed_call(piped), _timed_call(sync))

    # Interleaved timings of filter (host clock, results on the host).
    timed = {"(a)": (lambda: filter_array_streamed(xa, high),
                     lambda: sync_streamed(xa, high, seg_a)),
             "(a), 6 hops": (lambda: filter_array_streamed(xa, high, six_a),
                             lambda: sync_streamed(xa, high, six_a)),
             "(b) i16": (lambda: filter_array_streamed_i16(xb16, fast),
                         lambda: sync_streamed_i16(xb16, fast, seg_b))}
    for tag, (piped, sync) in timed.items():
        t = {"pipelined": [], "synchronous": []}
        for order in ("ps", "sp", "ps"):
            for side in order:
                name = "pipelined" if side == "p" else "synchronous"
                t[name].append(_timed_call(piped if side == "p" else sync)[1])
        print(f"filter {tag} on {card}: pipelined median "
              f"{np.median(t['pipelined']):.4f} s {t['pipelined']}, "
              f"synchronous median {np.median(t['synchronous']):.4f} s "
              f"{t['synchronous']}")

    for tag, fn in (("pipelined", lambda: filter_array_streamed(xa, high)),
                    ("synchronous", lambda: sync_streamed(xa, high, seg_a))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        print(f"(a) {tag}: device memory peak "
              f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB above "
              f"the {held / 1e9:.3f} GB held before (earlier phases' tables)")

    (out, _), = _workers([[sys.executable, str(ROOT / "chip_smoke.py"),
                           "--worker", "pin", str(seg_a)]], "pin worker")
    r = json.loads(out.strip().splitlines()[-1])
    print(f"pinned buffers of one streamed call of (a) in a fresh process on "
          f"{card}: {r['bytes'] / 1e6:.1f} MB in {r['first_s']:.4f} s, "
          f"again from the caching host allocator {r['cached_s']:.6f} s")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------- phase 14: the breakdown scripts

def phase_breakdown(card: str, tmp: Path) -> None:
    """Phase 14: ``segment_decomp`` and ``chunk_sweep`` in-process at the
    bench's headline shape (both engines' kernels must launch), then
    ``batch_cfg4``'s 64-file batch through the CLI in a subprocess."""
    from audio_fir_filter_tpu_torch.experiments import (batch_cfg4,
                                                        chunk_sweep,
                                                        segment_decomp)

    t0 = time.perf_counter()
    _zero_counts()
    for mod in (segment_decomp, chunk_sweep):
        print("\n".join(mod.run("cuda", reps=3)["lines"]))
    counts = _counts()
    print(f"breakdown launches on {card}: { {k: v for k, v in counts.items() if v} }")
    for k in ("segment_filter_f64", "segment_filter_f32", "conv_blocks_f64",
              "conv_blocks_f32"):
        check(counts[k] > 0, f"kernel {k} never launched by the breakdown scripts")
    r = batch_cfg4.run(tmp / "cfg4", "cuda")
    check(r["outputs"] == batch_cfg4.N_FILES,
          f"batch_cfg4 wrote {r['outputs']} outputs")
    print("\n".join(r["lines"]))
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")


SKIPPABLE = {3, 4, 5, 7, 9, 10, 11, 12, 14}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", default="",
                    help="phases to leave out, of 3,4,5,7,9,10,11,12,14 "
                         "(no result line is printed)")
    ap.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        check(torch.cuda.is_available(), "no CUDA card")
        kind, *rest = args.worker
        if kind == "nccl":
            worker_nccl(*rest)
        elif kind == "pin":
            worker_pin(*rest)
        else:
            worker_halo(int(rest[0]), int(rest[1]), rest[2])
        return 0
    skip = {int(p) for p in args.skip.split(",") if p}
    check(skip <= SKIPPABLE, f"--skip takes {sorted(SKIPPABLE)}")

    env = phase_environment()
    phase_build()
    if 3 not in skip:
        kernels = phase_kernels()
    if 4 not in skip:
        phase_edge_shapes()
    if 5 not in skip:
        conv = phase_conv_kernels()
        phase_conv_edge_shapes()
    with tempfile.TemporaryDirectory(prefix="lowcut_smoke_") as tmp:
        tmp = Path(tmp)
        files = make_inputs(tmp)
        main_path = phase_main_path(env["card"], files)
        if 7 not in skip:
            four = phase_fourstep(env["card"], files)
        single = phase_batch(env["card"], files, main_path["single"], tmp)
        if 9 not in skip:
            probes = phase_probes(env["card"])
        if 10 not in skip:
            phase_bench(env["card"])
        if 11 not in skip:
            phase_profile(env["card"], files, tmp)
        if 12 not in skip:
            mesh = phase_mesh(env["card"], files, single, tmp)
        phase_pipeline(env["card"], files)
        if 14 not in skip:
            phase_breakdown(env["card"], tmp)
    if skip:
        print(f"partial run: phases {sorted(skip)} skipped; no result line")
        return 0
    rows = [{"name": f"segment_filter_{mode}", "route": "cuda",
             "source": SEGMENT_SOURCE, "replaces": SEGMENT_REPLACES,
             "launches": main_path["counts"][f"segment_filter_{mode}"],
             "mesh_launches": mesh[f"segment_filter_{mode}"],
             **kernels[mode]}
            for mode, *_ in MODES]
    rows += [{"name": f"conv_blocks_{mode}", "route": "cuda",
              "source": CONV_SOURCE, "replaces": CONV_REPLACES,
              "launches": four[f"conv_blocks_{mode}"],
              "mesh_launches": mesh[f"conv_blocks_{mode}"], **conv[mode]}
             for mode, *_ in CONV_MODES]
    rows += [{**row, "mesh_launches": mesh[name]} for name, row in probes.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
