"""The block path's ``conv_chunk``, swept on the card, beside the segment
kernel.

Counterpart of ``experiments/chunk_sweep.py``, which timed the fused Pallas
block convolution (``pallas_conv_real_blocks``) on chunks of 8, 16, 32 and
64 real blocks of B = 2^18 against the XLA four-step engine, in f32 and
df64. On the card, in f32 and f64 (the port's ``fast`` and ``high``):

- the block kernel alone (``ops.conv_blocks.conv_real_blocks``) on each
  chunk, beside the segment kernel (``ops.segment_filter.segment_filter``)
  filtering the same number of hops on one channel, which is the same
  count of B-point blocks;
- the block path's whole headline call (2 channels x 1008 hops at 96 kHz,
  ``-f 15 -s 10``) through ``ops.overlap_save.extended_filter_peak`` with
  ``make_plan(conv_chunk=...)`` at each chunk, beside the segment kernel's
  call on the same input, with the device memory of each.

The XLA engine has no counterpart (the port has one block kernel for
``fourstep``, ``pease`` and ``stockham``). Times are device times with CUDA
events; ``--device cpu`` runs the plain versions at a small size and prints
host-clock times, which are not card numbers.

    python -m audio_fir_filter_tpu_torch.experiments.chunk_sweep
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import bench
from ..ops import conv_blocks as cb
from ..ops import overlap_save as osv
from ..ops import segment_filter as sf
from ..utils.device import resolve_device
from . import _probe
from .segment_decomp import HEADLINE_HOPS, alloc_peak, timer

CHUNKS = (8, 16, 32, 64)


def run(device="cuda", chunks=CHUNKS, hops: int = HEADLINE_HOPS,
        reps: int = 5, freq: float = 15.0, slope: float = 10.0,
        fs: float = 96000.0, block_size: int = 0) -> dict:
    """Both tables, f32 and f64. Returns the printed ``lines``."""
    dev = resolve_device(device)
    ms_of, unit = timer(dev)
    taps = _probe.bench_taps(freq, slope, fs)
    kern, call = [], []
    for precision, mode in ((osv.FAST, "f32"), (osv.HIGH, "f64")):
        seg_plan = osv.make_plan(taps, precision, block_size, dev)
        b, m, hop = seg_plan.block_size, seg_plan.m, seg_plan.hop
        for k in chunks:
            plan = osv.make_plan(taps, precision, block_size, dev, "fourstep", k)
            blocks = bench._signal(k * b, dev).reshape(k, b)
            t = ms_of(lambda: cb.conv_real_blocks(blocks, plan), reps)
            x1 = bench._signal(k * hop + m, dev).reshape(1, -1)
            ts = ms_of(lambda: sf.segment_filter(x1, seg_plan, 0, k * hop), reps)
            kern.append([mode, k, t, k * b / (t * 1e-3) / 1e9, ts, t / ts])
            del blocks, x1
        seg = hops * hop
        xe = bench._signal(2 * (seg + m), dev).reshape(2, seg + m)
        ts = ms_of(lambda: osv.extended_filter_peak(xe, seg_plan, seg), reps)
        gs = alloc_peak(lambda: osv.extended_filter_peak(xe, seg_plan, seg), dev)
        for k in chunks:
            plan = osv.make_plan(taps, precision, block_size, dev, "fourstep", k)
            t = ms_of(lambda: osv.extended_filter_peak(xe, plan, seg), reps)
            g = alloc_peak(lambda: osv.extended_filter_peak(xe, plan, seg), dev)
            call.append([mode, k, osv.launches_per_call(plan, 2, seg), t,
                         2 * seg / (t * 1e-3) / 1e9, g, ts, gs])
        del xe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    where = f"B = {b}, M = {m}, on {bench.device_name(dev)}, {unit}, median of {reps}"
    lines = _probe.table(
        f"chunk_sweep: the block kernel on k real blocks vs the segment kernel "
        f"on k hops of one channel ({where})",
        ["mode", "k", "block ms", "Gsamples/s raw", "segment ms", "block / segment"],
        kern)
    lines += _probe.table(
        f"chunk_sweep: the block path's call of 2 ch x {hops} hops at each "
        f"conv_chunk vs the segment kernel's ({where}; GB allocated above the "
        "input)",
        ["mode", "conv_chunk", "launches", "ms", "Gsamples/s", "GB",
         "segment ms", "segment GB"], call)
    return {"lines": lines}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", default=",".join(map(str, CHUNKS)),
                    help="real blocks per block-kernel call (even)")
    ap.add_argument("--hops", type=int, default=HEADLINE_HOPS)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--freq", type=float, default=15.0)
    ap.add_argument("--slope", type=float, default=10.0)
    ap.add_argument("--sample-rate", type=float, default=96000.0)
    ap.add_argument("--block-size", type=int, default=0)
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    chunks = tuple(int(k) for k in a.chunks.split(","))
    r = run(a.device, chunks, a.hops, a.reps, a.freq, a.slope, a.sample_rate,
            a.block_size)
    print("\n".join(r["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
