"""Where the bench's headline call spends its time, stage by stage, for both
engines.

Counterpart of ``experiments/segment_decomp.py``, which split the JAX
production segment path into the block gather, the convolution and the
unfold, per engine. On the card, at the bench's headline shape (2 channels
x 1008 hops at 96 kHz, ``-f 15 -s 10``: M = 38,400, B = 2^18, ``high``):

- the segment engine (``pallas``): its kernel alone
  (``ops.segment_filter.segment_filter``) against
  ``ops.overlap_save.extended_filter_peak``, which adds the wrapper's host
  work (device time with CUDA events, and host time per call);
- the block path (``--engine fourstep``), the stages of
  ``ops.overlap_save._block_filter_peak`` one by one: the window copy
  (``windows(...).contiguous()``), the ``conv_chunk`` block-kernel launches
  with their ``[:, m:]`` slices and ``torch.cat``, and the join and peak,
  each against the whole call, with the device memory each allocates above
  what was held before it. The stages' output is held bitwise against the
  whole call's.

On the card every time is device time (``_probe.event_ms``); a run with
``--device cpu`` (the plain versions, at a small size for the tests) prints
the host clock's times and says so: they are not card numbers.

    python -m audio_fir_filter_tpu_torch.experiments.segment_decomp
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from .. import bench
from ..ops import conv_blocks as cb
from ..ops import overlap_save as osv
from ..ops import segment_filter as sf
from ..utils.device import resolve_device
from . import _probe

HEADLINE_HOPS = 1008


def timer(dev: torch.device):
    """(ms of ``fn``, a label of what it measures): device time with CUDA
    events on the card; the host clock's median on the CPU."""
    if dev.type == "cuda":
        return _probe.event_ms, "device ms (CUDA events)"

    def host_ms(fn, reps: int = 5) -> float:
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return host_ms, "host ms (CPU run: not a card time)"


def alloc_peak(fn, dev: torch.device):
    """Device bytes ``fn()`` allocates above what was held before it, at
    its peak; "not measured" on the CPU."""
    if dev.type != "cuda":
        return "not measured"
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    r = fn()
    torch.cuda.synchronize(dev)
    del r
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def run(device="cuda", hops: int = HEADLINE_HOPS, reps: int = 5,
        freq: float = 15.0, slope: float = 10.0, fs: float = 96000.0,
        block_size: int = 0) -> dict:
    """The stage tables of both engines on 2 channels x ``hops`` hops.
    Returns the printed ``lines``."""
    dev = resolve_device(device)
    ms_of, unit = timer(dev)
    taps = _probe.bench_taps(freq, slope, fs)
    rows = []

    plan = osv.make_plan(taps, osv.HIGH, block_size, dev)
    b, m, hop = plan.block_size, plan.m, plan.hop
    seg = hops * hop
    c = 2
    xe = bench._signal(c * (seg + m), dev).reshape(c, seg + m)
    title = (f"{c} ch x {hops} hops ({c * seg} samples), M = {m}, B = {b}, "
             f"{osv.HIGH}, on {bench.device_name(dev)}")

    kernel = lambda: sf.segment_filter(xe, plan, 0, seg)           # noqa: E731
    whole = lambda: osv.extended_filter_peak(xe, plan, seg)       # noqa: E731
    t_k, t_w = ms_of(kernel, reps), ms_of(whole, reps)
    host = ([f"{_probe.host_us_per_call(f, 20) / 1e3:.4f}" for f in (kernel, whole)]
            if dev.type == "cuda" else ["-", "-"])
    rows.append(["segment", "kernel alone", t_k, t_k / t_w, host[0],
                 alloc_peak(kernel, dev)])
    rows.append(["segment", "extended_filter_peak", t_w, 1.0, host[1],
                 alloc_peak(whole, dev)])

    plan = osv.make_plan(taps, osv.HIGH, block_size, dev, "fourstep")
    nb = osv.block_count(plan, seg)
    step = plan.conv_chunk

    def window_copy():
        return sf.windows(xe, b, hop, 0, nb).contiguous().view(c * nb, b)

    blocks = window_copy()

    def convolve():
        return torch.cat([cb.conv_real_blocks(blocks[i: i + step], plan)[:, m:]
                          for i in range(0, blocks.shape[0], step)])

    yb = convolve()

    def join_peak():
        y = yb.view(c, nb * hop)[:, :seg].contiguous()
        return y, y.abs().amax()

    y, peak = join_peak()
    want = osv.extended_filter_peak(xe, plan, seg)
    if not (torch.equal(y, want[0]) and torch.equal(peak, want[1])):
        raise RuntimeError("block path: the stages do not compose to the call")
    del y, peak, want
    whole = lambda: osv.extended_filter_peak(xe, plan, seg)       # noqa: E731
    t_w = ms_of(whole, reps)
    launches = -(-c * nb // step)
    for name, fn in ((f"window copy [{c * nb}, {b}]", window_copy),
                     (f"{launches} conv_chunk launches + slices + cat", convolve),
                     ("join + peak", join_peak),
                     ("whole call (extended_filter_peak)", whole)):
        t = ms_of(fn, reps)
        rows.append([f"block (fourstep, conv_chunk {step})", name, t, t / t_w,
                     "-", alloc_peak(fn, dev)])
    del blocks, yb, xe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines = _probe.table(
        f"segment_decomp: {title} ({unit}, median of {reps}; host ms per "
        "call over 20 calls, one sync; GB allocated above what was held)",
        ["engine", "stage", "ms", "of whole", "host ms/call", "GB"], rows)
    return {"lines": lines}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hops", type=int, default=HEADLINE_HOPS)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--freq", type=float, default=15.0)
    ap.add_argument("--slope", type=float, default=10.0)
    ap.add_argument("--sample-rate", type=float, default=96000.0)
    ap.add_argument("--block-size", type=int, default=0)
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    r = run(a.device, a.hops, a.reps, a.freq, a.slope, a.sample_rate,
            a.block_size)
    print("\n".join(r["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
