"""Roofline model of the port's filters on one H100: the least device time
for a piece of work, from the bytes it must move and the flops it must do.

The work is counted from the plan alone, so it reads the same whatever
implements it: each input sample read once and each output sample written
once, and per hop of output per channel one real forward and one real
inverse FFT of B points at 2.5 B log2 B flops each, plus (B/2 + 1) complex
multiplies at 6 flops. The bench's ``--roofline`` report, the probes'
bounds and chip_smoke.py's kernels line all read it from here.
"""

from __future__ import annotations

import math

from .segment_filter import FAST, HIGH

# NVIDIA's H100 SXM data sheet: the HBM3 rate and the float32 and float64
# peaks outside the tensor cores. ``high`` computes in float64 on the card,
# and ``csrc/`` issues no tensor-core instruction, so the FP64 tensor
# cores' 67 TFLOP/s is not a rate its kernels can reach.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {FAST: 67e12, HIGH: 34e12}
PEAK_NAMES = {FAST: "f32 outside the tensor cores",
              HIGH: "f64 outside the tensor cores"}


def fft_conv_flops(b: int, blocks: float) -> float:
    """Flops of ``blocks`` overlap-save blocks of B points: one real forward
    and one real inverse FFT at 2.5 B log2 B each, and (B/2 + 1) complex
    multiplies at 6 flops."""
    return blocks * (5.0 * b * math.log2(b) + 6.0 * (b // 2 + 1))


def roofline(nbytes: float, flops: float, precision: str) -> dict:
    """Least device seconds for ``nbytes`` of device-memory traffic and
    ``flops`` at ``precision``'s peak: the larger of the two bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[precision]
    return {"bytes": nbytes, "flops": flops, "bytes_s": t_bytes,
            "ops_s": t_ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_keys(r: dict) -> dict:
    """A :func:`roofline` as chip_smoke.py's kernels line gives it:
    ``bound_ms`` and ``bound_by``."""
    return {"bound_ms": r["bound_s"] * 1e3, "bound_by": r["bound_by"]}


def bound(nbytes: float, flops: float, mode: str) -> dict:
    """:func:`bound_keys` of ``nbytes`` and ``flops`` at the peak of a
    kernel mode ("f32" or "f64")."""
    return bound_keys(roofline(nbytes, flops, HIGH if mode == "f64" else FAST))


def work(plan, channels: int, in_frames: int, out_frames: int,
         sample_bytes: int = 4) -> dict:
    """The roofline of filtering ``channels`` x ``out_frames`` from
    ``in_frames`` input frames per channel with ``plan``: each input sample
    read once and each output sample written once at ``sample_bytes``, and
    :func:`fft_conv_flops` for out_frames / hop blocks per channel."""
    nbytes = sample_bytes * channels * (in_frames + out_frames)
    flops = fft_conv_flops(plan.block_size, channels * out_frames / plan.hop)
    return {**roofline(nbytes, flops, plan.precision),
            "samples": channels * out_frames}
