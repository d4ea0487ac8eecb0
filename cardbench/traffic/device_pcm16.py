"""Traffic kind ``device_pcm16``: a caller that holds a long 16-bit PCM
recording as an int16 tensor on the card and filters it with one call, in
a closed loop, on the route a 16-bit file takes: int16 PCM into and out
of the segment kernel's i16 mode.

Input: the seeded signal of the ``device`` kind (``inputs.signal``), made
on the card and quantized to int16 by the codec's rule
(``reference/pcm16``). Job: ``ops/overlap_save.same_filter_peak`` on that
[channels, frames] int16 tensor with the plan that the configuration's
model makes for its rate and precision; the harness's ``filter`` span
carries ``sample_bytes=2``. Latency: CUDA events around the call, from
enqueue until the output and the peak are ready; the job waits for them
before the next one starts. The two events are made once, in set-up,
and recorded anew by every job: made per job, they put tens of
microseconds of host work on the closed loop's path, time in which the
card waits and which the host's own pace varies from run to run. The
previous output is released before each call, as a caller that consumes
each result does.

Judged after the window: the last call's whole output against the float64
reference in codes, clamped to the rails; the peak of every call (the
same input gives the same peak); the last peak against the largest
|value| of that clamped reference and against the max |code| of the last
output itself.

Parameters: ``channels``, ``frames``, ``peak_dbfs``, ``rumble_hz``.
"""

from __future__ import annotations

import time

import torch

from .. import inputs
from ..reference import convolve, pcm16
from . import device

# The last output and every call's peak, kept as the device kind keeps them.
finish = device.finish


def setup(ctx) -> dict:
    from audio_fir_filter_tpu_torch.models import make_model

    cfg, p = ctx.cfg, ctx.params
    fs = float(cfg["format"]["sample_rate"])
    x = inputs.signal(ctx.seed, (p["channels"], p["frames"]), fs, p, ctx.device)
    x16 = pcm16.quantize(x).to(torch.int16)
    del x
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    f = cfg["filter"]
    model = make_model(f["type"], f["freq_hz"], f["slope_hz"])
    plan = model.plan(fs, precision=cfg["precision"], device=ctx.device)
    st = {"x": x16, "plan": plan, "y": None, "peaks": [],
          "ev": device._events(ctx.device)}
    job(ctx, st)                          # warm-up: builds and loads the kernels
    st["peaks"].clear()
    return st


def job(ctx, st) -> None:
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv

    x = st["x"]
    c, n = x.shape
    st["y"] = None
    ev = st["ev"]
    with ctx.rec.span("filter", channels=c, frames=n, sample_bytes=2):
        if ev:
            ev[0].record()
        else:
            t0 = time.perf_counter()
        y, peak = osv.same_filter_peak(x, st["plan"])
        if ev:
            ev[1].record()
            ev[1].synchronize()
            latency = ev[0].elapsed_time(ev[1]) / 1e3
        else:
            latency = time.perf_counter() - t0
    st["y"] = y
    st["peaks"].append(peak)
    ctx.rec.job(latency, c * n, clock="device" if ev else "host")


def control(ctx, st, precision: str) -> dict:
    """The reference in the program's place at ``precision``, quantized by
    the codec's rule."""
    y = pcm16.same_fir_codes(st["x"], device._taps(ctx.cfg), precision)
    return {"y": y, "peaks": torch.tensor([pcm16.peak(y)], dtype=torch.float32)}


def check(ctx, st, out) -> tuple[dict, int]:
    """``(numbers, failed)``. Numbers compared:

    - ``err_lsb``: the largest gap, in LSB at 16 bits, of an answer of the
      last call to the float64 reference in codes clamped to the rails,
      before rounding: every output code, and the returned peak to the
      largest |value| of that reference (a sound run reads the codec's
      half LSB plus the arithmetic's error on both; against the rounded
      reference's peak, a largest value within that error of a rounding
      boundary would read a whole LSB). An output that is not int16 (a
      route that converted to float) reads infinity;
    - ``peaks_differ``: the calls whose peak is not the last call's;
    - ``peak_not_max``: 1 where the last call's peak is not the max |code|
      of its own output, else 0.

    ``failed``: calls found wrong."""
    x, y = st["x"], out["y"]
    peaks = out["peaks"].to(torch.float64)
    last = float(peaks[-1]) if len(peaks) else float("nan")
    if y.dtype != torch.int16:
        err = float("inf")
    else:
        gap = torch.zeros((), dtype=torch.float64, device=x.device)
        ref_peak = 0.0
        for s, e, c in convolve.same_fir_blocks(x, device._taps(ctx.cfg)):
            ref = pcm16.rails(c)
            gap = torch.maximum(gap, (y[:, s:e].to(torch.float64) - ref).abs().max())
            ref_peak = max(ref_peak, pcm16.peak(ref))
        err = max(float(gap), abs(last - ref_peak), key=lambda v: (v != v, v))
    nums = {"err_lsb": err, "peaks_differ": int((peaks != last).sum()),
            "peak_not_max": int(not last == pcm16.peak(y))}
    wrong = not nums["err_lsb"] <= ctx.limits["err_lsb"]
    return nums, nums["peaks_differ"] + nums["peak_not_max"] + wrong
