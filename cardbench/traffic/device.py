"""Traffic kind ``device``: a caller that holds a long recording as a
tensor on the card and filters it with one call, in a closed loop.

Job: ``ops/overlap_save.same_filter_peak`` on the card-resident float32
signal [channels, frames] (seeded, made on the card), with the plan that
the configuration's model makes for its rate and precision. Latency:
CUDA events around the call, from enqueue until the output and the peak
are ready; the job waits for them before the next one starts. The
previous output is released before each call, as a caller that consumes
each result does.

Judged after the window: the last call's whole output against the float64
reference, the peak of every call (the same input gives the same peak),
and the last peak against the reference's.

Parameters: ``channels``, ``frames``, ``peak_dbfs``, ``rumble_hz``.
"""

from __future__ import annotations

import time

import torch

from .. import inputs
from ..reference import convolve, design


def _taps(cfg):
    f = cfg["filter"]
    return design.lowcut_taps(f["freq_hz"], f["slope_hz"],
                              float(cfg["format"]["sample_rate"]))


def setup(ctx) -> dict:
    from audio_fir_filter_tpu_torch.models import make_model

    cfg, p = ctx.cfg, ctx.params
    fs = float(cfg["format"]["sample_rate"])
    x = inputs.signal(ctx.seed, (p["channels"], p["frames"]), fs, p, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    f = cfg["filter"]
    model = make_model(f["type"], f["freq_hz"], f["slope_hz"])
    plan = model.plan(fs, precision=cfg["precision"], device=ctx.device)
    st = {"x": x, "plan": plan, "y": None, "peaks": []}
    job(ctx, st)                          # warm-up: builds and loads the kernels
    st["peaks"].clear()
    return st


def _events(device):
    if device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def job(ctx, st) -> None:
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv

    x = st["x"]
    c, n = x.shape
    st["y"] = None
    ev = _events(ctx.device)
    with ctx.rec.span("filter", channels=c, frames=n, sample_bytes=4):
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


def finish(ctx, st) -> dict:
    peaks = torch.stack(st["peaks"]).cpu() if st["peaks"] else torch.zeros(0)
    out = {"y": st.pop("y"), "peaks": peaks}
    st.pop("plan")
    return out


def control(ctx, st, precision: str) -> dict:
    """The reference in the program's place at ``precision``."""
    y = convolve.same_fir(st["x"], _taps(ctx.cfg), precision).to(torch.float32)
    return {"y": y, "peaks": y.abs().max().reshape(1).cpu()}


def check(ctx, st, out) -> tuple[dict, int]:
    """``(numbers, failed)``. Numbers compared: ``err_lsb``, the largest gap
    of an answer of the last call to its float64 reference, in LSB at the
    configuration's bit depth: every output sample and the peak (a NaN
    anywhere makes it NaN, which fails); ``peaks_differ``, the calls whose
    peak is not the last call's (the same input gives the same peak).
    ``failed``: calls found wrong."""
    x, y = st["x"], out["y"]
    lsb = float(1 << (ctx.cfg["format"]["bits"] - 1))
    err = torch.zeros((), dtype=torch.float64, device=x.device)
    ref_peak = torch.zeros((), dtype=torch.float64, device=x.device)
    for s, e, yr in convolve.same_fir_blocks(x, _taps(ctx.cfg)):
        err = torch.maximum(err, (y[:, s:e].to(torch.float64) - yr).abs().max())
        ref_peak = torch.maximum(ref_peak, yr.abs().max())
    peaks = out["peaks"].to(torch.float64)
    last = peaks[-1] if len(peaks) else torch.tensor(float("nan"))
    err = max(float(err), abs(float(last) - float(ref_peak)),
              key=lambda v: (v != v, v))                   # NaN is the worst
    nums = {"err_lsb": err * lsb, "peaks_differ": int((peaks != last).sum())}
    return nums, nums["peaks_differ"] + (not nums["err_lsb"] <= ctx.limits["err_lsb"])
