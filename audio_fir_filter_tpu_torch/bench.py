"""Bench contract of the PyTorch/CUDA port: filtering throughput of one
device, in samples/s.

    python3 -m audio_fir_filter_tpu_torch.bench [--device {cuda,cpu}] \\
        [--roofline] [--fidelity] [--all] [--scaling] [...]

Counterpart of the JAX package's root ``bench.py``, with its flags plus
``--device`` (default ``cuda``) and its stdout contract: exactly one JSON
line

    {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N}

where ``value`` is the device-resident throughput of the headline
workload (BASELINE.md: 96 kHz stereo, the default low-cut ``-f 15 -s 10``,
M = 38,400, ``high`` precision) and ``vs_baseline`` = value / (100 x
realtime) (1.92e7 samples/s for stereo 96 kHz). Every report goes to
stderr. Exit 1 with no result line when the device is missing (``cuda``
with no card: there is no fallback to the CPU) or when a part of
``--scaling`` fails; exit 1 after the result line when the fidelity gate
fails.

``--scaling`` adds the report of ``parallel/scaling_bench`` (stderr): the
halo-cost model across cards at the rates this run measured on its device
(``high`` and ``fast``; the link rates are public figures, and the rows a
model: one card cannot show a speed-up), the real ``sharded_filter`` at 1,
2, 4 and 8 cells in this process, and the halo exchange measured between
two processes of a gloo group.

The headline times ``--reps`` calls of ``ops/overlap_save.extended_filter``
on a halo-extended segment made on the device, between two CUDA events
(host clock on the CPU), after one warm-up call. The warm-up's output is
held against the float64 oracle on excerpts (head, the first seam between
scratch chunks or launches, tail) at the precision's gate. The wrappers'
launch counters are read around the warm-up and the timed calls: every call
must have launched the expected kernel (the wrapper takes its plain version
only in place of a launch). The roofline model (``ops/roofline``) counts
the work from the plan alone, so it reads the same whatever implements it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import conv_blocks as cb
from .ops import kernel_design as kd
from .ops import oracle
from .ops import overlap_save as osv
from .ops import roofline
from .ops import segment_filter as sf
from .utils.device import resolve_device

# The share of the card's free memory a timed segment may take.
_MEMORY_SHARE = 0.8
# Frames per oracle excerpt of a timed call's output.
EXCERPT = 4096


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    why there is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else "nvidia-smi failed"


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def fit_segment(plan, channels: int, segment_blocks: int,
                dev: torch.device) -> int:
    """``segment_blocks`` halved (kept even) until ``osv.call_bytes``
    fits in a share of the card's free memory; says so on stderr."""
    need = osv.call_bytes(plan, channels, segment_blocks * plan.hop)
    if dev.type != "cuda":
        log(f"segment: {need / 1e9:.3f} GB reckoned")
        return segment_blocks
    free, _ = torch.cuda.mem_get_info(dev)
    n = segment_blocks
    while n > 2 and osv.call_bytes(plan, channels, n * plan.hop) > _MEMORY_SHARE * free:
        n = max(2, (n // 2) & ~1)
    if n != segment_blocks:
        log(f"segment: {segment_blocks} hops would hold {need / 1e9:.3f} GB, "
            f"more than {_MEMORY_SHARE:.0%} of the card's {free / 1e9:.3f} GB "
            f"free: lowered to {n} hops")
    log(f"segment: {osv.call_bytes(plan, channels, n * plan.hop) / 1e9:.3f} GB "
        f"reckoned of the card's {free / 1e9:.3f} GB free")
    return n


# ---------------------------------------------------------------- timing

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _elapsed_s(fn, reps: int, dev: torch.device) -> float:
    """Seconds for ``reps`` calls of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def _kernel(plan, i16: bool = False) -> tuple[str, dict, str]:
    """(kernel source, its launch counters, the mode ``plan`` launches)."""
    if plan.engine == osv.PALLAS:
        mode = "i16" if i16 else ("f64" if plan.precision == osv.HIGH else "f32")
        return "segment_filter", sf.launches, mode
    return "conv_blocks", cb.launches, "f64" if plan.precision == osv.HIGH else "f32"


def _excerpt_starts(n: int, seam: int) -> list[int]:
    """Head and tail excerpts of ``n`` frames, and one across ``seam`` if
    it lies inside."""
    starts = {0, max(0, n - EXCERPT)}
    if 0 < seam < n:
        starts.add(max(0, min(n - EXCERPT, seam - EXCERPT // 2)))
    return sorted(starts)


def check_excerpts(y: torch.Tensor, x: torch.Tensor, taps: np.ndarray,
                   left: int, bits: int, seam: int, scale: float = 1.0) -> float:
    """Worst error, in scale-relative LSBs at ``bits``, of ``y`` [C, n] =
    the filter of ``x`` [C, n_in] framed with ``left`` zeros (y[i] =
    sum_k h[k] x[i - left + k], x zero outside), against the float64 oracle
    on excerpts of each channel: head and tail, and in channel 0 the frame
    ``seam`` where a call's first scratch chunk or launch ends. ``scale``
    divides both sides (int16 codes). Raises if it exceeds 1 LSB."""
    m = len(taps) - 1
    n = y.shape[1]
    worst = 0.0
    for c in range(y.shape[0]):
        for i0 in _excerpt_starts(n, seam if c == 0 else 0):
            length = min(EXCERPT, n - i0)
            lo = i0 - left
            seg = np.zeros(length + m)
            s0, s1 = max(0, lo), min(x.shape[1], lo + length + m)
            if s1 > s0:
                seg[s0 - lo : s1 - lo] = x[c, s0:s1].double().cpu().numpy() / scale
            want = oracle.fft_filter_f64(seg, taps)[m // 2 : m // 2 + length]
            got = y[c, i0 : i0 + length].double().cpu().numpy() / scale
            worst = max(worst, oracle.max_scaled_lsb_error(got, want, bits))
    if worst > 1.0:
        raise RuntimeError(f"output vs float64 oracle at the timed shape: "
                           f"{worst:.4f} LSB @ {bits}-bit > 1")
    return worst


def _timed_calls(fn, reps: int, dev: torch.device, plan, per_call: int,
                 i16: bool = False, check=None) -> dict:
    """One warm-up call, then ``reps`` timed calls; checks the warm-up's
    output is finite and passes ``check`` (a function of it that returns
    its error and raises on a miss), and that the launch counters moved by
    ``per_call`` on every call. Returns the seconds, launches and error,
    and on the card the device memory: resident before the calls (the
    input) and the peak of the timed calls."""
    source, counts, mode = _kernel(plan, i16)
    out = {"kernel": f"{source}_{mode}", "reps": reps}
    before = counts[mode]
    t0 = time.perf_counter()
    y = fn()
    _sync(dev)
    out["warmup_s"] = time.perf_counter() - t0
    y = y[0] if isinstance(y, tuple) else y
    if y.is_floating_point():
        # min and max propagate NaN and keep +-inf, with no temporary the
        # size of the output (isfinite(y).all() took 2.9 GB at 1008 hops).
        lo, hi = (float(v) for v in torch.aminmax(y))
        if not (math.isfinite(lo) and math.isfinite(hi)):
            raise RuntimeError(f"{out['kernel']}: non-finite output")
    if check is not None:
        out["excerpt_lsb"] = check(y)
    del y
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        out["resident_bytes"] = torch.cuda.memory_allocated(dev)
    out["seconds"] = _elapsed_s(fn, reps, dev)
    out["launches"] = counts[mode] - before
    want = (reps + 1) * per_call if dev.type == "cuda" else 0
    if out["launches"] != want:
        raise RuntimeError(
            f"{out['kernel']}: {out['launches']} launches over {reps} timed "
            f"calls and a warm-up, want {want} ({per_call} per call): a call "
            "did not go through the kernel")
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _signal(n: int, dev: torch.device) -> torch.Tensor:
    """0.3 * sin(0.37 * i), i < n, made on the device: nothing crosses from
    the host."""
    return torch.arange(n, dtype=torch.float32, device=dev).mul_(0.37).sin_().mul_(0.3)


def _report_run(r: dict, rate: float, fs: float, channels: int,
                bits: int, reckoned: int | None = None) -> None:
    log(f"warmup: {r['warmup_s']:.3f}s; its output vs float64 oracle "
        f"(head/seam/tail excerpts): {r['excerpt_lsb']:.4f} LSB @ {bits}-bit "
        "(<= 1.0)")
    log(f"device-resident: {r['reps']} calls in {r['seconds']:.6f}s -> "
        f"{rate / 1e6:.1f} Msamples/s ({rate / (fs * channels):.0f}x realtime); "
        f"{r['kernel']} launched {r['launches']} times")
    if "peak_bytes" in r:
        extra = (f"; one call reckoned {reckoned / 1e9:.3f} GB"
                 if reckoned is not None else "")
        log(f"device memory (max_memory_allocated): timed calls "
            f"{r['peak_bytes'] / 1e9:.3f} GB, input resident before them "
            f"{r['resident_bytes'] / 1e9:.3f} GB{extra}")


def measure_chip_rate(freq: float, slope: float, fs: float, channels: int,
                      precision: str, block_size: int, segment_blocks: int,
                      reps: int, engine: str = "auto", conv_chunk: int = 0,
                      device="cuda") -> dict:
    """Device-resident throughput of one filter configuration."""
    dev = resolve_device(device)
    ws = kd.WindowedSinc(freq / fs, slope / fs).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, block_size, dev, engine,
                         conv_chunk or osv.CONV_CHUNK)
    log(f"kernel: {ws.num_taps} taps (M={ws.m}); block B={plan.block_size}, "
        f"hop {plan.hop}; precision={precision}; engine={engine} "
        f"({plan.engine}); device {device_name(dev)}")
    segment_blocks = fit_segment(plan, channels, segment_blocks, dev)
    seg = segment_blocks * plan.hop
    log(f"segment: {channels} ch x {seg} frames ({seg / fs:.1f}s of audio) "
        f"+ {plan.m} halo")
    t0 = time.perf_counter()
    xd = _signal(channels * (seg + plan.m), dev).reshape(channels, seg + plan.m)
    _sync(dev)
    log(f"generate segment on device: {time.perf_counter() - t0:.3f}s")
    bits = 24 if precision == osv.HIGH else 16
    seam = osv.chunk_hops(plan) * plan.hop
    r = _timed_calls(lambda: osv.extended_filter(xd, plan, seg), reps, dev,
                     plan, osv.launches_per_call(plan, channels, seg),
                     check=lambda y: check_excerpts(y, xd, ws.taps, 0, bits, seam))
    rate = reps * channels * seg / r["seconds"]
    _report_run(r, rate, fs, channels, bits, osv.call_bytes(plan, channels, seg))
    return {"rate": rate, "plan": plan, "num_taps": ws.num_taps,
            "realtime_x": rate / (fs * channels), "run": r,
            "work": roofline.work(plan, channels, seg + plan.m, seg)}


def measure_fast16(segment_blocks: int, reps: int, device="cuda") -> dict:
    """Device-resident rate of the segment kernel's 16-bit I/O mode (int16
    PCM in and out, float32 arithmetic) at the headline shape."""
    dev = resolve_device(device)
    fs, channels, b = 96000.0, 2, 1 << 18
    ws = kd.WindowedSinc(15.0 / fs, 10.0 / fs).make_low_cut()
    if not sf.qualifies(ws.num_taps, b):
        return {"skipped": "shape does not qualify"}
    plan = osv.make_plan(ws.taps, osv.FAST, b, dev)
    hop, left = sf.segment_framing(plan.m, b)
    seg = segment_blocks * hop
    xd = _signal(channels * seg, dev).mul_(9830.0 / 0.3).to(torch.int16)
    xd = xd.reshape(channels, seg)
    seam = osv.chunk_hops(plan) * hop
    r = _timed_calls(lambda: sf.segment_filter(xd, plan, left, seg, i16_io=True),
                     reps, dev, plan, 1, i16=True,
                     check=lambda y: check_excerpts(y, xd, ws.taps, left, 16,
                                                    seam, scale=32768.0))
    rate = reps * channels * seg / r["seconds"]
    _report_run(r, rate, fs, channels, 16)
    return {"samples_per_sec": round(rate, 1),
            "realtime_x": round(rate / (fs * channels), 1),
            "work": roofline.work(plan, channels, seg, seg, sample_bytes=2),
            "seconds_per_call": r["seconds"] / reps}


# ---------------------------------------------------------------- reports

def _share(w: dict, per_call: float, dev: torch.device) -> dict:
    """The binding bound of ``w`` and, on the card, the share of it that
    calls of ``per_call`` seconds achieved."""
    out = {"bound_by": w["bound_by"]}
    if dev.type == "cuda":
        out["roofline_share"] = round(w["bound_s"] / per_call, 4)
    return out


def roofline_report(res: dict, dev: torch.device, card: str) -> None:
    """Both bounds of the plan's work (``roofline.work``), which one
    binds, and the share of it the measured calls achieved."""
    plan, w = res["plan"], res["work"]
    per_call = res["run"]["seconds"] / res["run"]["reps"]
    log(f"roofline model (per call, from the plan: B={plan.block_size}, hop "
        f"{plan.hop}; each input and output sample moved once; one real "
        f"forward and one real inverse FFT of B points at 2.5 B log2 B flops "
        f"each and B/2+1 complex multiplies at 6 flops, per hop):")
    log(f"  work: {w['bytes'] / 1e9:.6f} GB, {w['flops'] / 1e9:.6f} Gflop "
        f"({w['flops'] / w['samples']:.2f} flop and {w['bytes'] / w['samples']:.4f} B "
        f"per output sample)")
    log(f"  peaks (H100 SXM data sheet): {roofline.HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s HBM, {roofline.PEAK_FLOPS[plan.precision] / 1e12:.0f} TFLOP/s "
        f"{roofline.PEAK_NAMES[plan.precision]}")
    log(f"  bounds: bytes {w['bytes_s'] * 1e3:.6f} ms, operations "
        f"{w['ops_s'] * 1e3:.6f} ms -> bound by {w['bound_by']} at "
        f"{w['bound_s'] * 1e3:.6f} ms per call")
    if dev.type != "cuda":
        log(f"  measured {per_call * 1e3:.6f} ms per call on the CPU: no "
            "roofline share (the peaks are the card's)")
        return
    log(f"  achieved {per_call * 1e3:.6f} ms per call = "
        f"{w['bound_s'] / per_call * 100:.1f}% of the binding bound; "
        f"{w['bytes'] / per_call / 1e9:.1f} GB/s, "
        f"{w['flops'] / per_call / 1e12:.3f} TFLOP/s on {card}")


def fidelity_report(freq: float, slope: float, fs: float, precision: str,
                    block_size: int, engine: str, device="cuda"):
    """Fidelity gate: the production-size plan on the device over random
    noise spanning several blocks (both signal edges and an uneven tail)
    against the float64 oracle, at the precision's promised depth (24 bits
    for ``high``, 16 for ``fast``), relative to the output's binade above
    full scale. Returns (worst error, gate bits)."""
    dev = resolve_device(device)
    ws = kd.WindowedSinc(freq / fs, slope / fs).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, block_size, dev, engine)
    n = 3 * plan.hop + plan.hop // 3
    rng = np.random.default_rng(7)
    gate_bits = 24 if precision == osv.HIGH else 16
    gate_err = 0.0
    for amp, label in ((1.0, "full-scale"), (2.4, "2.4x-scale")):
        x = rng.uniform(-amp, amp, n).astype(np.float32)
        log(f"fidelity: {ws.num_taps} taps, B={plan.block_size}, {n} frames "
            f"{label} noise, precision={precision}, engine={engine}")
        t0 = time.perf_counter()
        y = osv.same_filter(torch.from_numpy(x).to(dev), plan).cpu().numpy()
        log(f"device filter (with the copies): {time.perf_counter() - t0:.3f}s")
        want = oracle.fft_filter_f64(x, ws.taps)
        err24 = oracle.max_scaled_lsb_error(y, want, bits=24)
        err16 = oracle.max_scaled_lsb_error(y, want, bits=16)
        err = err24 if gate_bits == 24 else err16
        gate_err = max(gate_err, err)
        log(f"fidelity vs float64 oracle: max err {err24:.4f} scale-relative "
            f"LSB @ 24-bit ({err16:.6f} @ 16-bit), output peak "
            f"{float(np.abs(want).max()):.3f} -> gate (<= 1.0 @ {gate_bits}-bit): "
            f"{'PASS' if err <= 1.0 else 'FAIL'}")
    return gate_err, gate_bits


# The BASELINE.json configurations, as (name, freq, slope, fs, channels).
# Config 4 (a 64-file batch) exercises host orchestration; its kernel
# equals config 1's.
BASELINE_CONFIGS = [
    ("cfg1 mono 44.1k 16-bit, f=20 s=10", 20.0, 10.0, 44100.0, 1),
    ("cfg2 stereo 96k 24-bit, f=10 s=5 (long kernel)", 10.0, 5.0, 96000.0, 2),
    ("cfg3 AIFF, f=40 s=10 + normalize", 40.0, 10.0, 44100.0, 2),
    ("cfg5 stereo 192k, f=15 s=10 (sharded kernel)", 15.0, 10.0, 192000.0, 2),
]

def scaling_report(args, res: dict, dev: torch.device, card: str) -> None:
    """``--scaling``: the per-cell rates of both precisions measured in
    this run (the headline call's, and one more call at the other
    precision), then the report of ``parallel/scaling_bench``. Raises if a
    part fails, so the run prints no result line."""
    from .parallel import scaling_bench

    other = osv.FAST if args.precision == osv.HIGH else osv.HIGH
    log(f"--- scaling: the {other} rate of the same workload")
    r = measure_chip_rate(args.freq, args.slope, args.sample_rate,
                          args.channels, other, args.block_size,
                          args.segment_blocks, args.reps, args.engine,
                          args.conv_chunk, dev)
    rates = {args.precision: res["rate"], other: r["rate"]}
    workload = scaling_bench.Workload(args.freq, args.slope, args.sample_rate,
                                      args.channels, args.block_size)
    log("--- scaling report")
    scaling_bench.run_scaling(
        log, workload, {p: rates[p] for p in (osv.HIGH, osv.FAST)}, dev,
        card if dev.type == "cuda" else device_name(dev))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python3 -m audio_fir_filter_tpu_torch.bench",
        description="Filtering throughput of one device (one JSON line on "
                    "stdout; reports on stderr).")
    ap.add_argument("--reps", type=int, default=6,
                    help="device-resident segment calls to time")
    ap.add_argument("--precision", choices=["high", "fast"], default="high")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "fourstep", "pease", "stockham"])
    ap.add_argument("--freq", type=float, default=15.0)
    ap.add_argument("--slope", type=float, default=10.0)
    ap.add_argument("--sample-rate", type=float, default=96000.0)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--conv-chunk", type=int, default=0,
                    help="blocks per block-kernel call (0 = engine default)")
    ap.add_argument("--segment-blocks", type=int, default=1008,
                    help="hops per timed segment (lowered, with a note on "
                         "stderr, if the segment does not fit the card)")
    ap.add_argument("--all", action="store_true",
                    help="also run the BASELINE.json config kernels (stderr)")
    ap.add_argument("--roofline", action="store_true",
                    help="print the bytes/flops model and the share (stderr)")
    ap.add_argument("--fidelity", action="store_true",
                    help="run the fidelity gate (stderr; exit 1 if exceeded)")
    ap.add_argument("--scaling", action="store_true",
                    help="run the sharded-filter scaling report (stderr): the "
                         "halo-cost model at this run's measured rates, the "
                         "mesh in one process, and a 2-process exchange")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="'cuda' = the CUDA card (exit 1 if there is none), "
                         "'cpu' = the CPU (plain versions)")
    return ap


def _build_kernels(args) -> None:
    """Build (or find built) the kernels this run launches, one ``nvcc``
    each, all at once, before anything is timed."""
    from concurrent.futures import ThreadPoolExecutor

    from .ops import _build

    names = {"conv_blocks" if osv.resolve_engine(args.engine) in
             osv.BLOCK_ENGINES else "segment_filter"}
    if args.all or args.scaling:
        names.add("segment_filter")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.library, sorted(names)))
    log(f"build: {', '.join(sorted(names))} in {time.perf_counter() - t0:.3f}s "
        "(nvcc, or the libraries already built)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        log(f"bench: {e}")
        return 1
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"device: {device_name(dev)}; {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    if dev.type == "cuda":
        _build_kernels(args)
    fs = args.sample_rate
    fidelity_err = None
    if args.fidelity:
        fidelity_err, fidelity_bits = fidelity_report(
            args.freq, args.slope, fs, args.precision, args.block_size,
            args.engine, dev)

    res = measure_chip_rate(args.freq, args.slope, fs, args.channels,
                            args.precision, args.block_size,
                            args.segment_blocks, args.reps, args.engine,
                            args.conv_chunk, dev)
    if args.roofline:
        roofline_report(res, dev, card)

    if args.all:
        log("\nBASELINE.json config kernels:")
        extra = {}
        for name, f, s, cfs, ch in BASELINE_CONFIGS:
            log(f"--- {name}")
            r = measure_chip_rate(f, s, cfs, ch, args.precision, 0,
                                  min(args.segment_blocks, 504),
                                  max(4, args.reps // 2), args.engine,
                                  device=dev)
            extra[name] = {"samples_per_sec": round(r["rate"], 1),
                           "realtime_x": round(r["realtime_x"], 1),
                           **_share(r["work"], r["run"]["seconds"]
                                    / r["run"]["reps"], dev)}
        log("--- fast16: the segment kernel's 16-bit I/O mode (headline shape)")
        r16 = measure_fast16(min(args.segment_blocks, 504),
                             max(4, args.reps // 2), dev)
        if "work" in r16:
            r16.update(_share(r16.pop("work"), r16.pop("seconds_per_call"), dev))
        extra["fast16 16-bit I/O (headline shape)"] = r16
        log(json.dumps(extra, indent=2))

    if args.scaling:
        scaling_report(args, res, dev, card)

    rate = res["rate"]
    baseline = 100.0 * fs * args.channels  # 100x realtime, in samples/s
    plan = res["plan"]
    print(json.dumps({
        "metric": (f"samples/s on {device_name(dev)} ({args.channels} ch "
                   f"{fs / 1000:g} kHz, {res['num_taps']}-tap FIR, "
                   f"{plan.precision}, engine {plan.engine})"),
        "value": round(rate, 1),
        "unit": "samples/s",
        "vs_baseline": round(rate / baseline, 4),
    }))
    if fidelity_err is not None and fidelity_err > 1.0:
        log(f"FIDELITY GATE FAILED: {fidelity_err:.4f} > 1.0 scale-relative "
            f"LSB @ {fidelity_bits}-bit")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
