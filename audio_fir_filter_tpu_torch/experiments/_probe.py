"""What the card probes share: the device rule, launching a probe entry
point, timing, the library convolution, error checks and the table
printer."""

from __future__ import annotations

import statistics
import time

import torch

from ..utils.device import resolve_device


def card(device) -> torch.device:
    """The CUDA device a probe runs on. ``"cuda"`` without a card raises
    (``resolve_device``); any other device raises too: a probe times the
    card and never falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes time a CUDA card; asked for {dev}")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """The wrapper rule: True for CUDA tensors (launch the kernel), False
    for CPU tensors (take the plain version); raises on anything else or a
    mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"probes run on 'cuda' or 'cpu', not {dev}")
    return dev.type == "cuda"


def launch(lib_name: str, entry: str, device: torch.device, *args) -> None:
    """Call a probe entry point on ``device``'s current stream (appended
    as the last argument); raises if the launch failed."""
    from ..ops import _build

    fn = getattr(_build.library(lib_name), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")


def bench_taps(freq: float = 15.0, slope: float = 10.0, fs: float = 96000.0):
    """The bench's low-cut taps; by default its headline's: 96 kHz,
    ``-f 15 -s 10`` (M = 38,400)."""
    from ..ops import kernel_design as kd

    return kd.WindowedSinc(freq / fs, slope / fs).make_low_cut().taps


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def event_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn()`` between two CUDA events.

    Each timed call is queued behind a sleep kernel longer than the call's
    own host time, so the first event fires only when the call's kernels
    are already queued: the events see device time, not the host's launch
    latency (tens of microseconds, as long as a small kernel). A 5 ms
    sleep first keeps the card busy after host-side work, before the
    warm-up calls."""
    torch.cuda._sleep(int(5e-3 * _SLEEP_CYCLES_PER_S))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((2.0 * host + 1e-4) * _SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# Sleep-kernel cycles per second: an upper bound on the SM clock (H100:
# 1.98 GHz at most), so a sleep lasts at least the time asked for.
_SLEEP_CYCLES_PER_S = 2.0e9


def host_us_per_call(fn, k: int = 200) -> float:
    """Host microseconds per call over ``k`` back-to-back calls with one
    synchronize at the end: the per-call floor when each call is small."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / k * 1e6


def library_conv(x: torch.Tensor, taps, precision: str, left: int,
                 out_len: int):
    """The one PyTorch call that computes the segment filter's function
    ``y[:, o] = sum_k taps[k] x[:, o + k - left]`` (a cross-correlation
    with the taps, x zero outside it), as a callable that returns y
    [C, 1, out_len]: ``F.conv1d`` in the plan's precision (``"high"``:
    float64)."""
    import numpy as np
    import torch.nn.functional as F

    dt = torch.float64 if precision == "high" else torch.float32
    right = out_len + len(taps) - 1 - left - x.shape[1]
    xc = x.to(dt)[:, None, :]
    pad = left
    if left != right:
        xc, pad = F.pad(xc, (left, right)), 0
    w = torch.from_numpy(np.asarray(taps, np.float64)).to(x.device, dt)[None, None]
    return lambda: F.conv1d(xc, w, padding=pad)


def library_conv_ms(x: torch.Tensor, taps, precision: str, left: int,
                    out_len: int, want: torch.Tensor) -> tuple[float, float]:
    """(ms, max |y - want|) of :func:`library_conv` on the card, TF32 off.
    A first call slower than 2 s is its own time (host clock,
    synchronized); otherwise the median device time of 3 calls."""
    conv = library_conv(x, taps, precision, left, out_len)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        y = conv()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        err = max(float((y[c, 0].double() - want[c].double()).abs().max())
                  for c in range(y.shape[0]))
        del y
        ms = first * 1e3 if first > 2.0 else event_ms(conv, reps=3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return ms, err


def gbps(nbytes: float, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|), in float64."""
    g = got.to(torch.complex128 if got.is_complex() else torch.float64)
    w = want.to(g.dtype)
    return float((g - w).abs().max()), float(w.abs().max())


def expect(name: str, got: torch.Tensor, want: torch.Tensor,
           rel: float | None) -> float:
    """Check ``got`` against its plain version ``want``: bitwise with
    ``rel=None``, else max |got - want| <= rel * max |want|. Raises on a
    shape mismatch, a non-finite value or a miss; returns max |got - want|."""
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                               else got).all()):
        raise RuntimeError(f"{name}: non-finite output")
    if rel is not None and got.dtype == torch.float32:
        rel = max(rel, REL_OUT32)
    if rel is None:
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: not bitwise equal to its plain version")
        return 0.0
    err, scale = max_err(got, want)
    if not err <= rel * max(scale, 1e-300):
        raise RuntimeError(f"{name}: max |kernel - plain| {err:.3e} > "
                           f"{rel:g} * max |plain| {scale:.3e}")
    return err


# Tolerances against the plain version on the same inputs, relative to
# max |plain|: float32 arithmetic over at most 2 * log2(B) butterfly
# levels, twiddle and spectrum multiplies (observed ~1e-6), and float64.
REL_F32 = 1e-4
REL_F64 = 1e-9
# A float32 output of float64 arithmetic: the kernel and the plain version
# each round to float32 (2^-24 relative), so they may differ by an ulp.
REL_OUT32 = 2.0 ** -22


def table(title: str, header: list[str], rows: list[list]) -> list[str]:
    """Lines of a plain-text table, floats to 6 significant digits."""
    def fmt(v):
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    cells = [header] + [[fmt(v) for v in r] for r in rows]
    widths = [max(len(c[i]) for c in cells) for i in range(len(header))]
    lines = [title]
    for c in cells:
        lines.append("  " + "  ".join(v.rjust(w) for v, w in zip(c, widths)))
    return lines
