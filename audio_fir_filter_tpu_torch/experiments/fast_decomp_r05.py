"""The shipped segment kernel with parts switched off, on the card.

Counterpart of ``experiments/fast_decomp_r05.py``, which timed the
production segment path under the ``LOWCUT_ABLATE`` variants of the fused
Pallas kernel (``audio_fir_filter_tpu/ops/pallas_fft.py:124-155``, read in
``_call_fused``), one subprocess per variant because the knob was read at
import. Here ``csrc/probe_segment.cu`` instantiates the shipped passes
(``csrc/segment_filter.cuh``, ``csrc/fourstep.cuh``) with their compile-time
switches, and the variant is an argument of :func:`segment_ablation`: one
process, no environment variable. Card variant (TPU tokens) -> what it
leaves out, and its defined output, which is its plain version:

- ``full`` (none): nothing, the shipped kernel -> the segment filter
  (``ops.segment_filter.reference``);
- ``no_gather`` (``dma``, ``noreadx``): pass 1's reads of the signal (its
  registers take a zero nvcc cannot see) -> zeros, peak 0;
- ``no_store`` (``out8``): pass 3's stores of y, its peak kept -> y as the
  wrapper zero-filled it, the peak of ``full``;
- ``no_tr`` (``tr``): the column-strided scratch layout; each column tile
  is one contiguous run -> the passes' plain versions with that
  permutation between them (a defined output, not a filter);
- ``rows_copy`` (``phaseb``): pass 2's FFTs and H, its loads, exchanges
  and stores kept -> passes 1 and 3 invert each other up to the scale 1/B
  times N1: ``y[o] = x[o + M - left] / N2``;
- ``no_arith`` (``fft``, ``mul``): every FFT, twiddle and H multiply and
  the 1/B scale (dropped, as the TPU's ``mul`` dropped it) -> the shift
  ``y[o] = x[o + M - left]``, exactly;
- ``floor`` (``dma``, ``tr``, ``fft``, ``mul``): the reads, the arithmetic
  and the strided layout -> zeros, through the scratch and stored;
- ``no_tw4`` (no TPU token): the column passes' reads of the four-step
  twiddle table, their multiply kept (by a unit held in registers) -> the
  three passes with every four-step twiddle 1, a 2-D circular
  convolution of each pair's [N1, N2] view (:func:`_no_tw4`).

x is zero outside [0, n_in); 16-bit I/O quantizes each output by the
codec's rule. Left out, with the reason: ``alignedsrc`` (the TPU's
misaligned-sublane relayout of the writeback has no counterpart on the
card), ``rolls`` and ``strided`` (one stage family on the card: the
register-resident radix-8 FFT), ``nostores`` and ``noloads`` (the output
would depend on stale scratch, so it has no plain version), ``empty``
(``dispatch_floor_probe.empty``, the launch floor, already exists).

The differences split the kernel's time: gather = full - no_gather,
writeback = full - no_store, pass 2 arithmetic = full - rows_copy, column
arithmetic = rows_copy - no_arith, strided layout = full - no_tr,
twiddle table reads = full - no_tw4, data-movement floor = no_arith.
Shapes: the bench's headline (2 channels x 1008 hops at 96 kHz, ``-f 15
-s 10``: M = 38,400, B = 2^18, f64 and f32), its fast16 call (the same at
504 hops, 16-bit I/O), the long filter's call (``-f 10 -s 5``: M =
76,800, B = 2^19, the 1024 x 512 split, 2 x 387 pairs as one call of the
benchmark's ``long96k.device``, f64 and f32) and chip_smoke's 2 x 30 s
(phase 3's shapes: i16 at 44.1 kHz, M = 17,640), whose scratch the L2
holds in part, with 2 x 10 s of the long filter. The card's library
instantiates B = 2^18 and 2^19 only: another B raises there; the plain
versions take any.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import bench
from ..ops import overlap_save as osv
from ..ops import roofline
from ..ops import segment_filter as sf
from . import _probe
from . import fused_phase_decomp as fpd
from . import pallas_micro as pm

VARIANTS = ("full", "no_gather", "no_store", "no_tr", "rows_copy",
            "no_arith", "floor", "no_tw4")
# Variant ids of csrc/probe_segment.cu.
_ID = {v: i for i, v in enumerate(VARIANTS)}
# What each variant keeps: the gather, the stores of y, the column passes'
# arithmetic, the strided layout, pass 2's arithmetic, the column passes'
# reads of the twiddle table.
_KEEPS = {
    "full": (True, True, True, True, True, True),
    "no_gather": (False, True, True, True, True, True),
    "no_store": (True, False, True, True, True, True),
    "no_tr": (True, True, True, False, True, True),
    "rows_copy": (True, True, True, True, False, True),
    "no_arith": (True, True, False, True, False, False),
    "floor": (False, True, False, False, False, False),
    "no_tw4": (True, True, True, True, True, False),
}
# Variants whose plain version is exact (zeros or a shift): held bitwise.
EXACT = ("no_gather", "no_store", "no_arith", "floor")

HEADLINE_HOPS = 1008   # the bench's --segment-blocks
FAST16_HOPS = 504      # the bench's fast16 call
# The long filter (-f 10 -s 5 at 96 kHz, M = 76,800, B = 2^19): hops per
# channel of one long96k.device call (2 x 345.6 M frames: 387 pairs each).
LONG_TAPS = (10.0, 5.0)
LONG_HOPS = 774
LONG_B = 1 << 19
SHAPES = ("headline", "fast16", "long", "2 x 30 s")
MODES = ("f64", "f32", "i16")

launches = {f"probe_segment_{m}": 0 for m in MODES}


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def segment_ablation(x: torch.Tensor, plan, left: int, out_len: int,
                     variant: str, i16_io: bool = False,
                     out: torch.Tensor | None = None):
    """``ops.segment_filter.segment_filter``'s call under ``variant``:
    (y [C, out_len], peak). ``y`` is zero-filled before the launch, or is
    ``out`` as given (reused across timed calls: no fill). CUDA tensors run
    the probe kernel, CPU tensors :func:`reference`."""
    _check_variant(variant)
    sf._check(x, plan, left, out_len, i16_io)
    if not _probe.on_card(x, plan.H):
        return reference(x, plan, left, out_len, variant, i16_io)
    c = x.shape[0]
    dev = x.device
    if out is None:
        out = torch.zeros((c, out_len), dtype=x.dtype, device=dev)
    elif (out.shape != (c, out_len) or out.dtype != x.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous [{c}, {out_len}] {x.dtype} "
                         f"on {dev}")
    words = sf.peak_words(dev)
    if c == 0 or out_len == 0:
        return out, words[0]
    mode = sf.mode_of(plan, i16_io)
    sf.run_entry("probe_segment", f"lowcut_probe_segment_{mode}", x, out, words,
                 plan, left, out_len, _ID[variant])
    launches[f"probe_segment_{mode}"] += 1
    return out, words[0]


# ------------------------------------------------------ plain versions

def reference(x: torch.Tensor, plan, left: int, out_len: int, variant: str,
              i16_io: bool = False):
    """The plain version of each variant (module docstring), in the plan's
    precision (float32 for 16-bit I/O); runs on any device."""
    _check_variant(variant)
    if variant == "full":
        return sf.reference(x, plan, left, out_len, i16_io)
    zeros = torch.zeros((x.shape[0], out_len), dtype=x.dtype, device=x.device)
    if variant in ("no_gather", "floor") or zeros.numel() == 0:
        return zeros, torch.zeros((), dtype=torch.float32, device=x.device)
    if variant == "no_store":
        return zeros, sf.reference(x, plan, left, out_len, i16_io)[1]
    high = plan.precision == sf.HIGH and not i16_io
    xf = x.to(torch.float64 if high else torch.float32)
    if i16_io:
        xf = xf / 32768.0
    if variant == "no_tr":
        y = _no_tr(xf, plan, left, out_len)
    elif variant == "no_tw4":
        y = _no_tw4(xf, plan, left, out_len)
    else:
        y = shifted(xf, plan.m - left, out_len)
        if variant == "rows_copy":
            y = y / sf.split_shape(plan.block_size)[1]
    y = y.to(torch.float32)
    if i16_io:
        q = torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0)
        return q.to(torch.int16), q.abs().max().to(torch.float32)
    return y.contiguous(), y.abs().max()


def shifted(x: torch.Tensor, d: int, out_len: int) -> torch.Tensor:
    """y[:, o] = x[:, o + d] for o < out_len, zero outside [0, n_in)."""
    pad_left = max(0, -d)
    xp = F.pad(x, (pad_left, max(0, d + out_len - x.shape[1])))
    return xp[:, d + pad_left: d + pad_left + out_len]


def _no_tr(xf: torch.Tensor, plan, left: int, out_len: int) -> torch.Tensor:
    """The three passes' plain versions (``pallas_micro``) on the kernel's
    pairs of windows, with the contiguous-tile layout between them
    (``fused_phase_decomp``), then the valid-hop scatter."""
    b, m, hop = plan.block_size, plan.m, plan.hop
    c = xf.shape[0]
    nb = 2 * ((-(-out_len // hop) + 1) // 2)        # whole pairs per channel
    blocks = sf.windows(xf, b, hop, left, nb).reshape(c * nb, b)
    tc = fpd.tile_columns(b)
    s = fpd._tiles_contiguous(pm.k1_reference(blocks, plan.H), tc)
    s = fpd._tiles_strided(pm.k2_reference(s, plan.H), tc)
    yb = pm.k3_reference(s, plan.H)                 # [c * nb, B]
    return yb.view(c, nb, b)[:, :, m:].reshape(c, nb * hop)[:, :out_len]


def _no_tw4(xf: torch.Tensor, plan, left: int, out_len: int) -> torch.Tensor:
    """The three passes with every four-step twiddle 1: pair k's windows
    as the [N1, N2] view of x0 + i*x1, its 2-D DFT times H in natural
    order (the kernel layout's rows and columns bit-reversed back), the
    inverse 2-D DFT (1/B), then the valid-hop scatter."""
    b, m, hop = plan.block_size, plan.m, plan.hop
    c = xf.shape[0]
    l1, l2 = sf.split(b)
    nb = 2 * ((-(-out_len // hop) + 1) // 2)        # whole pairs per channel
    w = sf.windows(xf, b, hop, left, nb)            # [c, nb, B]
    z = torch.complex(w[:, 0::2], w[:, 1::2]).reshape(c, nb // 2, 1 << l1, 1 << l2)
    br1 = torch.from_numpy(sf._bitrev(l1)).to(xf.device)
    br2 = torch.from_numpy(sf._bitrev(l2)).to(xf.device)
    hn = plan.H[br1][:, br2].to(z.dtype)
    d = torch.fft.ifft2(torch.fft.fft2(z) * hn).reshape(c, nb // 2, b)
    yb = torch.stack((d.real, d.imag), dim=2).reshape(c, nb, b)[:, :, m:]
    return yb.reshape(c, nb * hop)[:, :out_len]


# ---------------------------------------------------- traffic, shapes

def variant_bytes(variant: str, plan, channels: int, n_in: int, out_len: int,
                  i16_io: bool = False) -> int:
    """Device-memory bytes ``variant`` must move: the signal read once (if
    it gathers), y written once (if it stores), the scratch written by pass
    1, read and written by pass 2 and read by pass 3, and the tables once
    each (the four-step twiddle as the column passes read it,
    ``sf.twiddle_layout``, by passes 1 and 3 unless the variant leaves its
    reads out; H, read by pass 2 with its arithmetic)."""
    gather, store, _, _, rows, tw4 = _KEEPS[variant]
    b, cx = plan.block_size, plan.H.element_size()
    sb = 2 if i16_io else 4
    pairs = channels * ((-(-out_len // plan.hop) + 1) // 2)
    n = 4 * pairs * cx * b
    n += sb * channels * n_in if gather else 0
    n += sb * channels * out_len if store else 0
    n += 2 * sf.twiddle_layout(b, plan.H.dtype)["bytes"] if tw4 else 0
    n += cx * b if rows else 0
    return n


def shapes(dev, which=SHAPES):
    """(shape name, mode, plan, x, left, out_len, i16) of each timed call:
    the bench's headline (extended segment, f64 and f32) and fast16 call
    (16-bit I/O), the long filter's call (f64 and f32 at B = 2^19), and
    chip_smoke's phase-3 calls of 2 x 30 s; ``2 x 10 s long``, the long
    filter on 2 x 10 s (f64 and f32), is asked for by name only."""
    from ..models import LowCut

    fs = 96000.0
    taps = _probe.bench_taps()
    for name in which:
        if name == "headline":
            for mode, precision in (("f64", sf.HIGH), ("f32", sf.FAST)):
                plan = osv.make_plan(taps, precision, 0, dev)
                seg = HEADLINE_HOPS * plan.hop
                x = bench._signal(2 * (seg + plan.m), dev).reshape(2, seg + plan.m)
                yield name, mode, plan, x, 0, seg, False
        elif name == "fast16":
            plan = osv.make_plan(taps, sf.FAST, 0, dev)
            seg = FAST16_HOPS * plan.hop
            x = bench._signal(2 * seg, dev).mul_(9830.0 / 0.3).to(torch.int16)
            yield name, "i16", plan, x.reshape(2, seg), plan.mo2, seg, True
        elif name in ("long", "2 x 10 s long"):
            long_taps = _probe.bench_taps(*LONG_TAPS)
            for mode, precision in (("f64", sf.HIGH), ("f32", sf.FAST)):
                plan = osv.make_plan(long_taps, precision, LONG_B, dev)
                if name == "long":
                    n = LONG_HOPS * plan.hop
                    x = bench._signal(2 * n, dev).reshape(2, n)
                else:
                    n = int(10 * fs)
                    g = torch.Generator(device=dev).manual_seed(n)
                    x = torch.rand((2, n), generator=g, device=dev) - 0.5
                yield name, mode, plan, x, plan.mo2, n, False
        else:
            for mode, precision, rate in (("f64", sf.HIGH, fs), ("f32", sf.FAST, fs),
                                          ("i16", sf.FAST, 44100.0)):
                plan = LowCut(freq=15.0, slope=10.0).plan(rate, precision=precision,
                                                          device=dev)
                n = int(30 * rate)
                g = torch.Generator(device=dev).manual_seed(n)
                x = torch.rand((2, n), generator=g, device=dev) - 0.5
                if mode == "i16":
                    x = torch.round(x * 32768.0).to(torch.int16)
                yield name, mode, plan, x, plan.mo2, n, mode == "i16"


# ---------------------------------------------------------- on the card

def _expect(name: str, got, want, mode: str, exact: bool) -> float:
    """Hold a kernel output against its plain version: bitwise where
    ``exact``, else within 1 PCM code (16-bit I/O) or the mode's relative
    tolerance; returns max |got - want| (codes for 16-bit I/O)."""
    if exact:
        return _probe.expect(name, got, want, None)
    if mode == "i16":
        if got.shape != want.shape:
            raise RuntimeError(f"{name}: shape {tuple(got.shape)} != "
                               f"{tuple(want.shape)}")
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        if err > 1:
            raise RuntimeError(f"{name}: {err} PCM codes from its plain version")
        return float(err)
    return _probe.expect(name, got, want,
                         _probe.REL_F64 if mode == "f64" else _probe.REL_F32)


def verify(device="cuda") -> dict:
    """Every variant against its plain version at chip_smoke's 2 x 30 s
    calls (f64, f32, i16) and at the long filter's 2 x 10 s (f64, f32,
    B = 2^19): bitwise for the zero and shift variants, within the stated
    tolerance (one PCM code for 16-bit I/O) for the others; every peak
    against its plain version's, and ``no_store``'s equal to ``full``'s bit
    for bit."""
    dev = _probe.card(device)
    errs = {}
    for _, mode, plan, x, left, n, i16 in shapes(dev, ("2 x 30 s",
                                                       "2 x 10 s long")):
        e = 0.0
        peaks = {}
        for v in VARIANTS:
            tag = f"segment ablation {mode} {v}"
            y, pk = segment_ablation(x, plan, left, n, v, i16)
            yp, pp = reference(x, plan, left, n, v, i16)
            e = max(e, _expect(tag, y, yp, mode, v in EXACT))
            peaks[v] = float(pk)
            rel = _probe.REL_F64 if mode == "f64" else _probe.REL_F32
            tol = 1.0 if i16 else max(rel, _probe.REL_OUT32) * float(pp)
            if not abs(float(pk) - float(pp)) <= tol:
                raise RuntimeError(f"{tag}: peak {float(pk)} vs plain {float(pp)}")
        if peaks["no_store"] != peaks["full"]:
            raise RuntimeError(f"segment ablation {mode}: no_store's peak "
                               f"{peaks['no_store']} != full's {peaks['full']}")
        key = f"probe_segment_{mode}"
        errs[key] = max(errs.get(key, 0.0), e)
    torch.cuda.synchronize(dev)
    return errs


# The variants whose passes run_passes times one by one, and the passes.
PASS_VARIANTS = ("full", "no_store", "no_arith", "no_tw4")
PASS_NAMES = ("cols_forward", "rows_multiply", "cols_inverse")


def variant_passes(x, plan, left: int, out_len: int, variant: str, i16: bool,
                   out: torch.Tensor, reps: int) -> dict:
    """Device us a pair of each pass (``PASS_NAMES``) of ``variant`` from
    ``torch.profiler`` over ``reps`` calls (after one warm call); empty if
    the profiler saw no device time."""
    segment_ablation(x, plan, left, out_len, variant, i16, out=out)
    torch.cuda.synchronize(x.device)
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            segment_ablation(x, plan, left, out_len, variant, i16, out=out)
        torch.cuda.synchronize(x.device)
    pairs = sf.call_pairs(x.shape[0], out_len, plan.hop)
    us = {}
    for ev in prof.key_averages():
        for name in PASS_NAMES:
            total = (getattr(ev, "device_time_total", 0)
                     or getattr(ev, "cuda_time_total", 0))
            if name in ev.key and ev.count and total:
                us[name] = us.get(name, 0.0) + total / (reps * pairs)
    return us


def run(device="cuda", reps: int = 5, which=SHAPES, variants=VARIANTS) -> dict:
    """Every variant timed at each shape (``_probe.event_ms``, one reused
    output), with its traffic's GB/s and the differences; ``full`` bitwise
    against the shipped kernel at the headline and the long call;
    ``PASS_VARIANTS`` pass by pass (:func:`variant_passes`) at the headline
    and the long call; the three shipped passes under ``torch.profiler``
    at the headline; the plain version at the kernels line's shapes
    (headline f64 and f32, fast16 i16), and ``F.conv1d`` at the headline
    (``_probe.library_conv_ms``). At the headline, fast16 and long
    shapes, whose scratch streams through device memory, a variant faster
    than its own traffic at 3.35 TB/s fails (the compiler removed work it
    should do). ``which`` and ``variants`` narrow the sweep (the kernels
    line needs the defaults). Frees its device memory before returning."""
    for v in variants:
        _check_variant(v)
    dev = _probe.card(device)
    rows, lines, kernels, by_pass = [], [], {}, []
    for name, mode, plan, x, left, n, i16 in shapes(dev, which):
        c = x.shape[0]
        pairs = c * ((-(-n // plan.hop) + 1) // 2)
        y = torch.zeros((c, n), dtype=x.dtype, device=dev)
        t = {v: _probe.event_ms(lambda v=v: segment_ablation(
            x, plan, left, n, v, i16, out=y), reps) for v in variants}
        b = f"2^{plan.block_size.bit_length() - 1}"
        for v in variants:
            nbytes = variant_bytes(v, plan, c, x.shape[1], n, i16)
            rate = nbytes / (t[v] * 1e-3)
            if name != "2 x 30 s" and rate > roofline.HBM_BYTES_PER_S:
                raise RuntimeError(
                    f"segment ablation {name} {mode} {v}: {rate / 1e12:.3f} TB/s "
                    f"of its own traffic in {t[v]:.4f} ms, above 3.35 TB/s")
            rows.append([name, b, mode, v, t[v], t[v] * 1e3 / pairs, rate / 1e9])
        parts = [(label, a, z) for label, a, z in (
            ("gather", "full", "no_gather"), ("writeback", "full", "no_store"),
            ("pass 2 arithmetic", "full", "rows_copy"),
            ("column arithmetic", "rows_copy", "no_arith"),
            ("strided layout", "full", "no_tr"),
            ("twiddle table reads", "full", "no_tw4")) if a in t and z in t]
        lines.append(f"{name} {mode} ({pairs} pairs): " + ", ".join(
            [f"{label} ({a} - {z}) {t[a] - t[z]:.4f} ms" for label, a, z in parts]
            + [f"{v} {t[v]:.4f} ms" for v in ("no_arith", "floor") if v in t]))
        if name in ("headline", "long") and not i16:
            for v in PASS_VARIANTS:
                if v in variants:
                    us = variant_passes(x, plan, left, n, v, i16, y, reps)
                    by_pass.append([name, b, mode, v] + [
                        us[p] if p in us else "not measured" for p in PASS_NAMES])
        if name in ("headline", "long") or (name == "fast16" and mode == "i16"):
            got = segment_ablation(x, plan, left, n, "full", i16)
            want = sf.segment_filter(x, plan, left, n, i16_io=i16)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"segment ablation {name} {mode}: full is not "
                                   "bitwise the shipped kernel")
            del want
        if name == "headline" or (name == "fast16" and mode == "i16"):
            plain = _probe.event_ms(lambda: reference(x, plan, left, n, "full",
                                                      i16), 3)
            # The row times the full variant, the shipped filter: F.conv1d
            # computes it in f64 and f32. No PyTorch call has the codec's
            # 16-bit rounding, so the i16 row's library_ms is null.
            lib_ms = None
            if not i16:
                lib_ms, lib_err = _probe.library_conv_ms(
                    x, _probe.bench_taps(), plan.precision, left, n, got[0])
                lines.append(f"library {name} {mode}: F.conv1d (cuDNN, TF32 off) "
                             f"{lib_ms:.4f} ms, max abs diff from full "
                             f"{lib_err:.3e}")
            w = roofline.work(plan, c, x.shape[1], n, sample_bytes=2 if i16 else 4)
            kernels[f"probe_segment_{mode}"] = {
                "ms": t["full"], "plain_ms": plain, "library_ms": lib_ms,
                **roofline.bound_keys(w)}
        got = None
        del x, y
    head = _probe.table(
        f"segment kernel ablations (CUDA events, median of {reps}; GB/s of "
        "each variant's own traffic)",
        ["shape", "B", "mode", "variant", "ms", "us/pair", "GB/s"], rows)
    if by_pass:
        lines += _probe.table(
            f"segment kernel ablations pass by pass (torch.profiler over {reps} "
            "calls; device us a pair)", ["shape", "B", "mode", "variant",
                                          *PASS_NAMES], by_pass)
    if "headline" in which:
        seg = []
        m = len(_probe.bench_taps()) - 1
        hop = osv.choose_block_size(m + 1) - m
        for precision, mode in (("high", "f64"), ("fast", "f32")):
            us = pm.segment_passes(dev, precision, reps, frames=HEADLINE_HOPS * hop)
            for p in PASS_NAMES:
                seg.append([f"headline {mode}", p,
                            us[p] / 1e3 if p in us else "not measured"])
        lines += _probe.table(
            f"shipped segment kernel per pass at the headline shape "
            f"(torch.profiler, mean of {reps} calls)", ["shape", "pass", "ms"], seg)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {"lines": head + lines, "kernels": kernels}


def main(argv=None) -> int:
    """``[--shapes a,b] [--variants a,b] [--reps n]``: verify every
    variant, then :func:`run` (the defaults: every shape and variant, 10
    reps)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    which = tuple(a.shapes.split(","))
    bad = [w for w in which if w not in SHAPES]
    if bad:
        ap.error(f"unknown shapes {bad}; choose from {SHAPES}")
    verify()
    r = run(reps=a.reps, which=which, variants=tuple(a.variants.split(",")))
    print("\n".join(r["lines"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
