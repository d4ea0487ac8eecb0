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
  and the strided layout -> zeros, through the scratch and stored.

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
data-movement floor = no_arith. Shapes: the bench's headline (2 channels x
1008 hops at 96 kHz, ``-f 15 -s 10``: M = 38,400, B = 2^18, f64 and f32),
its fast16 call (the same at 504 hops, 16-bit I/O) and chip_smoke's
2 x 30 s (phase 3's shapes: i16 at 44.1 kHz, M = 17,640), whose scratch
the L2 holds in part. The card's library instantiates B = 2^18 only:
another B raises there; the plain versions take any.
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
            "no_arith", "floor")
# Variant ids of csrc/probe_segment.cu.
_ID = {v: i for i, v in enumerate(VARIANTS)}
# What each variant keeps: the gather, the stores of y, the column passes'
# arithmetic, the strided layout, pass 2's arithmetic.
_KEEPS = {
    "full": (True, True, True, True, True),
    "no_gather": (False, True, True, True, True),
    "no_store": (True, False, True, True, True),
    "no_tr": (True, True, True, False, True),
    "rows_copy": (True, True, True, True, False),
    "no_arith": (True, True, False, True, False),
    "floor": (False, True, False, False, False),
}
# Variants whose plain version is exact (zeros or a shift): held bitwise.
EXACT = ("no_gather", "no_store", "no_arith", "floor")

HEADLINE_HOPS = 1008   # the bench's --segment-blocks
FAST16_HOPS = 504      # the bench's fast16 call
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
    peak = torch.zeros((), dtype=torch.float32, device=dev)
    if c == 0 or out_len == 0:
        return out, peak
    mode = sf.mode_of(plan, i16_io)
    sf.run_entry("probe_segment", f"lowcut_probe_segment_{mode}", x, out, peak,
                 plan, left, out_len, _ID[variant])
    launches[f"probe_segment_{mode}"] += 1
    return out, peak


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


# ---------------------------------------------------- traffic, shapes

def variant_bytes(variant: str, plan, channels: int, n_in: int, out_len: int,
                  i16_io: bool = False) -> int:
    """Device-memory bytes ``variant`` must move: the signal read once (if
    it gathers), y written once (if it stores), the scratch written by pass
    1, read and written by pass 2 and read by pass 3, and the tables once
    each (the four-step twiddle, read by passes 1 and 3 with their
    arithmetic; H, read by pass 2 with its own)."""
    gather, store, arith, _, rows = _KEEPS[variant]
    b, cx = plan.block_size, plan.H.element_size()
    sb = 2 if i16_io else 4
    pairs = channels * ((-(-out_len // plan.hop) + 1) // 2)
    n = 4 * pairs * cx * b
    n += sb * channels * n_in if gather else 0
    n += sb * channels * out_len if store else 0
    n += 2 * cx * b if arith else 0
    n += cx * b if rows else 0
    return n


def shapes(dev, which=("headline", "fast16", "2 x 30 s")):
    """(shape name, mode, plan, x, left, out_len, i16) of each timed call:
    the bench's headline (extended segment, f64 and f32) and fast16 call
    (16-bit I/O), and chip_smoke's phase-3 calls of 2 x 30 s."""
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
    calls (f64, f32, i16): bitwise for the zero and shift variants, within
    the stated tolerance (one PCM code for 16-bit I/O) for the others;
    every peak against its plain version's, and ``no_store``'s equal to
    ``full``'s bit for bit."""
    dev = _probe.card(device)
    errs = {}
    for _, mode, plan, x, left, n, i16 in shapes(dev, ("2 x 30 s",)):
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
        errs[f"probe_segment_{mode}"] = e
    torch.cuda.synchronize(dev)
    return errs


def run(device="cuda", reps: int = 5) -> dict:
    """Every variant timed at each shape (``_probe.event_ms``, one reused
    output), with its traffic's GB/s and the differences; ``full`` bitwise
    against the shipped kernel at the headline; the three passes under
    ``torch.profiler`` at the headline; the plain version at the kernels
    line's shapes (headline f64 and f32, fast16 i16), and ``F.conv1d`` at
    the headline (``_probe.library_conv_ms``). At the headline and
    fast16 shapes, whose scratch streams through device memory, a variant
    faster than its own traffic at 3.35 TB/s fails (the compiler removed
    work it should do). Frees its device memory before returning."""
    dev = _probe.card(device)
    rows, lines, kernels = [], [], {}
    for name, mode, plan, x, left, n, i16 in shapes(dev):
        c = x.shape[0]
        pairs = c * ((-(-n // plan.hop) + 1) // 2)
        y = torch.zeros((c, n), dtype=x.dtype, device=dev)
        t = {v: _probe.event_ms(lambda v=v: segment_ablation(
            x, plan, left, n, v, i16, out=y), reps) for v in VARIANTS}
        for v in VARIANTS:
            nbytes = variant_bytes(v, plan, c, x.shape[1], n, i16)
            rate = nbytes / (t[v] * 1e-3)
            if name != "2 x 30 s" and rate > roofline.HBM_BYTES_PER_S:
                raise RuntimeError(
                    f"segment ablation {name} {mode} {v}: {rate / 1e12:.3f} TB/s "
                    f"of its own traffic in {t[v]:.4f} ms, above 3.35 TB/s")
            rows.append([name, mode, v, t[v], t[v] * 1e3 / pairs, rate / 1e9])
        lines.append(
            f"{name} {mode} ({pairs} pairs): gather (full - no_gather) "
            f"{t['full'] - t['no_gather']:.4f} ms, writeback (full - no_store) "
            f"{t['full'] - t['no_store']:.4f} ms, pass 2 arithmetic "
            f"(full - rows_copy) {t['full'] - t['rows_copy']:.4f} ms, column "
            f"arithmetic (rows_copy - no_arith) "
            f"{t['rows_copy'] - t['no_arith']:.4f} ms, strided layout "
            f"(full - no_tr) {t['full'] - t['no_tr']:.4f} ms, data-movement "
            f"floor (no_arith) {t['no_arith']:.4f} ms, floor {t['floor']:.4f} ms")
        if name == "headline" or (name == "fast16" and mode == "i16"):
            got = segment_ablation(x, plan, left, n, "full", i16)
            want = sf.segment_filter(x, plan, left, n, i16_io=i16)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"segment ablation {name} {mode}: full is not "
                                   "bitwise the shipped kernel")
            del want
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
            del got
            w = roofline.work(plan, c, x.shape[1], n, sample_bytes=2 if i16 else 4)
            kernels[f"probe_segment_{mode}"] = {
                "ms": t["full"], "plain_ms": plain, "library_ms": lib_ms,
                **roofline.bound_keys(w)}
        del x, y
    head = _probe.table(
        f"segment kernel ablations, B = 2^18 (CUDA events, median of {reps}; "
        "GB/s of each variant's own traffic)",
        ["shape", "mode", "variant", "ms", "us/pair", "GB/s"], rows)
    seg = []
    m = len(_probe.bench_taps()) - 1
    hop = osv.choose_block_size(m + 1) - m
    for precision, mode in (("high", "f64"), ("fast", "f32")):
        us = pm.segment_passes(dev, precision, reps, frames=HEADLINE_HOPS * hop)
        for p in ("cols_forward", "rows_multiply", "cols_inverse"):
            seg.append([f"headline {mode}", p,
                        us[p] / 1e3 if p in us else "not measured"])
    lines += _probe.table(
        f"shipped segment kernel per pass at the headline shape "
        f"(torch.profiler, mean of {reps} calls)", ["shape", "pass", "ms"], seg)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {"lines": head + lines, "kernels": kernels}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
