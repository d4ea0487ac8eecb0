#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero and prints no
result line):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; a CUDA card is required;
2. build: nvcc builds the segment-filter kernel from the checkout;
3. kernel vs its plain PyTorch version on the card at the main path's
   shapes (2 channels, 30 s of audio, B = 2^18): high (M = 38,400 at
   96 kHz), fast (M = 38,400) and i16 (M = 17,640 at 44.1 kHz) — error,
   peak, launch count and median CUDA-event times;
4. a float64 direct-convolution oracle on excerpts (head, a block seam,
   tail) of the phase-3 kernel outputs; then kernel vs plain version at
   small edge shapes (B 256-2048, 1-3 channels, halo-extended input);
5. the main path through the CLI entry point, in-process: (a) a 10-minute
   96 kHz stereo 24-bit WAV with a metadata chunk (auto -> high, several
   segments), (b) a 5-minute 44.1 kHz stereo 16-bit WAV (the 16-bit-native
   route), (c) a loud 16-bit WAV that saturates, falls back to float32 and
   auto-normalizes. Launch counters are zeroed before (a) and read after
   (c); every mode must have launched.

Output: the phase reports, then a JSON line of per-kernel results, then
the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEED = 20261016
KERNEL_SOURCE = "audio_fir_filter_tpu_torch/csrc/segment_filter.cu"
REPLACES = "audio_fir_filter_tpu/ops/pallas_fft.py:753"
EXCERPT = 4096


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def lsb(bits: int) -> float:
    return 2.0 ** -(bits - 1)


def scaled_lsb_error(a, b, bits: int) -> float:
    """Max |a - b| in LSBs at ``bits``, relative to the output's binade
    above full scale (the ulp-relative high-precision gate)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = float(np.max(np.abs(b)))
    scale = 2.0 ** np.floor(np.log2(peak)) if peak > 1.0 else 1.0
    return float(np.max(np.abs(a - b))) / lsb(bits) / max(1.0, scale)


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
    _build.build(force=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    log = (_build.BUILD_DIR / "ptxas.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    from audio_fir_filter_tpu_torch.models import LowCut
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
        before = sf.launches[mode]
        yk, pk = sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16)
        torch.cuda.synchronize()
        check(sf.launches[mode] == before + 1, f"{mode}: launch not counted")
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
        results[mode] = {"max_abs_err": err_abs, "ms": min(ms, ms2),
                         "plain_ms": plain_ms}
    return results


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


def _run_cli(args: list[str]) -> dict:
    from audio_fir_filter_tpu_torch.cli import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main([*args, "--json-metrics"])
    text = err.getvalue()
    check(rc == 0, f"lowcut {' '.join(args)} exited {rc}: {text}")
    return json.loads(text.strip().splitlines()[-1])


def _file_excerpts(inp, out, taps, seam, bits) -> float:
    from audio_fir_filter_tpu import audio

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


def phase_main_path(card: str) -> dict:
    from audio_fir_filter_tpu import audio
    from audio_fir_filter_tpu.audio import Encoding
    from audio_fir_filter_tpu.audio.chunks import Chunk
    from audio_fir_filter_tpu.audio.synth import create_audio_file
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf
    from audio_fir_filter_tpu_torch.pipeline.stream import default_segment_len

    rng = np.random.default_rng(SEED + 1)
    meta = Chunk(b"bext", bytes(range(256)) * 3 + b"lowcut chip smoke")
    with tempfile.TemporaryDirectory(prefix="lowcut_smoke_") as tmp:
        tmp = Path(tmp)
        a_in, a_out = tmp / "long96k24.wav", tmp / "long96k24_out.wav"
        b_in, b_out = tmp / "mid44k16.wav", tmp / "mid44k16_out.wav"
        c_in, c_out = tmp / "loud44k16.wav", tmp / "loud44k16_out.wav"
        t0 = time.perf_counter()
        create_audio_file(a_in, _signal(96000.0, 600.0, rng), 96000.0,
                          encoding=Encoding.PCM_24, extra_chunks=[meta])
        create_audio_file(b_in, _signal(44100.0, 300.0, rng), 44100.0,
                          encoding=Encoding.PCM_16)
        fs = 44100.0
        t = np.arange(int(fs * 10)) / fs
        pulses = ((t * 100.0) % 1.0) < 0.05      # 5% duty, 100 Hz
        loud = (1.98 * pulses - 0.99).astype(np.float32)
        create_audio_file(c_in, np.stack([loud, loud]), fs,
                          encoding=Encoding.PCM_16)
        print(f"synthesized inputs: {time.perf_counter() - t0:.1f} s")

        for k in sf.launches:
            sf.launches[k] = 0
        ma = _run_cli([str(a_in), str(a_out)])
        mb = _run_cli([str(b_in), str(b_out)])
        mc = _run_cli([str(c_in), str(c_out)])
        counts = dict(sf.launches)
        print(f"main-path launches: {counts}")
        for k, v in counts.items():
            check(v > 0, f"kernel mode {k} never launched on the main path")

        # (a) 10 minutes, 96 kHz, 24-bit: high precision across segments.
        check(ma["precision"] == "high", f"(a) precision {ma['precision']}")
        cin = audio.read_audio(a_in).container
        cout = audio.read_audio(a_out).container
        check([c.ckid for c in cin.chunks] == [c.ckid for c in cout.chunks],
              "(a) chunk order changed")
        for x, y in zip(cin.chunks, cout.chunks):
            if x.ckid != b"data":
                check(bytes(x.data) == bytes(y.data),
                      f"(a) chunk {x.ckid!r} not byte-identical")
        plan96 = LowCut().plan(96000.0, precision="high", device="cuda")
        seam = default_segment_len(plan96, channels=2)
        frames = ma["frames"]
        check(frames > 2 * seam, f"(a) {frames} frames do not span 3 segments")
        err_a = _file_excerpts(a_in, a_out, LowCut().taps(96000.0), seam, 24)
        print(f"(a) 96 kHz 24-bit {frames} frames x 2 ch, M={plan96.m}, "
              f"B={plan96.block_size}, segment {seam} frames: excerpts "
              f"{err_a:.4f} LSB@24 (output quantized to 24 bits)")
        check(err_a <= 1.0, f"(a) excerpt error {err_a} LSB@24 > 1")

        # (b) 5 minutes, 44.1 kHz, 16-bit: the 16-bit-native route.
        check(mb["precision"] == "fast", f"(b) precision {mb['precision']}")
        plan44 = LowCut().plan(44100.0, precision="fast", device="cuda")
        err_b = _file_excerpts(b_in, b_out, LowCut().taps(44100.0),
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

        for tag, m in (("a", ma), ("b", mb), ("c", mc)):
            stages = ", ".join(f"{k} {m[k]:.3f} s" for k in
                               ("read", "design", "filter", "normalize", "write"))
            print(f"stages ({tag}) on {card}: {stages}; "
                  f"{m['frames']} frames x {m['channels']} ch")
    return counts


def main() -> int:
    env = phase_environment()
    phase_build()
    kernels = phase_kernels()
    phase_edge_shapes()
    counts = phase_main_path(env["card"])
    rows = [{"name": f"segment_filter_{mode}", "route": "cuda",
             "source": KERNEL_SOURCE, "replaces": REPLACES,
             "launches": counts[mode], **kernels[mode]}
            for mode, *_ in MODES]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
