"""BASELINE cfg4, the 64-file batch, through the port's CLI.

Counterpart of ``experiments/batch_cfg4.py``: 64 equal-length mono 44.1 kHz
16-bit WAVs of 2 s each, drawn from ``np.random.default_rng(0)`` as the JAX
script draws them, then one run of the whole tool as a user runs it,

    bin/lowcut-torch -O -f 20 -s 10 --json-metrics <64 files> <outdir>

in a subprocess (start-up, CUDA context and kernel build included). Prints
the wall time, the sum of the per-file stages (``read``, ``design``,
``filter``, ``normalize``, ``write`` from ``--json-metrics``), the realtime
factor (seconds of audio per second of wall) and the count of outputs.
Any failure (a non-zero exit, a missing or extra output, a missing metrics
line) raises, and ``main`` exits non-zero.

    python -m audio_fir_filter_tpu_torch.experiments.batch_cfg4
    python -m audio_fir_filter_tpu_torch.experiments.batch_cfg4 --device cpu --files 4
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..audio import Encoding
from ..audio.synth import create_audio_file

ROOT = Path(__file__).resolve().parents[2]
LAUNCHER = ROOT / "bin" / "lowcut-torch"
FS = 44100.0
SECONDS = 2.0
N_FILES = 64
FLAGS = ("-O", "-f", "20", "-s", "10", "--json-metrics")
STAGES = ("read", "design", "filter", "normalize", "write")


def make_inputs(dest: Path, n_files: int = N_FILES,
                seconds: float = SECONDS) -> list[Path]:
    """The batch's WAVs in ``dest``: mono, 44.1 kHz, 16-bit, uniform in
    [-0.5, 0.5) from one ``default_rng(0)`` stream, file by file."""
    n = int(FS * seconds)
    rng = np.random.default_rng(0)
    files = []
    for i in range(n_files):
        x = rng.uniform(-0.5, 0.5, (1, n)).astype(np.float32)
        p = dest / f"in_{i:02d}.wav"
        create_audio_file(p, x, FS, encoding=Encoding.PCM_16)
        files.append(p)
    return files


def run(workdir: Path, device: str = "cuda", n_files: int = N_FILES,
        seconds: float = SECONDS) -> dict:
    """Write the inputs under ``workdir``, run the batch into
    ``workdir/out`` and return its numbers and the printed ``lines``."""
    workdir = Path(workdir)
    src, out = workdir / "in", workdir / "out"
    src.mkdir(parents=True, exist_ok=True)
    files = make_inputs(src, n_files, seconds)
    cmd = [sys.executable, str(LAUNCHER), *FLAGS, "--device", device,
           *map(str, files), str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"batch exited {proc.returncode}: {proc.stderr[-2000:]}")
    metrics = [json.loads(s) for s in proc.stderr.splitlines()
               if s.strip().startswith("{")]
    got = sorted(p.name for p in out.iterdir() if p.suffix == ".wav")
    if got != sorted(p.name for p in files):
        raise RuntimeError(f"expected {n_files} outputs, got {len(got)}")
    if len(metrics) != n_files:
        raise RuntimeError(f"{len(metrics)} metrics lines for {n_files} files")
    stages = {k: sum(m[k] for m in metrics) for k in STAGES}
    audio_s = n_files * seconds
    r = {"files": n_files, "outputs": len(got), "wall_s": wall,
         "stages_s": stages, "stage_sum_s": sum(stages.values()),
         "realtime_x": audio_s / wall,
         "samples_per_s": n_files * int(FS * seconds) / wall}
    r["lines"] = [
        f"batch_cfg4 on {device}: {n_files} x {seconds:g} s mono 44.1 kHz "
        f"16-bit through bin/lowcut-torch {' '.join(FLAGS)}: wall "
        f"{wall:.3f} s (start-up and kernel build included), "
        f"{r['outputs']} outputs; stages summed over files "
        f"{r['stage_sum_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"); {audio_s:g} s of audio -> {r['realtime_x']:.1f}x realtime, "
        f"{r['samples_per_s'] / 1e6:.3f} Msamples/s"]
    return r


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--files", type=int, default=N_FILES)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="lowcut_cfg4_") as tmp:
        print("\n".join(run(Path(tmp), a.device, a.files, a.seconds)["lines"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
