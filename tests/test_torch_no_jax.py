"""The port imports neither JAX nor the JAX package: with ``jax`` and
``audio_fir_filter_tpu`` blocked in ``sys.modules``, a fresh interpreter
imports the package (and chip_smoke.py), filters a tiny WAV on the CPU
through ``process_file``, runs ``--engine fourstep`` and ``--profile``
through the CLI and a ``--resume`` batch, imports every module of
``audio_fir_filter_tpu_torch.parallel`` and runs ``--mesh 1x2``, runs the
bench at a tiny size, and imports every module of ``audio_fir_filter_tpu_torch.experiments``
and runs one plain version of each probe, the segment ablations and the
breakdown scripts (the batch script writes its inputs). A static check reads every file of the
port, chip_smoke.py and segment_ab.py for an import of the JAX package,
and another every module of ``pipeline/`` and ``parallel/`` for an import
of the segment kernel's wrapper (they reach it through ``overlap_save``)."""

import ast
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_fir_filter_tpu"] = None   # and so does the JAX package
sys.path.insert(0, sys.argv[1])
import numpy as np
import audio_fir_filter_tpu_torch
import audio_fir_filter_tpu_torch.cli
import chip_smoke
from audio_fir_filter_tpu_torch.audio import Encoding, read_audio
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.pipeline import process_file
from audio_fir_filter_tpu_torch.utils.options import FilterOptions

x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 3000)).astype(np.float32)
create_audio_file(sys.argv[2] + "/in.wav", x, 8000.0, encoding=Encoding.PCM_24)
opts = FilterOptions(freq=100.0, slope=200.0, block_size=1024)
m = process_file(sys.argv[2] + "/in.wav", sys.argv[2] + "/out.wav", opts,
                 show_progress=False, device="cpu")
y = read_audio(sys.argv[2] + "/out.wav").samples
assert y.shape == (2, 3000) and np.isfinite(y).all() and m["precision"] == "high"

from audio_fir_filter_tpu_torch.cli import main
cpu = ["--device", "cpu", "-f", "100", "-s", "200", "--block-size", "1024"]
d = sys.argv[2]
assert main([d + "/in.wav", d + "/four.wav", "--engine", "fourstep", *cpu]) == 0
create_audio_file(d + "/in2.wav", x[:, :2000], 8000.0, encoding=Encoding.PCM_16)
assert main([d + "/in.wav", d + "/in2.wav", d + "/batch", "--resume", *cpu]) == 0
assert read_audio(d + "/batch/in2.wav").samples.shape == (2, 2000)
assert (read_audio(d + "/batch/in.wav").samples == y).all()
assert main([d + "/in.wav", d + "/prof.wav", "--profile", d + "/prof", *cpu]) == 0
import os
assert os.path.isfile(d + "/prof/trace.json")
import audio_fir_filter_tpu_torch.parallel
import audio_fir_filter_tpu_torch.parallel.distributed
import audio_fir_filter_tpu_torch.parallel.mesh
import audio_fir_filter_tpu_torch.parallel.scaling_bench
import audio_fir_filter_tpu_torch.parallel.sharded_conv
assert main([d + "/in.wav", d + "/mesh.wav", "--mesh", "1x2", *cpu]) == 0
assert np.abs(read_audio(d + "/mesh.wav").samples - y).max() <= 2.0 ** -23
from audio_fir_filter_tpu_torch import bench
assert bench.main(["--device", "cpu", "--block-size", "1024", "--freq", "100",
                   "--slope", "200", "--sample-rate", "8000",
                   "--segment-blocks", "2", "--reps", "1", "--fidelity",
                   "--roofline"]) == 0
import importlib
import pkgutil
import torch
import audio_fir_filter_tpu_torch.experiments as ex
names = [m.name for m in pkgutil.iter_modules(ex.__path__)]
assert len(names) == 12, names
mods = {n: importlib.import_module("audio_fir_filter_tpu_torch.experiments." + n)
        for n in names}
z = torch.zeros((1, 512, 512), dtype=torch.complex64)
mods["mosaic_stages"].stage(z, "fwd r8")
mods["mosaic_stages2"].chain(z, "inv r4")
mods["fused_phase_decomp"].phases(torch.zeros((2, 256)),
                                  torch.ones((16, 16), dtype=torch.complex64),
                                  "no_tr")
mods["copy_floor_probe"].copy_floor(torch.zeros((1, 2, 512, 512)), "tr")
mods["dma_bw_micro"].bw(torch.zeros((1, 16, 512)), "in")
mods["dispatch_floor_probe"].passthru(torch.zeros((1, 2, 512, 512)))
from audio_fir_filter_tpu_torch.ops import kernel_design as kd
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
plan = osv.make_plan(kd.highpass_taps(0.05, 64), "fast", 512, "cpu")
for v in mods["fast_decomp_r05"].VARIANTS:
    mods["fast_decomp_r05"].segment_ablation(torch.zeros((2, 1000)), plan,
                                             plan.mo2, 1000, v)
small = ["--device", "cpu", "--block-size", "1024", "--freq", "100",
         "--slope", "200", "--sample-rate", "8000", "--reps", "1", "--hops", "4"]
assert mods["segment_decomp"].main(small) == 0
assert mods["chunk_sweep"].main(small + ["--chunks", "2"]) == 0
assert len(mods["batch_cfg4"].make_inputs(__import__("pathlib").Path(d), 2, 0.1)) == 2
assert not any(k.split(".")[0] in ("jax", "audio_fir_filter_tpu")
               for k in sys.modules if sys.modules[k] is not None)
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO), str(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


# ``from audio_fir_filter_tpu <name>`` / ``from audio_fir_filter_tpu.x`` /
# ``import audio_fir_filter_tpu`` — the JAX package, not ``_torch``.
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+audio_fir_filter_tpu(\s|\.)|import\s+audio_fir_filter_tpu(\s|\.|,|$))",
    re.M)


def test_no_file_of_the_port_imports_the_jax_package():
    files = [*sorted((REPO / "audio_fir_filter_tpu_torch").rglob("*.py")),
             REPO / "chip_smoke.py", REPO / "segment_ab.py"]
    assert len(files) > 30
    bad = [f"{f.relative_to(REPO)}:{m.group(0).strip()}"
           for f in files for m in _JAX_PACKAGE_IMPORT.finditer(f.read_text())]
    assert bad == []
    # The pattern does catch the JAX package and leaves the port alone.
    assert _JAX_PACKAGE_IMPORT.search("from audio_fir_filter_tpu import audio")
    assert _JAX_PACKAGE_IMPORT.search("    from audio_fir_filter_tpu.ops import x")
    assert _JAX_PACKAGE_IMPORT.search("import audio_fir_filter_tpu.audio")
    assert not _JAX_PACKAGE_IMPORT.search("from audio_fir_filter_tpu_torch import a")
    assert not _JAX_PACKAGE_IMPORT.search("import audio_fir_filter_tpu_torch")


def _imports_segment_wrapper(source: str) -> list[str]:
    """The imports in ``source`` that bind ``ops.segment_filter``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.split(".")[-1] == "segment_filter" or (
                    mod.split(".")[-1] == "ops"
                    and any(a.name == "segment_filter" for a in node.names)):
                found.append(f"{'.' * node.level}{mod}")
        elif isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.endswith("ops.segment_filter")]
    return found


def test_pipeline_and_parallel_reach_the_kernels_through_overlap_save():
    port = REPO / "audio_fir_filter_tpu_torch"
    files = sorted([*(port / "pipeline").rglob("*.py"),
                    *(port / "parallel").rglob("*.py")])
    assert len(files) >= 8
    bad = {str(f.relative_to(REPO)): got for f in files
           if (got := _imports_segment_wrapper(f.read_text()))}
    assert bad == {}
    # The scan does catch each way of writing the import.
    for line in ("from ..ops import segment_filter as sf",
                 "from ..ops import (overlap_save,\n    segment_filter)",
                 "from ..ops.segment_filter import qualifies",
                 "from audio_fir_filter_tpu_torch.ops import segment_filter",
                 "import audio_fir_filter_tpu_torch.ops.segment_filter"):
        assert _imports_segment_wrapper(line), line
    assert not _imports_segment_wrapper("from ..ops import overlap_save as osv")
