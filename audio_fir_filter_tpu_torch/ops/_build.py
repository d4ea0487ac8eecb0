"""Build the CUDA kernels at first use and bind them with ctypes.

Each kernel source ``csrc/<name>.cu`` (plain C entry points, no PyTorch
headers: seconds, not minutes) is compiled by its own ``nvcc`` for
``sm_90a`` into ``build/lowcut_torch/lib<name>.so`` beside the package, a
directory git ignores. A library is rebuilt when any file under ``csrc/``
(headers included) is newer than it, so a stale library never lacks an
entry point. Nothing here runs at import: the CPU tests import every module
on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lowcut_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Per kernel source: its entry points and their shared argtypes.
FAMILIES = {
    "segment_filter": (
        ("lowcut_segment_filter_f32", "lowcut_segment_filter_f64",
         "lowcut_segment_filter_i16"),
        # x, y, peak, H, tw4, w1, w2, scratch, channels, n_in, out_len,
        # left, m, log_n1, log_n2, chunk_pairs, stream
        [_p, _p, _p, _p, _p, _p, _p, _p, _i, _ll, _ll, _ll, _i, _i, _i, _ll, _p],
    ),
    "conv_blocks": (
        ("lowcut_conv_blocks_f32", "lowcut_conv_blocks_f64"),
        # blocks, out, H, tw4, w1, w2, scratch, nb, log_n1, log_n2,
        # chunk_pairs, stream
        [_p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _ll, _p],
    ),
    # The decomposition probes of experiments/ (nothing on the program's
    # path calls them).
    "probe_floors": (
        ("lowcut_probe_empty", "lowcut_probe_passthru", "lowcut_probe_bw",
         "lowcut_probe_bw_ring", "lowcut_probe_copy_floor",
         "lowcut_probe_cluster_occupancy"),
        # x, y, aux, a, b, c, mode, stream
        [_p, _p, _p, _ll, _ll, _ll, _i, _p],
    ),
    "probe_phases": (
        ("lowcut_probe_phases_f32", "lowcut_probe_phases_f64",
         "lowcut_probe_fused_occupancy"),
        # blocks, out, H, tw4, w1, w2, scratch, pairs, log_n1, log_n2,
        # variant, stream (the fused variants: pairs = real blocks)
        [_p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _p],
    ),
    "probe_stages": (
        ("lowcut_probe_stages_f32", "lowcut_probe_stages_f64"),
        # z, out, table, batch, case, param, stream
        [_p, _p, _p, _ll, _i, _i, _p],
    ),
    "probe_segment": (
        ("lowcut_probe_segment_f32", "lowcut_probe_segment_f64",
         "lowcut_probe_segment_i16"),
        # the segment filter's arguments, then variant, stream
        [_p, _p, _p, _p, _p, _p, _p, _p, _i, _ll, _ll, _ll, _i, _i, _i, _ll,
         _i, _p],
    ),
}
# Per kernel source: its queries of what a build holds at one split (mode
# or precision, log_n1, log_n2, out), one signature for all.
QUERIES = {
    "segment_filter": ("lowcut_segment_pass1_occupancy",
                       "lowcut_segment_pass2_occupancy",
                       "lowcut_segment_pass3_occupancy",
                       "lowcut_segment_twiddle_layout"),
    "conv_blocks": ("lowcut_conv_blocks_occupancy",),
}
QUERY_ARGTYPES = [_i, _i, _i, _p]


def _sources_mtime() -> float:
    return max(p.stat().st_mtime for p in CSRC.iterdir() if p.is_file())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels); "
                       "put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def build(name: str, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    any file under ``csrc/``."""
    if name not in FAMILIES:
        raise ValueError(f"unknown kernel source {name!r}")
    lib = BUILD_DIR / f"lib{name}.so"
    if not force and lib.is_file() and lib.stat().st_mtime >= _sources_mtime():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")
    # ptxas -v resource report (registers, shared memory, spills).
    (BUILD_DIR / f"{name}.ptxas.log").write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)  # atomic for concurrent first uses
    return lib


def build_all(force: bool = False) -> list[Path]:
    """Build every kernel source, one ``nvcc`` each, all at once."""
    with ThreadPoolExecutor(len(FAMILIES)) as pool:
        return list(pool.map(lambda n: build(n, force), FAMILIES))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with the argtypes of its
    entry points and queries set."""
    lib = ctypes.CDLL(str(build(name)))
    entries, argtypes = FAMILIES[name]
    for names, types in ((entries, argtypes),
                         (QUERIES.get(name, ()), QUERY_ARGTYPES)):
        for entry in names:
            fn = getattr(lib, entry)
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib
