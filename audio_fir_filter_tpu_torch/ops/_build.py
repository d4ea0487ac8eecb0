"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/segment_filter.cu`` (plain C entry points, no
PyTorch headers: seconds, not minutes) for ``sm_90a`` into
``build/lowcut_torch/`` beside the package, a directory git ignores. The
library is rebuilt when the source is newer than it. Nothing here runs at
import: the CPU tests import every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "segment_filter.cu"
BUILD_DIR = _PKG.parent / "build" / "lowcut_torch"
LIBRARY = BUILD_DIR / "libsegment_filter.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

ENTRY_POINTS = ("lowcut_segment_filter_f32", "lowcut_segment_filter_f64",
                "lowcut_segment_filter_i16")


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


def build(force: bool = False) -> Path:
    """Compile the kernel library if missing or older than its source."""
    if (not force and LIBRARY.is_file()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")
    # ptxas -v resource report (registers, shared memory, spills).
    (BUILD_DIR / "ptxas.log").write_text(r.stdout + r.stderr)
    os.replace(tmp, LIBRARY)  # atomic for concurrent first uses
    return LIBRARY


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        # x, y, peak, H, tw4, w1, w2, scratch, channels, n_in, out_len,
        # left, m, log_n1, log_n2, chunk_pairs, stream
        fn.argtypes = [p, p, p, p, p, p, p, p, i, ll, ll, ll, i, i, i, ll, p]
        fn.restype = ctypes.c_int
    return lib
