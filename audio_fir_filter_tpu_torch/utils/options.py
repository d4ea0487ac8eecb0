"""Filter options carrier.

The port's copy of ``audio_fir_filter_tpu/utils/options.py``: a mirror of
the reference ``FilterOptions`` struct (ProcessFile.h:13-19) plus the
engine knobs of both packages.
"""

from __future__ import annotations

import dataclasses
import os


def default_num_workers() -> int:
    """Default host worker count: floor(0.7 * cores), fallback 4.

    Reference: main.cp:75-76 (README.md:44 says "2/3 of
    cores" but the code uses 0.7; we follow the code).
    """
    n = int((os.cpu_count() or 0) * 0.7)
    return n if n > 0 else 4


@dataclasses.dataclass
class FilterOptions:
    # Reference-compatible options (ProcessFile.h:13-19, main.cp:43-59).
    freq: float = 15.0        # cutoff frequency, Hz      (main.cp:43 default 15)
    slope: float = 10.0       # transition band width, Hz (main.cp:45 default 10)
    normalize: bool = False   # -n: always normalize to full scale
    verbose: bool = False
    num_threads: int = 0      # 0 -> default_num_workers(); drives host I/O workers

    # Extensions beyond the reference.
    filter_type: str = "lowcut"  # lowcut|highpass|lowpass|bandpass|bandreject
    freq_hi: float | None = None  # band high edge, Hz (band filters only)
    precision: str = "auto"   # "high": double-float FFT path (<=1 LSB @ 24-bit)
                              # "fast": plain float32 FFT path
                              # "auto": by output bit depth (resolve_precision)
    engine: str = "auto"  # FFT engine: auto | pallas | fourstep | pease | stockham
                              # "auto": pallas (the segment kernel)
    block_size: int = 0       # overlap-save FFT size; 0 -> auto from kernel length
    mesh_shape: tuple[int, ...] | None = None  # (data, time) cells; None -> one device
    json_metrics: bool = False  # emit per-stage timing metrics as JSON

    def resolved_num_threads(self) -> int:
        return self.num_threads if self.num_threads > 0 else default_num_workers()

    def sharded(self) -> bool:
        """Whether a mesh of more than one cell is asked for (a 1x1 mesh is
        the single device)."""
        return self.mesh_shape is not None and tuple(self.mesh_shape) != (1, 1)


# Output encodings whose quantization step is coarse enough that the plain
# float32 FFT path already lands within 1 LSB of the float64 oracle at THAT
# depth (the JAX package's measurement, bench_artifacts/fidelity: f32 path
# max err 0.025 LSB @ 16-bit vs 6.5 LSB @ 24-bit at the production kernel
# size; the port's own gate is bench.py --fidelity).
_FAST_SAFE_ENCODINGS = frozenset({"pcm_u8", "pcm_s8", "pcm_16"})


def resolve_precision(precision: str, encoding) -> str:
    """Resolve the "auto" precision policy against the OUTPUT encoding.

    The fidelity contract is "within 1 LSB of the float64 reference at the
    output bit depth" (BASELINE.md; reference precision ladder at
    the reference's FilterCore.h:21-23). For <= 16-bit integer outputs the
    float32 engine meets that with two orders of magnitude to spare, so
    "auto" picks it (~1.8x the double-float throughput); 24-bit and wider
    outputs keep the double-float path. Explicit "high"/"fast" always win.
    """
    if precision != "auto":
        return precision
    value = getattr(encoding, "value", encoding)
    return "fast" if value in _FAST_SAFE_ENCODINGS else "high"
