"""FIR filter model families (counterpart of
``audio_fir_filter_tpu/models/fir.py``).

A model is a specification in Hz; ``taps(sample_rate)`` designs the float64
kernel for a file's rate and ``plan(sample_rate, ..., device)`` returns the
port's cached overlap-save plan on that device. The five families and the
``make_model`` errors are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import kernel_design as kd
from ..ops import overlap_save as osv
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FIRFilter:
    """Base: a linear-phase type-I windowed-sinc filter specification."""

    slope: float = 10.0   # transition band width, Hz (reference -s default)

    def _design(self, fs: float) -> np.ndarray:
        raise NotImplementedError

    def kernel_order(self, fs: float) -> int:
        return kd.kernel_length(self.slope / fs)

    def taps(self, fs: float) -> np.ndarray:
        """float64 kernel (odd length) for the given sample rate."""
        if fs <= 0:
            raise ValueError(f"sample rate must be positive, got {fs}")
        return self._design(fs)

    def plan(self, fs: float, precision: str = osv.HIGH,
             block_size: int = 0, device="cuda",
             engine: str = "auto") -> osv.OverlapSavePlan:
        """The port's overlap-save plan on ``device``, cached per key."""
        dev = resolve_device(device)
        key = (fs, precision, block_size, dev, engine)
        cache = object.__getattribute__(self, "__dict__").setdefault("_plans", {})
        if key not in cache:
            cache[key] = osv.make_plan(self.taps(fs), precision, block_size,
                                       dev, engine)
        return cache[key]


@dataclasses.dataclass(frozen=True)
class LowCut(FIRFilter):
    """High-pass ("low cut") — the reference's filter. freq/slope in Hz."""

    freq: float = 15.0    # reference -f default (main.cp:43)

    def _design(self, fs: float) -> np.ndarray:
        return kd.highpass_taps(self.freq / fs, self.kernel_order(fs))


class HighPass(LowCut):
    """Alias family: high-pass == low-cut."""


@dataclasses.dataclass(frozen=True)
class LowPass(FIRFilter):
    freq: float = 20000.0

    def _design(self, fs: float) -> np.ndarray:
        return kd.lowpass_taps(self.freq / fs, self.kernel_order(fs))


@dataclasses.dataclass(frozen=True)
class BandPass(FIRFilter):
    f_lo: float = 20.0
    f_hi: float = 20000.0

    def _design(self, fs: float) -> np.ndarray:
        return kd.bandpass_taps(self.f_lo / fs, self.f_hi / fs, self.kernel_order(fs))


@dataclasses.dataclass(frozen=True)
class BandReject(FIRFilter):
    f_lo: float = 50.0
    f_hi: float = 60.0

    def _design(self, fs: float) -> np.ndarray:
        return kd.bandreject_taps(self.f_lo / fs, self.f_hi / fs, self.kernel_order(fs))


FILTER_TYPES = {
    "lowcut": LowCut,
    "highpass": HighPass,
    "lowpass": LowPass,
    "bandpass": BandPass,
    "bandreject": BandReject,
}


def make_model(filter_type: str, freq: float, slope: float,
               freq_hi: float | None = None) -> FIRFilter:
    """Build a filter model from CLI-style options.

    ``freq`` is the cutoff (or the band's low edge for band filters);
    ``freq_hi`` is the band's high edge, required for bandpass/bandreject.
    The default "lowcut" is the reference tool's only filter; the rest are
    extensions built from the same windowed-sinc primitives.
    """
    cls = FILTER_TYPES.get(filter_type)
    if cls is None:
        raise ValueError(
            f"unknown filter type {filter_type!r} "
            f"(use one of {', '.join(sorted(FILTER_TYPES))})")
    if cls in (BandPass, BandReject):
        if freq_hi is None:
            raise ValueError(
                f"--filter {filter_type} requires --frequency-high")
        return cls(f_lo=freq, f_hi=freq_hi, slope=slope)
    if freq_hi is not None:
        raise ValueError(
            f"--frequency-high only applies to band filters, not {filter_type}")
    return cls(freq=freq, slope=slope)
