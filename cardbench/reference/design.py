"""Blackman windowed-sinc low-cut taps, float64, from a configuration's
cutoff, slope and sample rate.

A frozen rewrite of lowcut's design (Smith, "The Scientist and Engineer's
Guide to DSP", ch. 16; the reference tool's ``WindowedSinc`` and
``makeLowCut``): order M = 4 / (slope / fs) rounded up to an even integer,
a Blackman-windowed sinc low-pass of M + 1 taps normalised to unity gain
at DC, then spectral inversion (negate, add 1 at the centre tap). It
imports nothing of the program, so a change to the program's design shows
as a gap against these taps.
"""

from __future__ import annotations

import math

import numpy as np


def order(slope_hz: float, fs: float) -> int:
    """Kernel order M: ceil(4 fs / slope), rounded up to even."""
    bw = slope_hz / fs
    if not 0.0 < bw < 0.5:
        raise ValueError(f"slope {slope_hz} Hz at {fs} Hz is out of range")
    m = int(math.ceil(4.0 / bw))
    return m + (m & 1)


def lowcut_taps(freq_hz: float, slope_hz: float, fs: float) -> np.ndarray:
    """The M + 1 float64 taps of the low-cut (high-pass) filter."""
    fc = freq_hz / fs
    if not 0.0 < fc < 0.5:
        raise ValueError(f"cutoff {freq_hz} Hz at {fs} Hz is out of range")
    m = order(slope_hz, fs)
    n = np.arange(m + 1, dtype=np.float64)
    window = (0.42 - 0.5 * np.cos(2.0 * np.pi * n / m)
              + 0.08 * np.cos(4.0 * np.pi * n / m))
    k = n - m / 2.0
    centre = k == 0.0
    sinc = np.where(centre, 2.0 * np.pi * fc,
                    np.sin(2.0 * np.pi * fc * k) / np.where(centre, 1.0, k))
    low = sinc * window
    low = low / np.sum(low)
    high = -low
    high[m // 2] += 1.0
    return high
