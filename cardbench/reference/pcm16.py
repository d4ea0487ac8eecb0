"""16-bit PCM on top of the plain reference: the codec's quantization rule
and the 'same' FIR filter of int16 codes, in plain PyTorch.

The codec writes a float sample y (full scale 1.0) as the int16 code

    clamp(round_half_even(y * 2^15), -2^15, 2^15 - 1),

so a filtered code is that rule applied to the filter of the input codes
/ 2^15. The filter is linear and 2^15 a power of two, which scales every
float operand and result exactly, rounding included: the filter of the
codes themselves (:func:`.convolve.same_fir_blocks` of the int16 tensor)
is the filter of codes / 2^15 times 2^15 bit for bit, at every precision
of :mod:`.convolve`: the output in codes before the codec rounds it.
Values below are in code units (one unit is 1 LSB at 16 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from . import convolve

SCALE = 32768.0
LO, HI = -32768.0, 32767.0


def rails(c: torch.Tensor) -> torch.Tensor:
    """``c`` clamped to the int16 rails."""
    return c.clamp(LO, HI)


def quantize_codes(c: torch.Tensor) -> torch.Tensor:
    """The codes of ``c`` (code units, before rounding): rounded half to
    even and clamped to the rails, in ``c``'s float dtype."""
    return rails(torch.round(c))


def quantize(y: torch.Tensor) -> torch.Tensor:
    """The codec's rule for ``y`` at full scale 1.0, in ``y``'s float dtype."""
    return quantize_codes(y * SCALE)


def peak(q: torch.Tensor) -> float:
    """max |value| of ``q`` (int16 codes or floats), as a float: 32768 for
    a code of -32768, which an int16 ``abs`` would wrap."""
    return float(max(q.max().item(), -q.min().item()))


def same_fir_codes(x16: torch.Tensor, taps: np.ndarray,
                   precision: str = "float64") -> torch.Tensor:
    """The whole filter of ``x16`` at ``precision``, quantized by the
    codec's rule: int16 [C, N] on ``x16``'s device."""
    out = torch.empty(x16.shape, dtype=torch.int16, device=x16.device)
    for s, e, c in convolve.same_fir_blocks(x16, taps, precision):
        out[:, s:e] = quantize_codes(c).to(torch.int16)
    return out
