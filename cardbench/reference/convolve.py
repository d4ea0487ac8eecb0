"""The plain 'same' FIR filter, an FFT convolution computed in blocks.

    y[i] = sum_{k=0}^{M} h[k] * x[i - M/2 + k],   x == 0 outside [0, N)

Overlap-save with NFFT = 2^20 points (hop NFFT - M), a few blocks at a
time, in plain PyTorch on whatever device ``x`` lies on: on the card it
filters the north-star hour in about a second, where NumPy would take
most of a minute. ``precision`` picks the arithmetic:

- ``float64``: the reference;
- ``float32`` and ``bfloat16``: the controls, the reference computed one
  step below the precision a configuration states (``high`` is float64,
  ``fast`` is float32). There is no bfloat16 FFT, so ``bfloat16`` rounds
  every operand and result to bfloat16 (the block, the spectrum of the
  taps, their product and the output) around float32 transforms, as
  bfloat16 arithmetic with a float32 accumulator does.
"""

from __future__ import annotations

import numpy as np
import torch

NFFT = 1 << 20
_REAL = {"float64": torch.float64, "float32": torch.float32,
         "bfloat16": torch.float32}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(_bf16(t.real), _bf16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


def same_fir_blocks(x: torch.Tensor, taps: np.ndarray,
                    precision: str = "float64", blocks_per_step: int = 8):
    """Yield ``(start, end, y[:, start:end])`` over the output of the 'same'
    filter of ``x`` [C, N] by ``taps`` (odd length), in order, at
    ``precision``. ``y`` is float64 for the reference, float32 for the
    controls, on ``x``'s device."""
    rdt = _REAL[precision]
    taps = np.asarray(taps, dtype=np.float64)
    m = len(taps) - 1
    if m % 2 or m >= NFFT // 2:
        raise ValueError(f"{len(taps)} taps: need an odd count below {NFFT // 2}")
    mo2, hop = m // 2, NFFT - m
    c, n = x.shape
    dev = x.device
    h = torch.zeros(NFFT, dtype=torch.float64, device=dev)
    h[: m + 1] = torch.from_numpy(taps).to(dev)
    # Correlation with h: the conjugate spectrum of the unreversed taps.
    spec = torch.conj(torch.fft.rfft(h)).to(
        torch.complex128 if rdt == torch.float64 else torch.complex64)
    if precision == "bfloat16":
        spec = _bf16(spec)
    step = hop * blocks_per_step
    for s in range(0, n, step):
        e = min(n, s + step)
        nb = -(-(e - s) // hop)
        # Padded input xp[s : s + (nb - 1) hop + NFFT], xp = [Mo2 zeros | x].
        g0, width = s - mo2, (nb - 1) * hop + NFFT
        a, b = max(g0, 0), min(g0 + width, n)
        seg = torch.zeros((c, width), dtype=rdt, device=dev)
        if b > a:
            seg[:, a - g0 : b - g0] = x[:, a:b].to(rdt)
        if precision == "bfloat16":
            seg = _bf16(seg)
        prod = torch.fft.rfft(seg.unfold(1, NFFT, hop)) * spec
        if precision == "bfloat16":
            prod = _bf16(prod)
        y = torch.fft.irfft(prod, n=NFFT)[..., :hop].reshape(c, nb * hop)
        if precision == "bfloat16":
            y = _bf16(y)
        yield s, e, y[:, : e - s]


def same_fir(x: torch.Tensor, taps: np.ndarray,
             precision: str = "float64") -> torch.Tensor:
    """The whole 'same' filter of ``x`` [C, N] at ``precision``."""
    rdt = torch.float64 if precision == "float64" else torch.float32
    out = torch.empty(x.shape, dtype=rdt, device=x.device)
    for s, e, y in same_fir_blocks(x, taps, precision):
        out[:, s:e] = y
    return out
