"""Seeded inputs, made on the device in a few large calls.

The signal is what a low-cut filter is for: broadband content with
rumble under the cutoff. Per sample, a * (0.9 u + 0.1 sin(2 pi f_r t +
phi)), with u uniform in [-1, 1), f_r = ``rumble_hz`` (under every
configuration's cutoff), phi drawn per channel and a = 10^(peak_dbfs / 20),
so the peak stays under ``peak_dbfs`` and the filtered peak under full
scale: no run clips or normalizes, whatever the seed. Every seed gives the
same sizes; only the values move.
"""

from __future__ import annotations

import math

import torch


def signal(seed: int, shape: tuple[int, ...], fs: float, params: dict,
           device) -> torch.Tensor:
    """float32 [..., channels, frames] on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003) % (1 << 63))
    amp = 10.0 ** (params["peak_dbfs"] / 20.0)
    x = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    phi = torch.rand(shape[:-1] + (1,), generator=g, device=device,
                     dtype=torch.float64) * (2 * math.pi)
    w = 2 * math.pi * params["rumble_hz"] / fs
    step = 1 << 24      # bounds the float64 temporaries
    for a in range(0, shape[-1], step):
        b = min(shape[-1], a + step)
        t = torch.arange(a, b, device=device, dtype=torch.float64)
        part = 0.9 * (2.0 * x[..., a:b].to(torch.float64) - 1.0)
        part += 0.1 * torch.sin(t * w + phi)
        x[..., a:b] = (amp * part).to(torch.float32)
    return x
