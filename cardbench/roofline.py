"""The frozen roofline of a filter call on one H100: the least device time
the card could take for the work, from the bytes it must move and the
flops it must do.

- Bytes: each input sample read once and each output sample written once,
  at the route's sample width (4 for float32 in and out, 2 for the
  16-bit-native route).
- Flops: per hop of output per channel, one real forward and one real
  inverse FFT of B points at 2.5 B log2 B each and (B/2 + 1) complex
  multiplies at 6 flops: 5 B log2 B + 6 (B/2 + 1). B and the hop are the
  configuration file's, never the program's plan, so a program that
  retunes B moves its time and not the yardstick. A channel of N frames
  takes ceil(N / hop) hops.
- Peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit): 3.35 TB/s of
  HBM3; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
  cores. The segment kernel issues no tensor-core (mma / wmma / dmma)
  instruction, so ``high`` (float64 arithmetic) is held to 34, not to the
  67 TFLOP/s of the FP64 tensor cores.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"high": 34e12, "fast": 67e12}


def fft_conv_flops(b: int, hops: int) -> float:
    return hops * (5.0 * b * math.log2(b) + 6.0 * (b // 2 + 1))


def bound(channels: int, frames: int, sample_bytes: int, block_size: int,
          hop: int, precision: str) -> dict:
    """Least seconds for filtering ``channels`` x ``frames`` in and out:
    ``bytes_s``, ``ops_s``, ``bound_s`` (the larger) and ``bound_by``."""
    nbytes = 2.0 * sample_bytes * channels * frames
    flops = fft_conv_flops(block_size, channels * -(-frames // hop))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[precision]
    return {"bytes": nbytes, "flops": flops, "bytes_s": t_bytes,
            "ops_s": t_ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
