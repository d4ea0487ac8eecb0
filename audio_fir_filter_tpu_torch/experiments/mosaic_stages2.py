"""The radix-4 chain against the radix-8 chain, and a transpose, on the card.

Counterpart of ``experiments/mosaic_stages2.py`` (``pallas_block_op``, the
``pallas_call`` at :76): on [8, 512, 512] complex blocks, the forward and
inverse 512-point chains as radix 4 (``fft_core.dif_plan``, 5 stages) and
radix 8 (``fft_core.dif_plan_r8``, 3 stages), beside the shipped radix-2
sweep (9 stages) and the copy floor, and a [512, 512] transpose through
64 x 64 shared tiles. ``fwd ring r8`` is ``fwd r8``'s function done the
Hopper way (``probe_stages.cu`` ``ring_chain``, the kernels line's
``probe_stages2`` row), timed beside the shipped register FFT (``fwd
reg``) at [8, 512, 512] and [256, 512, 512]. The kernels are ``csrc/probe_stages.cu``'s, launched
through :func:`chain` (which counts its own launches); the plain versions
are :mod:`.mosaic_stages`' (same stages, same order). The TPU probe's XLA
rows and its full-conv timings with Pallas transposes have no counterpart:
the card's block kernel has no transpose pass.
"""

from __future__ import annotations

import torch

from . import _probe
from . import mosaic_stages as ms

CASES = ("noop", "fwd r2", "fwd r4", "fwd r8", "inv r2", "inv r4", "inv r8",
         "transpose 64", "fwd reg", "fwd ring r8")
LARGE = ("noop", "fwd r8", "fwd reg", "fwd ring r8")

launches = {"probe_stages2_f32": 0, "probe_stages2_f64": 0}


def chain(z: torch.Tensor, name: str) -> torch.Tensor:
    """z [batch, 512, 512] complex -> case ``name`` (one of :data:`CASES`).
    CUDA tensors run the kernel, CPU tensors the plain version."""
    if name not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {name!r}")
    ms._check(z, name)
    if not _probe.on_card(z):
        return ms.reference(z, name)
    out = ms.launch_case(z, name)
    launches[f"probe_stages2_{ms.mode_of(z)}"] += 1
    return out


def verify(device="cuda") -> dict:
    return ms.verify_cases(CASES, chain, device, "probe_stages2",
                           large=("fwd ring r8",))


def run(device="cuda", reps: int = 5) -> dict:
    return ms.run_cases(CASES, chain, device, reps, "probe_stages2",
                        "fwd ring r8", "r2 / r4 / r8 chains", large=LARGE)


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
