"""The port's explicit device choice.

Every public entry point takes a ``device``. ``"cuda"`` means the card and
nothing else: with no card it raises, it never falls back to the CPU. The
CPU runs only when ``"cpu"`` is asked for (tests, machines without a card).
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N", "cpu" or a device),
    exactly as asked. Raises RuntimeError for CUDA without a usable card
    and ValueError for any other device type."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but no CUDA card is available "
            "(torch.cuda.is_available() is False); use --device cpu / "
            "device='cpu' to run on the CPU.")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {dev.index} requested but only "
            f"{torch.cuda.device_count()} card(s) are visible.")
    return dev
