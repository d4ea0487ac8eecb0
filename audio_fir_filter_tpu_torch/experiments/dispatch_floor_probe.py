"""The launch floor and the passthrough-by-grid probe on the card.

Counterpart of ``experiments/dispatch_floor_probe.py`` (``make_passthru``,
the ``pallas_call`` at :67). The TPU probe asked whether its copy floor was
per call, per grid step or memory bandwidth. On the card:

- ``pallas_g{N}`` (passthrough of x [N, 2, 512, 512] f32, one grid step per
  block) becomes :func:`passthru`: one launch of ``csrc/probe_floors.cu``
  ``passthru``, 64 CTAs per [2, 512, 512] block, 16-byte accesses, for
  g = 2, 8, 32. Its plain version is ``x.clone()``.
- ``jit_tiny`` (``x[:8] + 1`` on 1024 floats) becomes :func:`empty`, a
  kernel that does nothing: the launch floor. ``torch.add`` on 1024 floats
  and on the g = 8 array (``jit_add``) are calibration rows, not kernels of
  this repository.

Each is timed two ways: host wall over K back-to-back launches with one
synchronize at the end (the per-launch host cost) and CUDA events around
one launch (device time). The gap between the two, and the slope of the
device time in g, separate the per-launch cost from the per-CTA cost from
bandwidth.
"""

from __future__ import annotations

import torch

from ..ops import roofline
from . import _probe

BLOCK = (2, 512, 512)
GRIDS = (2, 8, 32)

# Kernel launches, counted by the wrappers where they launch.
launches = {"probe_passthru": 0, "probe_empty": 0}


def passthru(x: torch.Tensor) -> torch.Tensor:
    """x [g, 2, 512, 512] float32 -> a copy. CUDA tensors run the kernel,
    CPU tensors :func:`reference`."""
    if x.dtype != torch.float32 or x.dim() != 4 or tuple(x.shape[1:]) != BLOCK:
        raise ValueError(f"passthru takes [g, 2, 512, 512] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("passthru input must be contiguous")
    if not _probe.on_card(x):
        return reference(x)
    y = torch.empty_like(x)
    _probe.launch("probe_floors", "lowcut_probe_passthru", x.device,
                  x.data_ptr(), y.data_ptr(), None, x.shape[0], 0, 0, 0)
    launches["probe_passthru"] += 1
    return y


def empty(device) -> None:
    """Launch the empty kernel once on ``device`` (CUDA only)."""
    dev = _probe.card(device)
    _probe.launch("probe_floors", "lowcut_probe_empty", dev,
                  None, None, None, 0, 0, 0, 0)
    launches["probe_empty"] += 1


def reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def _blocks(g: int, dev) -> torch.Tensor:
    i = torch.arange(g * 2 * 512 * 512, device=dev, dtype=torch.float32)
    return (0.3 * torch.sin(0.37 * i)).reshape(g, *BLOCK)


def verify(device="cuda") -> dict:
    """The kernel against its plain version at every grid: bitwise."""
    dev = _probe.card(device)
    err = 0.0
    for g in GRIDS:
        x = _blocks(g, dev)
        err = max(err, _probe.expect(f"passthru g={g}", passthru(x),
                                     reference(x), None))
    empty(dev)
    torch.cuda.synchronize(dev)
    return {"probe_passthru": err}


def run(device="cuda", reps: int = 5, k: int = 200) -> dict:
    """The sweep. Returns the printed ``lines`` and, per kernel row, its
    time and its plain version's (``kernels``)."""
    dev = _probe.card(device)
    rows = []
    tiny = torch.arange(1024, device=dev, dtype=torch.float32)
    calls = [("empty kernel", lambda: empty(dev), 0),
             ("torch.add 1024 floats (calibration)", lambda: tiny[:8] + 1.0, 0)]
    xs = {g: _blocks(g, dev) for g in GRIDS}
    calls.append(("torch.add g=8 (calibration)", lambda: xs[8] + 1.0,
                  2 * xs[8].numel() * 4))
    for g in GRIDS:
        calls.append((f"passthru g={g}", lambda g=g: passthru(xs[g]),
                      2 * xs[g].numel() * 4))
    for name, fn, nbytes in calls:
        host = _probe.host_us_per_call(fn, k)
        ms = _probe.event_ms(fn, reps)
        rows.append([name, host, ms * 1e3,
                     _probe.gbps(nbytes, ms) if nbytes else "-"])
    ms = _probe.event_ms(lambda: passthru(xs[8]), reps)
    plain_ms = _probe.event_ms(lambda: reference(xs[8]), reps)
    lines = _probe.table(
        "launch floor and passthrough (host: wall per launch over "
        f"{k} launches, one sync; device: CUDA events, median of {reps})",
        ["case", "host us/launch", "device us", "GB/s r+w"], rows)
    # The plain version is one library call, x.clone().
    return {"lines": lines,
            "kernels": {"probe_passthru": {
                "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
                **roofline.bound(2 * xs[8].numel() * 4, 0, "f32")}}}


def main() -> None:
    verify()
    print("\n".join(run(reps=10, k=1000)["lines"]))


if __name__ == "__main__":
    main()
