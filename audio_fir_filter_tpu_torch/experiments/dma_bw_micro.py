"""Bandwidth of staged global <-> shared copies on the card.

Counterpart of ``experiments/dma_bw_micro.py`` (``bw_kernel``, the
``pallas_call`` at :123, and at :105 for mode ``none``): on the TPU, a grid
of steps each DMAing a [rows, 512] f32 chunk HBM -> VMEM and back,
double-buffered, with the chunk split into ``split`` DMAs. On the card,
``csrc/probe_floors.cu`` ``bw`` runs one CTA per step of x [steps, rows,
512] (128 steps, rows 512, 1024 or 2048); each step streams its rows
through two 32 KB shared-memory stages with ``cp.async``, ``split`` (1 or
4) commit groups per stage (the counterpart of the DMA chunking). Modes and
their defined outputs (so no traffic can be dropped):

- ``both``: global -> shared -> global, y = x (plain: ``x.clone()``);
- ``in``: global -> shared only, the per-step sum in float64 (plain:
  ``x.sum(dim=(1, 2))`` in float64, compared at float32 tolerance);
- ``out``: shared -> global only, y[s, r, c] = s * 8192 + (r % 16) * 512 + c
  from a pattern written once to shared memory;
- ``none``: no traffic, y = ones [steps, 8, 512] (the grid floor).

GB/s counts the bytes each mode moves through device memory.
"""

from __future__ import annotations

import torch

from ..ops import roofline
from . import _probe

COLS = 512
STEPS = 128
ROWS = (512, 1024, 2048)
SPLITS = (1, 4)
MODES = ("none", "in", "out", "both")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
TILE_ROWS = 16

launches = {"probe_bw": 0}


def _check(x: torch.Tensor, mode: str, split: int) -> None:
    if mode not in _MODE_ID:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split}")
    if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != COLS
            or x.shape[1] % TILE_ROWS or not x.is_contiguous()):
        raise ValueError(f"bw takes contiguous [steps, rows (a multiple of "
                         f"{TILE_ROWS}), {COLS}] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def bw(x: torch.Tensor, mode: str, split: int = 1) -> torch.Tensor:
    """Run one mode over x; returns the mode's output (see the module
    docstring). CUDA tensors run the kernel, CPU tensors :func:`reference`."""
    _check(x, mode, split)
    if not _probe.on_card(x):
        return reference(x, mode)
    steps, rows, _ = x.shape
    sums = None
    if mode == "in":
        y = sums = torch.empty(steps, dtype=torch.float64, device=x.device)
    elif mode == "none":
        y = torch.empty((steps, 8, COLS), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty_like(x)
    _probe.launch("probe_floors", "lowcut_probe_bw", x.device,
                  x.data_ptr(), None if mode == "in" else y.data_ptr(),
                  _probe.ptr(sums), steps, rows, split, _MODE_ID[mode])
    launches["probe_bw"] += 1
    return y


def pattern(steps: int, rows: int, device) -> torch.Tensor:
    """The ``out`` mode's output: s * 8192 + (r % 16) * 512 + c."""
    tile = torch.arange(TILE_ROWS * COLS, dtype=torch.float32, device=device)
    tile = tile.reshape(TILE_ROWS, COLS).repeat(rows // TILE_ROWS, 1)
    step = torch.arange(steps, dtype=torch.float32, device=device)
    return tile[None] + (step * (TILE_ROWS * COLS))[:, None, None]


def reference(x: torch.Tensor, mode: str) -> torch.Tensor:
    steps, rows, _ = x.shape
    if mode == "both":
        return x.clone()
    if mode == "in":
        return x.to(torch.float64).sum(dim=(1, 2))
    if mode == "out":
        return pattern(steps, rows, x.device)
    return torch.ones((steps, 8, COLS), dtype=torch.float32, device=x.device)


def moved_bytes(mode: str, steps: int, rows: int) -> int:
    one = steps * rows * COLS * 4
    return {"none": 0, "in": one, "out": one, "both": 2 * one}[mode]


def _input(rows: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(rows)
    return torch.rand((STEPS, rows, COLS), generator=g, device=dev) - 0.5


def verify(device="cuda") -> dict:
    """Every mode and split at rows 512 and 2048 against the plain
    version: bitwise for both/out/none, the float32 tolerance for in."""
    dev = _probe.card(device)
    err = 0.0
    for rows in (512, 2048):
        x = _input(rows, dev)
        for mode in MODES:
            for split in SPLITS:
                got, want = bw(x, mode, split), reference(x, mode)
                if mode == "in":
                    # Sums of |x| <= 0.5 values: scale by the sum of |x|.
                    scale = float(x.abs().sum(dim=(1, 2)).max())
                    e = float((got - want).abs().max())
                    if not e <= _probe.REL_F32 * scale:
                        raise RuntimeError(f"bw in rows={rows} split={split}:"
                                           f" {e:.3e} > {_probe.REL_F32} * "
                                           f"{scale:.3e}")
                else:
                    e = _probe.expect(f"bw {mode} rows={rows} split={split}",
                                      got, want, None)
                err = max(err, e)
    torch.cuda.synchronize(dev)
    return {"probe_bw": err}


def run(device="cuda", reps: int = 5) -> dict:
    dev = _probe.card(device)
    rows_out = []
    xs = {rows: _input(rows, dev) for rows in ROWS}
    for mode in MODES:
        for rows in ((512,) if mode == "none" else ROWS):
            for split in ((1,) if mode == "none" else SPLITS):
                ms = _probe.event_ms(lambda: bw(xs[rows], mode, split), reps)
                nb = moved_bytes(mode, STEPS, rows)
                rows_out.append([mode, rows, split, ms,
                                 _probe.gbps(nb, ms) if nb else "-"])
    x = xs[2048]
    ms = _probe.event_ms(lambda: bw(x, "both", 4), reps)
    plain_ms = _probe.event_ms(lambda: reference(x, "both"), reps)
    lines = _probe.table(
        f"staged copies, {STEPS} steps x rows x {COLS} f32 (CUDA events, "
        f"median of {reps}); plain x.clone() at rows 2048: {plain_ms:.4f} ms",
        ["mode", "rows", "split", "ms", "GB/s"], rows_out)
    # The plain version is one library call, x.clone().
    return {"lines": lines,
            "kernels": {"probe_bw": {
                "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
                **roofline.bound(moved_bytes("both", STEPS, 2048), 0, "f32")}}}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
