"""Bandwidth of staged global <-> shared copies on the card.

Counterpart of ``experiments/dma_bw_micro.py`` (``bw_kernel``, the
``pallas_call`` at :123, and at :105 for mode ``none``): on the TPU, a grid
of steps each DMAing a [rows, 512] f32 chunk HBM -> VMEM and back,
double-buffered, with the chunk split into ``split`` DMAs. On the card,
``csrc/probe_floors.cu`` ``bw`` uses the card's copy engine: TMA bulk
copies (``cp.async.bulk``) through a ring of ``STAGES`` 32 KB stages of
shared memory, each completing on its own ``mbarrier``, issued by one
thread per CTA; a persistent grid of as many CTAs as are resident (one per
SM) walks the 32 KB tiles (16 rows) of x [steps, rows, 512] (128 steps,
rows 512, 1024 or 2048). ``split`` (1 or 4) is the number of bulk copies a
stage is issued as (the counterpart of the DMA chunking). Modes and their
defined outputs (so no traffic can be dropped):

- ``both``: global -> shared -> global, y = x (plain: ``x.clone()``);
- ``in``: global -> shared only, the per-step sum in float64 (plain:
  ``x.sum(dim=(1, 2))`` in float64, compared at float32 tolerance);
- ``out``: shared -> global only, y[s, r, c] = s * 8192 + (r % 16) * 512 + c,
  written by the threads into each stage;
- ``none``: no traffic, y = ones [steps, 8, 512] (the grid floor).

:func:`bw_ring` runs ``both`` at other ring depths and CTA counts: the
sweep behind the ring's design. GB/s counts the bytes each mode moves
through device memory; every one of these shapes is larger than the L2,
so a reading above 3.35 TB/s fails the run (the compiler dropped work).
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
STAGES = 4                   # the ring's depth (csrc kBwStages)
STRIDED = True               # its walk over the tiles (csrc kBwStrided)
# lowcut_probe_bw_ring's variants, by id: (stages, strided walk).
RINGS = ((2, True), (4, True), (6, True), (4, False))
RING_CTAS = (64, 128, 0)     # the sweep's grids; 0: as many as are resident

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
    aux = None
    if mode == "in":
        # The sums, then one float64 partial a tile (summed in tile order).
        aux = torch.empty(steps * (1 + rows // TILE_ROWS), dtype=torch.float64,
                          device=x.device)
        y = aux[:steps]
    elif mode == "none":
        y = torch.empty((steps, 8, COLS), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty_like(x)
    _probe.launch("probe_floors", "lowcut_probe_bw", x.device,
                  x.data_ptr(), None if mode == "in" else y.data_ptr(),
                  _probe.ptr(aux), steps, rows, split, _MODE_ID[mode])
    launches["probe_bw"] += 1
    return y


def bw_ring(x: torch.Tensor, stages: int, strided: bool,
            ctas: int = 0) -> torch.Tensor:
    """``both`` at split 1 through a ring of ``stages`` stages, walking the
    tiles strided (CTA c: tiles c, c + G, ...) or in one contiguous run a
    CTA, on ``ctas`` CTAs (0: as many as are resident). CPU tensors:
    ``x.clone()``."""
    _check(x, "both", 1)
    if (stages, strided) not in RINGS:
        raise ValueError(f"(stages, strided) must be one of {RINGS}, got "
                         f"{(stages, strided)}")
    if ctas < 0:
        raise ValueError(f"ctas must be >= 0 (0: resident), got {ctas}")
    if not _probe.on_card(x):
        return reference(x, "both")
    y = torch.empty_like(x)
    _probe.launch("probe_floors", "lowcut_probe_bw_ring", x.device,
                  x.data_ptr(), y.data_ptr(), None, x.shape[0], x.shape[1],
                  ctas, RINGS.index((stages, strided)))
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
    """Every mode and split at every row count against the plain version:
    bitwise for both/out/none, the float32 tolerance for in; the ring
    sweep's configurations bitwise at rows 512."""
    dev = _probe.card(device)
    err = 0.0
    for rows in ROWS:
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
        if rows == ROWS[0]:
            for ring in RINGS:
                for ctas in RING_CTAS:
                    _probe.expect(f"bw ring {ring} ctas={ctas}",
                                  bw_ring(x, *ring, ctas), x, None)
    torch.cuda.synchronize(dev)
    return {"probe_bw": err}


def _rate(what: str, nbytes: int, ms: float) -> list:
    """[GB/s, share of 3.35 TB/s] of ``nbytes`` in ``ms``; raises above
    3.35 TB/s (no shape here fits the L2, so a faster reading means work
    was dropped)."""
    share = nbytes / roofline.HBM_BYTES_PER_S / (ms * 1e-3)
    if share > 1:
        raise RuntimeError(f"{what}: {nbytes} B in {ms:.4f} ms, above 3.35 TB/s")
    return [_probe.gbps(nbytes, ms), f"{share:.1%}"]


def run(device="cuda", reps: int = 5) -> dict:
    dev = _probe.card(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    xs = {rows: _input(rows, dev) for rows in ROWS}
    clone = {rows: _probe.event_ms(lambda: reference(xs[rows], "both"), reps)
             for rows in ROWS}
    rows_out = []
    for mode in MODES:
        for rows in ((512,) if mode == "none" else ROWS):
            for split in ((1,) if mode == "none" else SPLITS):
                ms = _probe.event_ms(lambda: bw(xs[rows], mode, split), reps)
                nb = moved_bytes(mode, STEPS, rows)
                rows_out.append([mode, rows, split, ms,
                                 *(_rate(f"bw {mode} rows={rows}", nb, ms)
                                   if nb else ["-", "-"]),
                                 clone[rows] if mode == "both" else "-"])
    lines = _probe.table(
        f"staged copies (TMA ring of {STAGES} x 32 KB, one CTA on each of "
        f"{sms} SMs), {STEPS} steps x rows x {COLS} f32 (CUDA events, median "
        f"of {reps}); share: of the mode's bytes at 3.35 TB/s",
        ["mode", "rows", "split", "ms", "GB/s", "share", "x.clone() ms"],
        rows_out)
    x = xs[2048]
    nb = moved_bytes("both", STEPS, 2048)
    sweep = []
    for stages, strided in RINGS:
        for ctas in RING_CTAS:
            ms = _probe.event_ms(lambda: bw_ring(x, stages, strided, ctas), reps)
            sweep.append([stages, "strided" if strided else "contiguous",
                          ctas or f"{sms} (resident)", ms,
                          *_rate(f"bw ring {stages}/{ctas}", nb, ms)])
    lines += _probe.table(
        f"ring sweep, `both` at rows 2048, split 1 (x.clone(): "
        f"{clone[2048]:.4f} ms)", ["stages", "walk", "CTAs", "ms", "GB/s", "share"],
        sweep)
    ms = _probe.event_ms(lambda: bw(x, "both", 4), reps)
    # The plain version is one library call, x.clone().
    return {"lines": lines,
            "kernels": {"probe_bw": {
                "ms": ms, "plain_ms": clone[2048], "library_ms": clone[2048],
                **roofline.bound(moved_bytes("both", STEPS, 2048), 0, "f32")}}}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
