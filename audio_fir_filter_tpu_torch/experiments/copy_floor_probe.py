"""The copy floor of the block kernel's own data movement on the card.

Counterpart of ``experiments/copy_floor_probe.py`` (``make_variant``, the
``pallas_call`` at :134): the fused kernel's data movement with no
arithmetic, per chunk of 16 real blocks at B = 2^18. Here
``csrc/probe_floors.cu`` moves x [8, 2, 512, 512] f32 (pairs of real blocks,
as ``conv_blocks`` packs them) through the block kernel's [pairs, B]
complex64 scratch and back; every variant computes the identity, and its
plain version is ``x.clone()``. The TPU variants map to the card so:

- ``passthru``: global -> global, no scratch;
- ``1buf``: pass 1's gather into a shared tile and column-strided scratch
  store, pass 3's strided load and scatter; no pass 2;
- ``copy``: passes 1 and 3 storing and loading each tile as one contiguous
  run, plus pass 2's row round trip through shared memory
  (``rows_multiply`` with no arithmetic);
- ``tr``: ``copy`` with the column-strided scratch access of the shipped
  passes, the card's counterpart of the plane transpose;
- ``notiles``: one element per thread, no shared-memory tile, no pass 2;
- ``hint``: ``copy`` with 16-byte vector loads and stores in passes 1
  and 3;
- ``lt256``, ``lt512``: ``copy`` at tc = 32 and tc = 8 columns per tile
  (the shipped tc is 16; tc = 64 would need 256 KB of shared memory).

GB/s counts each variant's device-memory traffic: x and y once each, the
scratch written and read once, and twice more with pass 2.
"""

from __future__ import annotations

import torch

from ..ops import roofline
from . import _probe

SHAPE = (2, 512, 512)
PAIRS = 8
VARIANTS = ("passthru", "1buf", "copy", "tr", "notiles", "hint", "lt256",
            "lt512")
_ID = {v: i for i, v in enumerate(VARIANTS)}
# Device-memory passes over the data (x's size) per variant.
_PASSES = {"passthru": 2, "1buf": 4, "notiles": 4}

launches = {"probe_copy_floor": 0}


def copy_floor(x: torch.Tensor, variant: str) -> torch.Tensor:
    """x [pairs, 2, 512, 512] float32 -> its copy through ``variant``'s data
    movement. CUDA tensors run the kernel, CPU tensors :func:`reference`."""
    if variant not in _ID:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if (x.dtype != torch.float32 or x.dim() != 4 or tuple(x.shape[1:]) != SHAPE
            or not x.is_contiguous()):
        raise ValueError(f"copy_floor takes contiguous [pairs, 2, 512, 512] "
                         f"float32, got {tuple(x.shape)} {x.dtype}")
    if not _probe.on_card(x):
        return reference(x)
    pairs = x.shape[0]
    y = torch.empty_like(x)
    scratch = torch.empty((pairs, 512 * 512), dtype=torch.complex64,
                          device=x.device)
    _probe.launch("probe_floors", "lowcut_probe_copy_floor", x.device,
                  x.data_ptr(), y.data_ptr(), scratch.data_ptr(), pairs, 0, 0,
                  _ID[variant])
    launches["probe_copy_floor"] += 1
    return y


def reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def moved_bytes(variant: str, x: torch.Tensor) -> int:
    return _PASSES.get(variant, 6) * x.numel() * 4


def _input(dev) -> torch.Tensor:
    i = torch.arange(PAIRS * 2 * 512 * 512, device=dev, dtype=torch.float32)
    return (0.3 * torch.sin(0.37 * i)).reshape(PAIRS, *SHAPE)


def verify(device="cuda") -> dict:
    """Every variant against ``x.clone()``: bitwise."""
    dev = _probe.card(device)
    x = _input(dev)
    for v in VARIANTS:
        _probe.expect(f"copy_floor {v}", copy_floor(x, v), reference(x), None)
    torch.cuda.synchronize(dev)
    return {"probe_copy_floor": 0.0}


def run(device="cuda", reps: int = 5) -> dict:
    dev = _probe.card(device)
    x = _input(dev)
    rows, times = [], {}
    for v in VARIANTS:
        ms = _probe.event_ms(lambda: copy_floor(x, v), reps)
        times[v] = ms
        rows.append([v, ms, _probe.gbps(moved_bytes(v, x), ms),
                     2 * PAIRS * x[0, 0].numel() / (ms * 1e-3) / 1e9])
    plain_ms = _probe.event_ms(lambda: reference(x), reps)
    lines = _probe.table(
        f"copy floor, x [{PAIRS}, 2, 512, 512] f32 (16 real blocks at B = "
        f"2^18) through the [pairs, B] complex64 scratch (CUDA events, median "
        f"of {reps}); plain x.clone(): {plain_ms:.4f} ms",
        ["variant", "ms", "GB/s moved", "Gsamples/s"], rows)
    return {"lines": lines, "times": times,
            # The plain version is one library call, x.clone().
            "kernels": {"probe_copy_floor": {
                "ms": times["tr"], "plain_ms": plain_ms, "library_ms": plain_ms,
                **roofline.bound(2 * x.numel() * 4, 0, "f32")}}}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
