"""Device mesh construction.

Counterpart of ``audio_fir_filter_tpu/parallel/mesh.py``. The JAX mesh is a
grid of devices, each of which may belong to this process or to another.
PyTorch has no such global device object, so a mesh cell here is a
``(rank, torch.device)`` pair: the process of the ``torch.distributed``
group that drives the device, and the device as that process names it. The
two logical axes are the JAX package's:

- ``"data"``: channel parallelism;
- ``"time"``: sequence parallelism over the sample axis with halo exchange.

Every rank builds the same mesh (the same cells in the same order); a rank
works on the cells that carry its own rank. A device may appear in several
cells: ``["cpu"] * 8`` is the counterpart of XLA's eight virtual host
devices, and ``["cuda:0", "cuda:0"]`` puts two cells on one card (they run
one after another on its stream: correct, not parallel).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from .distributed import process_info

DATA_AXIS = "data"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One mesh position: the rank that drives it and its device there."""

    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [D, T] grid of cells over the axes ``("data", "time")``."""

    cells: tuple[tuple[Cell, ...], ...]
    axis_names: tuple[str, str] = (DATA_AXIS, TIME_AXIS)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.cells), len(self.cells[0])

    def ranks(self) -> set[int]:
        return {cell.rank for row in self.cells for cell in row}

    def is_local(self, rank: int) -> bool:
        """Whether every cell belongs to ``rank``."""
        return self.ranks() == {rank}


def _indexed(device) -> torch.device:
    """``device`` checked by :func:`resolve_device`, a CUDA device with its
    index spelled out (tensors report their device that way)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device, count: int) -> list[torch.device]:
    """This process's devices for a mesh of ``count`` cells on ``device``:
    every visible card for ``"cuda"`` (never the CPU in their place), and
    ``count`` CPU cells for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * count


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """Build a ("data", "time") mesh.

    ``devices`` lists the cells in row-major order; an entry is a device
    (a cell of this process) or a ``(rank, device)`` pair. By default the
    cells are every rank's visible cards in rank order (``cuda:0 ..
    cuda:n-1`` of rank 0, then of rank 1, ...), each rank taken to see as
    many cards as this one. ``shape=None`` puts all cells on the time axis
    (the dominant need for single large files). A shape of more cells than
    devices raises ValueError.
    """
    rank, world = process_info()
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [(r, torch.device("cuda", i))
                   for r in range(world) for i in range(n)]
    cells = []
    for entry in devices:
        r, dev = entry if isinstance(entry, tuple) else (rank, entry)
        if not 0 <= r < world:
            raise ValueError(f"mesh cell on rank {r} of a group of {world}")
        # Another rank's device is named, not opened, here.
        cells.append(Cell(r, _indexed(dev) if r == rank else torch.device(dev)))
    if shape is None:
        shape = (1, len(cells))
    d, t = shape
    if d < 1 or t < 1:
        raise ValueError(f"mesh shape {shape} must be at least (1, 1)")
    if d * t > len(cells):
        raise ValueError(f"mesh shape {shape} needs {d * t} devices, "
                         f"have {len(cells)}")
    return Mesh(tuple(tuple(cells[i * t : (i + 1) * t]) for i in range(d)))


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh((1, 1), [device])
