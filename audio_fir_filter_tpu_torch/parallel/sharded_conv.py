"""Sequence-parallel overlap-save convolution over a mesh of cells.

Counterpart of ``audio_fir_filter_tpu/parallel/sharded_conv.py``. The time
axis of every channel is sharded across the mesh's ``"time"`` axis and the
channels across its ``"data"`` axis; each cell filters its local shard
after it has received kernel-length halos from its neighbours.

Why this is exact: cell j owns the output range [j*S, (j+1)*S) and out[i]
needs x[i - Mo2 .. i + Mo2]. The left neighbour sends its last Mo2 samples,
the right neighbour its first Mo2; a cell at a mesh edge gets zeros, which
is the zero padding at the true signal edges, or the caller's edge halos
(a host segment loop chains its segments with them).

PyTorch has no ``shard_map``: a process loops over the cells that carry its
rank. There is one code path with two branches at a shard boundary:

- between two cells of one process a halo is a slice copied with ``.to``
  (a peer copy between two cards, a view on one device);
- between processes it is ``torch.distributed.batch_isend_irecv``: device
  tensors under NCCL, host tensors under gloo. A CUDA halo under a gloo
  group is staged through pinned host memory (gloo has no point-to-point
  on CUDA tensors in every build); the group's backend decides, not a
  failed attempt.

The local filter is the port's ``extended_filter_peak``, so both engines
(the segment kernel and the block path) run under a mesh, a CUDA shard
launches its kernel or raises, and a cell's peak covers only its own
samples. The global peak is the maximum over this process's cells, then
``all_reduce(MAX)`` when the mesh spans processes.

The peak, and so the normalize decision, covers only the real region: a
caller that padded [C, N] to the mesh passes ``valid=(C, N)``; samples
outside it are not computed and come back zero. (The JAX package takes its
peak over the padded output, ring of the true tail included.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import overlap_save as osv
from .distributed import process_info
from .mesh import Mesh


@dataclasses.dataclass
class LocalShards:
    """What one process holds of a [C, N] result on a mesh that spans
    processes: its own cells' outputs by mesh position, each cut to the
    valid region. :func:`assemble` joins them on one rank."""

    shape: tuple[int, int]
    valid: tuple[int, int]
    parts: dict[tuple[int, int], torch.Tensor]


def _block(mesh: Mesh, shape, valid, i: int, j: int):
    """(first row, rows, first column, columns) of cell (i, j)'s valid part."""
    d, t = mesh.shape
    cd, s = shape[0] // d, shape[1] // t
    rows = min(max(valid[0] - i * cd, 0), cd)
    cols = min(max(valid[1] - j * s, 0), s)
    return i * cd, rows, j * s, cols


def _wire(x: torch.Tensor, backend: str) -> torch.Tensor:
    """``x`` as the group's backend sends it: contiguous, and under gloo on
    the host (a CUDA tensor staged through pinned memory)."""
    if backend == "nccl":
        if not x.is_cuda:
            raise RuntimeError("an NCCL group exchanges CUDA tensors; a mesh "
                               "with CPU cells needs a gloo group")
        return x.contiguous()
    if x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x)
    return x.contiguous()


def _wire_buffer(shape, device: torch.device, backend: str) -> torch.Tensor:
    """A receive buffer for a halo bound for ``device``."""
    if backend == "nccl":
        if device.type != "cuda":
            raise RuntimeError("an NCCL group exchanges CUDA tensors; a mesh "
                               "with CPU cells needs a gloo group")
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.empty(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")


def _halo_exchange(shards: dict, mo2: int, mesh: Mesh,
                   edge_left=None, edge_right=None) -> dict:
    """{(i, j): [Cd, S]} -> {(i, j): [Cd, S + 2*Mo2]} for this process's
    cells: every shard's tail goes to its right neighbour and its head to
    its left neighbour.

    Mesh-edge shards receive their rows of ``edge_left`` / ``edge_right``
    ([C, Mo2]) when given, else zeros. With one time shard or Mo2 == 0
    nothing is communicated. All sends and receives of this process, both
    directions, are posted in one batch, in the mesh's order on every rank,
    so two neighbours never wait on each other.
    """
    rank, _ = process_info()
    d, t = mesh.shape
    halos = {}      # (i, j, side) -> [Cd, Mo2] on the cell's device
    ops, landed = [], []
    backend = None

    def passes(src, dst, piece, key, tag):
        nonlocal backend
        a, b = mesh.cells[src[0]][src[1]], mesh.cells[dst[0]][dst[1]]
        if a.rank != rank and b.rank != rank:
            return
        if a.rank == b.rank:
            halos[key] = piece(shards[src]).to(b.device)
            return
        backend = backend or dist.get_backend()
        if a.rank == rank:
            ops.append(dist.P2POp(dist.isend, _wire(piece(shards[src]), backend),
                                  b.rank, tag=tag))
        else:
            cd = shards[dst].shape[0]
            buf = _wire_buffer((cd, mo2), b.device, backend)
            ops.append(dist.P2POp(dist.irecv, buf, a.rank, tag=tag))
            landed.append((key, buf, b.device))

    if mo2 > 0:
        for i in range(d):
            for j in range(t - 1):
                tag = 2 * (i * t + j)
                passes((i, j), (i, j + 1), lambda x: x[:, x.shape[1] - mo2:],
                       (i, j + 1, "left"), tag)
                passes((i, j + 1), (i, j), lambda x: x[:, :mo2],
                       (i, j, "right"), tag + 1)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for key, buf, device in landed:
            halos[key] = buf.to(device)

    out = {}
    for (i, j), x in shards.items():
        cd = x.shape[0]

        def edge(e):
            if e is None:
                return x.new_zeros((cd, mo2))
            e = torch.as_tensor(e, dtype=torch.float32)[i * cd : (i + 1) * cd]
            return e.to(x.device)

        left = halos.get((i, j, "left"))
        right = halos.get((i, j, "right"))
        out[(i, j)] = torch.cat([edge(edge_left) if left is None else left, x,
                                 edge(edge_right) if right is None else right],
                                dim=1)
    return out


def _global_peak(peaks, mesh: Mesh, rank: int) -> float:
    """Max over this process's cells, then over the processes when the mesh
    spans them (every process of the group takes part)."""
    peak = max((float(p) for p in peaks), default=0.0)
    if mesh.is_local(rank):
        return peak
    device = "cpu"
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    top = torch.tensor(peak, dtype=torch.float32, device=device)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return float(top)


def sharded_filter(x, plan: osv.OverlapSavePlan, mesh: Mesh,
                   normalize: bool = False, edge_left=None, edge_right=None,
                   auto_scale: bool = True, valid=None):
    """Filter [C, N] float32 across the mesh; returns ``(y, peak)``.

    C must be divisible by the "data" axis size and N by the "time" axis
    size; use :func:`pad_for_mesh` / :func:`sharded_filter_padded` for
    arbitrary shapes. ``x`` is the whole signal on every process (an array
    or a tensor on any device); a process reads only its own cells' slices
    of it. The peak returned is the pre-scale global maximum over the
    ``valid`` region (default: all of [C, N]), as a float.

    ``y`` is the whole [C, N] tensor, on the device of cell (0, 0), when
    every cell is this process's; on a mesh that spans processes it is this
    process's :class:`LocalShards` (see :func:`assemble`).

    With ``auto_scale`` (the default) the output is scaled by one common
    1/peak when the peak exceeds 1.0 or ``normalize`` is set; without it
    the output is unscaled and the caller owns the one global decision (a
    per-segment scale would break the single common factor).

    ``edge_left`` / ``edge_right`` ([C, Mo2] float32) replace the zero
    padding at the mesh edges; leave None for true signal edges.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.dim() != 2:
        raise ValueError("sharded_filter expects [C, N]")
    d, t = mesh.shape
    c, n = x.shape
    if c % d or n % t:
        raise ValueError(
            f"shape {tuple(x.shape)} not divisible by mesh {mesh.shape}; "
            "pad first (see pad_for_mesh)")
    if t > 1 and n // t < plan.mo2:
        # Halos come from direct neighbours only; a shard shorter than Mo2
        # cannot supply its neighbour's full kernel span.
        raise ValueError(
            f"time shard length {n // t} is shorter than the half-kernel "
            f"Mo2={plan.mo2}; use fewer time shards for this signal")
    valid = (c, n) if valid is None else (min(valid[0], c), min(valid[1], n))
    rank, _ = process_info()
    cd, s = c // d, n // t
    mine = [(i, j) for i in range(d) for j in range(t)
            if mesh.cells[i][j].rank == rank]
    shards = {(i, j): x[i * cd : (i + 1) * cd, j * s : (j + 1) * s]
              .to(mesh.cells[i][j].device) for i, j in mine}
    parts, peaks = _filter_cells(shards, plan, mesh, (c, n), edge_left,
                                 edge_right, valid)
    peak = _global_peak(peaks, mesh, rank)

    # The reference rule: scale iff clip or -n, never by a zero peak.
    if auto_scale and (peak > 1.0 or normalize) and peak > 0.0:
        for y in parts.values():
            y.mul_(1.0 / peak)

    if not mesh.is_local(rank):
        return LocalShards((c, n), valid, parts), peak
    return _join(parts, mesh, (c, n), valid), peak


def _filter_cells(shards: dict, plan: osv.OverlapSavePlan, mesh: Mesh,
                  shape, edge_left, edge_right, valid):
    """The per-cell work of :func:`sharded_filter` on a [C, N] = ``shape``
    signal: ``shards`` holds this process's cells' [C/D, N/T] slices (on
    their devices, or on their way there). Halo exchange, then one filter
    call a cell over its part of the ``valid`` region. Returns ``(parts,
    peaks)``: {(i, j): y} and the cells' 0-d peaks, left on their devices
    (reading one is the caller's choice of when to wait for the card)."""
    extended = _halo_exchange(shards, plan.mo2, mesh, edge_left, edge_right)
    parts, peaks = {}, []
    for i, j in shards:
        _, rows, _, cols = _block(mesh, shape, valid, i, j)
        if rows == 0 or cols == 0:
            continue
        device = mesh.cells[i][j].device
        y, p = osv.extended_filter_peak(extended[(i, j)][:rows].contiguous(),
                                        osv.plan_for_device(plan, device), cols)
        parts[(i, j)] = y
        peaks.append(p)
    return parts, peaks


def _join(parts: dict, mesh: Mesh, shape, valid) -> torch.Tensor:
    """The whole [C, N] = ``shape`` tensor of a local mesh's ``parts`` on
    the device of cell (0, 0), zero outside the ``valid`` region."""
    whole = torch.empty if valid == shape else torch.zeros
    out = whole(shape, dtype=torch.float32, device=mesh.cells[0][0].device)
    for (i, j), y in parts.items():
        r0, rows, s0, cols = _block(mesh, shape, valid, i, j)
        out[r0 : r0 + rows, s0 : s0 + cols] = y
    return out


def assemble(y: LocalShards, mesh: Mesh, dst: int = 0) -> np.ndarray | None:
    """The whole [C, N] result on the host of rank ``dst`` (zeros outside
    the valid region); None on the other ranks. Every process of the mesh
    calls it. Shards travel one at a time, in the mesh's order."""
    rank, _ = process_info()
    backend = dist.get_backend()
    out = np.zeros(y.shape, np.float32) if rank == dst else None
    d, t = mesh.shape
    for i in range(d):
        for j in range(t):
            cell = mesh.cells[i][j]
            r0, rows, s0, cols = _block(mesh, y.shape, y.valid, i, j)
            if rows == 0 or cols == 0 or rank not in (dst, cell.rank):
                continue
            if cell.rank == dst:
                part = y.parts[(i, j)].cpu()
            elif rank == dst:
                device = (torch.device("cuda", torch.cuda.current_device())
                          if backend == "nccl" else torch.device("cpu"))
                buf = _wire_buffer((rows, cols), device, backend)
                dist.recv(buf, src=cell.rank)
                part = buf.cpu()
            else:
                dist.send(_wire(y.parts[(i, j)], backend), dst=dst)
                continue
            out[r0 : r0 + rows, s0 : s0 + cols] = part.numpy()
    return out


def pad_for_mesh(x, mesh: Mesh):
    """Zero-pad [C, N] so both axes divide the mesh; returns (xp, (C, N)).

    Zero padding is semantically safe: trailing zeros only influence the
    last Mo2 outputs of the padded region, which are sliced away, and a
    zero tail is exactly the zero padding at the signal's end.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    d, t = mesh.shape
    c, n = x.shape
    cp = -(-c // d) * d
    np_ = -(-n // t) * t
    if cp == c and np_ == n:
        return x, (c, n)
    return F.pad(x, (0, np_ - n, 0, cp - c)), (c, n)


def sharded_filter_padded(x, plan, mesh: Mesh, normalize: bool = False):
    """:func:`sharded_filter` for arbitrary [C, N]: pad, filter, slice back.

    The peak, and the normalize decision with it, covers the real region
    only (``valid``), as on the unsharded path. Needs a mesh of this
    process's cells (the result is sliced as one tensor).
    """
    xp, (c, n) = pad_for_mesh(x, mesh)
    y, peak = sharded_filter(xp, plan, mesh, normalize=normalize, valid=(c, n))
    if isinstance(y, LocalShards):
        raise ValueError("sharded_filter_padded needs a mesh of this "
                         "process's cells; use sharded_filter with valid= "
                         "and assemble on a mesh that spans processes")
    return y[:c, :n], peak
