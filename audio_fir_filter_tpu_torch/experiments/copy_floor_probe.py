"""The copy floor of the block kernel's own data movement on the card.

Counterpart of ``experiments/copy_floor_probe.py`` (``make_variant``, the
``pallas_call`` at :134): the fused kernel's data movement with no
arithmetic, per chunk of 16 real blocks at B = 2^18. Here
``csrc/probe_floors.cu`` moves x [pairs, 2, 512, 512] f32 (pairs of real
blocks, as ``conv_blocks`` packs them) at two shapes, the TPU probe's 8
pairs and the bench headline's 1008; every variant computes the identity,
and its plain version is ``x.clone()``. The TPU variants map to the card
so:

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
  (the shipped tc is 16; tc = 64 would need 256 KB of shared memory);
- ``cluster``: the TPU probe's own design (its blocks and scratches in
  VMEM), with no device-memory scratch: one thread-block cluster of 8
  CTAs holds one [512, 512] plane in shared memory (64 rows a CTA, loaded
  and stored by TMA bulk copies), and both transposes are all-to-alls
  through distributed shared memory;
- ``cluster16``: the same with a non-portable cluster of 16 CTAs of 32
  rows (64 KB), so two CTAs of different planes share an SM.

The scratch variants measure the shipped layout's data movement;
``cluster`` what on-chip residency costs. GB/s counts each variant's
device-memory traffic: x and y once each, the scratch written and read
once, and twice more with pass 2. At 1008 pairs nothing fits the 50 MB L2,
so a variant above 3.35 TB/s of its own traffic fails the run.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import roofline
from . import _probe

SHAPE = (2, 512, 512)
PAIRS = (8, 1008)
VARIANTS = ("passthru", "1buf", "copy", "tr", "notiles", "hint", "lt256",
            "lt512", "cluster", "cluster16")
_ID = {v: i for i, v in enumerate(VARIANTS)}
# Device-memory passes over the data (x's size) per variant.
_PASSES = {"passthru": 2, "1buf": 4, "notiles": 4, "cluster": 2,
           "cluster16": 2}
# The cluster variants' layouts (csrc Plane<kC>): CTAs per plane -> threads
# per CTA; a CTA's shared memory is its slab and an mbarrier.
CLUSTERS = {"cluster": 8, "cluster16": 16}
CLUSTER_THREADS = {8: 1024, 16: 512}


launches = {"probe_copy_floor": 0}


def cluster_smem(ctas: int) -> int:
    """Shared-memory bytes of a cluster variant's CTA: its slab, an mbarrier."""
    return 512 * 512 * 4 // ctas + 16


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
    scratch = None if variant in CLUSTERS else torch.empty(
        (pairs, 512 * 512), dtype=torch.complex64, device=x.device)
    _probe.launch("probe_floors", "lowcut_probe_copy_floor", x.device,
                  x.data_ptr(), y.data_ptr(), _probe.ptr(scratch), pairs, 0, 0,
                  _ID[variant])
    launches["probe_copy_floor"] += 1
    return y


def cluster_occupancy(device="cuda") -> dict:
    """``cudaOccupancyMaxActiveClusters`` of the two cluster variants:
    ``cluster`` (8 CTAs of 1024 threads and 128 KB, one a SM) and
    ``cluster16`` (16 CTAs of 512 threads and 64 KB, two a SM), with the
    CTAs each keeps resident."""
    from ..ops import _build

    dev = _probe.card(device)
    out = (ctypes.c_int * 2)()
    fn = _build.library("probe_floors").lowcut_probe_cluster_occupancy
    with torch.cuda.device(dev):
        rc = fn(None, ctypes.addressof(out), None, 0, 0, 0, 0, None)
    if rc != 0:
        raise RuntimeError(f"lowcut_probe_cluster_occupancy failed: CUDA error {rc}")
    return {"cluster": out[0], "cluster16": out[1],
            "ctas_cluster": 8 * out[0], "ctas_cluster16": 16 * out[1]}


def occupancy_line(occ: dict) -> str:
    return ("cluster occupancy (cudaOccupancyMaxActiveClusters): "
            + ", ".join(f"{v} {occ[v]} clusters of {c} CTAs ({occ['ctas_' + v]} "
                        f"CTAs of {cluster_smem(c)} B resident)"
                        for v, c in CLUSTERS.items()))


def reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def moved_bytes(variant: str, x: torch.Tensor) -> int:
    return _PASSES.get(variant, 6) * x.numel() * 4


def _input(pairs: int, dev) -> torch.Tensor:
    i = torch.arange(pairs * 2 * 512 * 512, device=dev, dtype=torch.float32)
    return (0.3 * torch.sin(0.37 * i)).reshape(pairs, *SHAPE)


def verify(device="cuda") -> dict:
    """Every variant against ``x.clone()`` at both shapes: bitwise."""
    dev = _probe.card(device)
    for pairs in PAIRS:
        x = _input(pairs, dev)
        for v in VARIANTS:
            _probe.expect(f"copy_floor {v} pairs={pairs}", copy_floor(x, v),
                          reference(x), None)
        del x
    torch.cuda.synchronize(dev)
    return {"probe_copy_floor": 0.0}


def run(device="cuda", reps: int = 5) -> dict:
    dev = _probe.card(device)
    occ = cluster_occupancy(dev)
    lines, times, kernels = [], {}, {}
    for pairs in PAIRS:
        x = _input(pairs, dev)
        bound = roofline.bound(2 * x.numel() * 4, 0, "f32")
        rows = []
        for v in VARIANTS:
            ms = _probe.event_ms(lambda: copy_floor(x, v), reps)
            times[(v, pairs)] = ms
            nb = moved_bytes(v, x)
            if pairs == PAIRS[-1] and nb / (ms * 1e-3) > roofline.HBM_BYTES_PER_S:
                raise RuntimeError(f"copy_floor {v} pairs={pairs}: {nb} B in "
                                   f"{ms:.4f} ms, above 3.35 TB/s")
            rows.append([v, ms, _probe.gbps(nb, ms),
                         f"{nb / roofline.HBM_BYTES_PER_S / (ms * 1e-3):.1%}",
                         f"{bound['bound_ms'] / ms:.1%}"])
        plain_ms = _probe.event_ms(lambda: reference(x), reps)
        times[("x.clone()", pairs)] = plain_ms
        rows.append(["x.clone()", plain_ms, _probe.gbps(2 * x.numel() * 4, plain_ms),
                     f"{bound['bound_ms'] / plain_ms:.1%}",
                     f"{bound['bound_ms'] / plain_ms:.1%}"])
        lines += _probe.table(
            f"copy floor, x [{pairs}, 2, 512, 512] f32 (B = 2^18) (CUDA events, "
            f"median of {reps}); bound of x and y {bound['bound_ms']:.4f} ms; "
            f"share: of the variant's own traffic at 3.35 TB/s, then of the bound",
            ["variant", "ms", "GB/s moved", "share own", "share bound"], rows)
        # The row: the cluster variant at the headline's shape. Its plain
        # version is one library call, x.clone().
        kernels = {"probe_copy_floor": {
            "ms": times[("cluster", pairs)], "plain_ms": plain_ms,
            "library_ms": plain_ms, **bound}}
        del x
    lines.append(occupancy_line(occ))
    return {"lines": lines, "times": times, "occupancy": occ,
            "kernels": kernels}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()
