"""Scaling harness for the time-sharded filter (``bench --scaling``).

Counterpart of ``audio_fir_filter_tpu/parallel/scaling_bench.py``. Three
parts, all reported on stderr through the caller's ``log``:

1. **A model of the halo cost across cards** (:func:`halo_cost_model`):
   per segment a shard exchanges Mo2 samples with each of its two
   neighbours, whatever the segment's length, while its compute scales
   with its local span. Efficiency = t_comp / (t_comp + t_halo) with no
   overlap assumed (the worst case). The per-cell rate is the one the
   bench measured in the same run on its device; the link rates are public
   figures of the H100 (below). One machine with one card cannot measure a
   speed-up across cards, so these rows are a model and are printed as one.

2. **The real sharded program in one process** (:func:`run_child`):
   ``sharded_filter`` at T = 1/2/4/8 time cells over the same signal, all
   cells on the bench's device. On one card the cells run one after
   another on one stream, so this measures what the halo bookkeeping
   costs (slices, copies, more and smaller launches), not a speed-up; it
   catches a halo exchange that got structurally expensive.

3. **A measured exchange between processes** (:func:`run_cross_process`):
   two processes in a gloo group (file rendezvous) run the production
   ``_halo_exchange`` against a twin that communicates nothing, and a timed
   2-process ``sharded_filter`` against a 1-process run of the same span
   per shard. The measured halo cost then takes the link's place in the
   model's formula. gloo over localhost, with CUDA halos staged through
   the host, is a conservative stand-in for a network path.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import kernel_design as kd
from ..ops import overlap_save as osv
from . import distributed
from .mesh import make_mesh
from .sharded_conv import LocalShards, _halo_exchange, sharded_filter

ROOT = Path(__file__).resolve().parent.parent.parent

# Link rates of the model, bytes/s one way for one card, with their
# sources. Neither was measured here: the machine has one card.
LINKS = (
    ("nvlink", 4.5e11,
     "NVLink, 900 GB/s bidirectional per card = 450 GB/s one way "
     "(NVIDIA H100 SXM data sheet)"),
    ("nic", 5.0e10,
     "host NIC, one 400 Gb/s port per card = 50 GB/s (NVIDIA DGX H100 data "
     "sheet: 8 x 400 Gb/s ConnectX-7 for 8 cards; below the card's PCIe "
     "Gen5 x16, 64 GB/s one way, H100 SXM data sheet)"),
)
MODEL_NOTE = "model, not measured: one card"
SHARD_COUNTS = (2, 4, 8, 16, 64, 256)
CHILD_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Workload:
    """The filter and signal of a scaling run (the bench's arguments)."""

    freq: float = 15.0
    slope: float = 10.0
    fs: float = 96000.0
    channels: int = 2
    block_size: int = 0

    def taps(self) -> np.ndarray:
        return kd.highpass_taps(self.freq / self.fs,
                                kd.kernel_length(self.slope / self.fs))


def halo_cost_model(log, chip_rate: float, workload: Workload = Workload()):
    """Predicted scaling of the halo-exchange design over one hour of the
    workload's audio, for several shard counts and both link classes, at
    ``chip_rate`` samples/s per cell (measured by the caller)."""
    m = kd.kernel_length(workload.slope / workload.fs)
    mo2 = m // 2
    n = int(3600 * workload.fs)          # 1 h of frames, per channel
    c = workload.channels
    halo_bytes = 2 * c * mo2 * 4.0       # both neighbours, float32
    rows = []
    log(f"halo-cost model (1 h {workload.fs / 1000:g} kHz x {c} ch, M={m}; "
        f"{MODEL_NOTE}):")
    for name, rate, source in LINKS:
        log(f"  {name}: {rate / 1e9:.0f} GB/s: {source}")
    log("  shards  local-span  t_comp(ms)  t_nvlink(us)  eff_nvlink  "
        "t_nic(us)  eff_nic")
    for t in SHARD_COUNTS:
        s_local = n // t
        t_comp = c * s_local / chip_rate
        row = {"shards": t, "local_span": s_local}
        cells = [f"  {t:6d}  {s_local:10d}  {t_comp * 1e3:10.3f}"]
        for name, rate, _ in LINKS:
            t_link = halo_bytes / rate
            row[f"eff_{name}"] = t_comp / (t_comp + t_link)
            cells.append(f"  {t_link * 1e6:11.2f}  {row[f'eff_{name}']:10.6f}")
        rows.append(row)
        log("".join(cells))
    log("  (efficiency = t_comp / (t_comp + t_halo), no overlap: the worst "
        "case)")
    return rows


def run_scaling(log, workload: Workload, rates: dict, device, where: str):
    """The whole report. ``rates`` maps a precision to the samples/s per
    cell that the caller measured in this run on ``device``; ``where``
    names the device (and the card's power limit) beside every measured
    number. Raises if any part fails."""
    dev = torch.device(device)
    for precision, rate in rates.items():
        log(f"{precision} path: {rate / 1e9:.3f} G samples/s per cell, "
            f"measured in this run on {where}")
        halo_cost_model(log, rate, workload)
    run_child(log, workload, dev, where)
    run_cross_process(log, workload, dev, rates, where)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, reps: int, dev: torch.device) -> float:
    """Seconds per call over ``reps`` calls after one warm-up call (host
    clock around synchronised work)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def _span(plan, floor: int) -> int:
    """A shard span of whole hops, at least ``floor`` frames and Mo2."""
    return -(-max(floor, plan.mo2, 1) // plan.hop) * plan.hop


def run_child(log, workload: Workload, dev: torch.device, where: str):
    """``sharded_filter`` at T = 1/2/4/8 cells in this process, every cell
    on ``dev``; returns the rows."""
    # "fast" keeps a CPU run quick; the exchange schedule does not depend
    # on the precision.
    plan = osv.make_plan(workload.taps(), osv.FAST, workload.block_size, dev)
    c = workload.channels
    n = 8 * _span(plan, 1 << 17)
    x = torch.from_numpy(np.random.default_rng(3)
                         .uniform(-0.5, 0.5, (c, n)).astype(np.float32)).to(dev)
    what = ("one card, one stream: the cells run one after another, so this "
            "is what the halo bookkeeping costs, not a speed-up"
            if dev.type == "cuda" else
            "one host: flat is ideal")
    log(f"sharded_filter in one process, T cells on {where} ({c} ch x {n} "
        f"frames, M={plan.m}, B={plan.block_size}; {what}):")
    rows = []
    for t in (1, 2, 4, 8):
        mesh = make_mesh((1, t), [dev] * t)
        dt = _timeit(lambda: sharded_filter(x, plan, mesh), 10, dev)
        rows.append({"t": t, "rate": c * n / dt})
        log(f"  T={t}: {rows[-1]['rate'] / 1e6:10.1f} Ms/s "
            f"(vs T=1: {rows[-1]['rate'] / rows[0]['rate']:.3f})")
    return rows


def _children(argv_of_rank, world: int) -> list[dict]:
    """Run ``world`` children at once; each one's last stdout line as JSON.
    Raises if one fails or outlasts its time limit; leaves none running."""
    procs = [subprocess.Popen(argv_of_rank(r), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(world)]
    rows = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"scaling child {r} of {world} exited "
                                   f"{p.returncode}: {err[-1500:]}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return rows


def run_cross_process(log, workload: Workload, dev: torch.device,
                      rates: dict, where: str) -> dict:
    """The measured exchange between two processes (see the module
    docstring), and the model's 2-shard rows with the measured halo cost
    in the link's place. Returns the numbers it printed."""
    tmp = tempfile.mkdtemp(prefix="lowcut_scaling_")
    try:
        def argv(world, name):
            return lambda rank: [
                sys.executable, "-m",
                "audio_fir_filter_tpu_torch.parallel.scaling_bench", "--xproc",
                str(rank), str(world), f"{tmp}/{name}", dev.type,
                json.dumps(dataclasses.asdict(workload))]

        row = _children(argv(2, "pair"), 2)[0]
        base = _children(argv(1, "single"), 1)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    c = workload.channels
    halo_net = max(row["halo_ms"] - row["nocomm_ms"], 0.0) * 1e-3
    halo_bytes = 2 * c * row["mo2"] * 4.0    # 2 directions x [C, Mo2] f32
    staged = (", CUDA halos staged through pinned host memory"
              if dev.type == "cuda" else "")
    log(f"measured exchange between 2 processes (gloo group, file "
        f"rendezvous, localhost{staged}; each on {where}):")
    log(f"  halo exchange (production _halo_exchange, Mo2={row['mo2']}): "
        f"{row['halo_ms']:.3f} ms/call vs no-communication twin "
        f"{row['nocomm_ms']:.3f} ms -> net {halo_net * 1e3:.3f} ms "
        f"({halo_bytes / 1e3:.0f} KB payload, "
        f"{halo_bytes / max(halo_net, 1e-9) / 1e6:.1f} MB/s effective)")
    eff = row["filter_rate"] / (2 * base["filter_rate"])
    shared = ("both processes share the one card" if dev.type == "cuda"
              else "both processes share this host's cores")
    log(f"  sharded_filter 2-process: {row['filter_rate'] / 1e6:.1f} Ms/s "
        f"global ({row['span']} frames/shard); 1-process same-span baseline "
        f"{base['filter_rate'] / 1e6:.1f} Ms/s -> weak-scaling ratio "
        f"{eff:.3f} ({shared}: a structural check, not a prediction)")
    n = int(3600 * workload.fs)
    log(f"  the model's 2-shard rows with the MEASURED per-exchange cost in "
        f"the link's place (no overlap; {MODEL_NOTE}):")
    effs = {}
    for precision, rate in rates.items():
        t_comp = c * (n // 2) / rate
        effs[precision] = t_comp / (t_comp + halo_net)
        log(f"    2 shards, {precision} path ({rate / 1e9:.3f} G samples/s): "
            f"t_comp {t_comp * 1e3:.1f} ms + measured halo "
            f"{halo_net * 1e3:.3f} ms -> eff {effs[precision]:.6f}")
    return {"halo_net_s": halo_net, "weak_scaling": eff, "eff": effs}


def run_xproc_child(rank: int, world: int, rendezvous: str, device: str,
                    workload: Workload) -> None:
    """Child of :func:`run_cross_process`: joins the gloo group (none for
    ``world`` 1) and times (a) the production halo exchange and its twin
    and (b) ``sharded_filter`` on the (1, world) mesh, one cell a rank;
    prints one JSON line."""
    dev = torch.device(device)
    if world > 1:
        distributed.initialize(f"file://{rendezvous}", world, rank,
                               backend="gloo")
    try:
        plan = osv.make_plan(workload.taps(), osv.FAST, workload.block_size,
                             dev)
        mesh = make_mesh((1, world), [(r, dev) for r in range(world)])
        alone = make_mesh((1, 1), [dev])
        c, span = workload.channels, _span(plan, 1 << 20)
        n = world * span
        # The signal lives on the device, as a sharded array would.
        x = torch.linspace(-0.5, 0.5, c * span, device=dev)
        x = x.reshape(c, span).repeat(1, world)
        local = x[:, rank * span : (rank + 1) * span].contiguous()
        halo_s = _timeit(lambda: _halo_exchange({(0, rank): local}, plan.mo2,
                                                mesh), 30, dev)
        nocomm_s = _timeit(lambda: _halo_exchange({(0, 0): local}, plan.mo2,
                                                  alone), 30, dev)
        y, _ = sharded_filter(x, plan, mesh)
        parts = y.parts.values() if isinstance(y, LocalShards) else [y]
        if not all(bool(torch.isfinite(p).all()) for p in parts):
            raise RuntimeError("non-finite output")
        dt = _timeit(lambda: sharded_filter(x, plan, mesh), 3, dev)
        print(json.dumps({"rank": rank, "mo2": plan.mo2, "span": span,
                          "halo_ms": halo_s * 1e3, "nocomm_ms": nocomm_s * 1e3,
                          "filter_rate": c * n / dt}), flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    if len(sys.argv) != 7 or sys.argv[1] != "--xproc":
        sys.exit("usage: python3 -m audio_fir_filter_tpu_torch.bench --scaling")
    run_xproc_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5], Workload(**json.loads(sys.argv[6])))
