"""Run one cell of the benchmark once.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``cardbench/``
and the program, ``audio_fir_filter_tpu_torch``. The cell is the entry of
``BENCHMARK.json``'s ``workloads`` of that name; its file
``cardbench/workloads/<cell>.json`` names its configuration
(``cardbench/configs/<config>.json``), its traffic kind
(``cardbench/traffic/<kind>.py``), the kind's parameters and the limit of
each number the correctness check compares.

A run: set-up (imports, the card, the kind's seeded inputs, one warm-up
job that builds or loads every kernel the cell uses), then the window:
jobs back to back, closed loop, until the first job that ends at least
``--seconds`` after the window opened; then the check of what the window
produced against the plain reference. With ``--trace 1`` the window runs
under ``torch.profiler`` and the cell's per-layer metrics are read
(``cardbench/layer_metrics/<metric>.py``); otherwise its end-to-end
metrics (``cardbench/end_to_end/<metric>.py``).

Output: informational lines, then one JSON object as the last line of
standard output; the numbers compared, each beside its limit, are the
last lines of standard error. No card, too few cards, a program or JAX
that cannot be imported, or JAX in ``sys.modules`` once the window has
closed: a non-zero exit and no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_fir_filter_tpu")


def module_name(metric: str) -> str:
    """A metric's reader module: its name with ``.`` and ``-`` as ``_``."""
    return metric.replace(".", "_").replace("-", "_")


def load_cell(name: str) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, its file, its
    configuration, and the metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file cardbench/workloads/{name}.json")
    wl = json.loads(path.read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"no cell {name} in BENCHMARK.json")
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"cardbench/workloads/{name}.json names "
                         f"{wl['config']}/{wl['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    cfg = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"entry": entry, "workload": wl, "config": cfg,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _io_written() -> dict:
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (ln.split(":") for ln in f if ":" in ln)}
    except OSError:
        return {}


def _card_line(device) -> str:
    import torch

    if device.type != "cuda":
        return f"card: none (device {device})"
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return f"card: {name}, power limit {limit}"


def _window(ctx, kind, st, seconds: float, trace: bool) -> None:
    import torch

    rec = ctx.rec
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    rec.on, rec.tracing = True, trace
    try:
        t0 = time.perf_counter()
        with rec.span("window"):
            while True:
                kind.job(ctx, st)
                if time.perf_counter() - t0 >= seconds:
                    break
        rec.window_s = time.perf_counter() - t0
    finally:
        rec.on = False
        if prof is not None:
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            prof.__exit__(None, None, None)
    if prof is not None:
        from .trace import Trace

        path = ctx.workdir / "trace.json"
        prof.export_chrome_trace(str(path))
        rec.trace = Trace.load(path)
        path.unlink()


def _read_metrics(package: str, metrics: list[dict], rec, notes: list) -> dict:
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"cardbench.{package}.{module_name(m['name'])}")
        got = reader.read(rec)
        if isinstance(got, dict):
            notes.append(f"{m['name']}: {got['note']}")
            got = got["value"]
        if got is not None:
            out[m["name"]] = {"value": got, "unit": m["unit"]}
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _plain(v):
    """A number for the result line: non-finite floats as strings, which
    strict JSON readers take."""
    return v if not isinstance(v, float) or math.isfinite(v) else repr(v)


def passed(value, limit) -> bool:
    """A number meets its limit (NaN never does)."""
    return value <= limit


def start(args, device=None, params=None):
    """Everything up to the window: the cell, the device (the card, unless
    a test hands in another), the context and the traffic kind."""
    from .record import Ctx, Record

    cell = load_cell(args.workload)
    wl = cell["workload"]
    import torch

    if device is None:
        need = cell["entry"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"cell {args.workload} needs {need} CUDA card(s); "
                             f"{have} visible. No result.")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    kind = importlib.import_module(f"cardbench.traffic.{wl['kind']}")
    workdir = Path(tempfile.mkdtemp(prefix="cardbench-"))
    ctx = Ctx(cfg=cell["config"],
              params={**wl["params"], **(params or {})}, limits=wl["limits"],
              seed=args.seed, device=device, workdir=workdir,
              rec=Record(cell["config"]))
    return cell, ctx, kind


def main(argv=None, device=None, params=None) -> int:
    """Run the cell. ``device`` and ``params`` are for the tests alone: a
    CPU run of the rest of the harness at a size a test can hold."""
    args = build_parser().parse_args(argv)
    cell, ctx, kind = start(args, device, params)
    import torch

    try:
        st = kind.setup(ctx)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ctx.rec.setup_s = _process_age_s()
        _window(ctx, kind, st, args.seconds, bool(args.trace))
        mem = (torch.cuda.max_memory_allocated(ctx.device)
               if ctx.device.type == "cuda" else 0)
        out = kind.finish(ctx, st)
        numbers, failed = kind.check(ctx, st, out)
        del out
        del st
    finally:
        shutil.rmtree(ctx.workdir, ignore_errors=True)

    rec = ctx.rec
    notes: list[str] = []
    if args.trace:
        metrics = _read_metrics("layer_metrics", cell["per_layer"], rec, notes)
    else:
        metrics = _read_metrics("end_to_end", cell["end_to_end"], rec, notes)
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.device.type == "cuda" else str(ctx.device)),
                   "count": cell["entry"]["chips"], "memory_peak_bytes": mem}
    result = {"correct": all(passed(v, ctx.limits[k]) for k, v in numbers.items()),
              "attempted": len(rec.jobs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s()
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = {k: {"value": _plain(v), "limit": ctx.limits[k]}
                        for k, v in numbers.items()}

    bad = forbidden_modules()
    if bad:
        print(f"sys.modules holds {', '.join(bad)} after the window: no result",
              file=sys.stderr)
        return 3
    io = _io_written()
    print(_card_line(ctx.device))
    print(f"memory: peak {mem} bytes allocated on {ctx.device}")
    print(f"disk: this process {io.get('write_bytes', 'unknown')} bytes to storage, "
          f"{io.get('wchar', 'unknown')} through write calls")
    print(f"modules: none of {', '.join(FORBIDDEN)} in sys.modules")
    print(f"window: {rec.window_s:.3f} s, {len(rec.jobs)} jobs; setup {rec.setup_s:.3f} s")
    if rec.jobs:
        lat = sorted(j["latency_s"] for j in rec.jobs)
        q = [lat[round(f * (len(lat) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
        print("jobs: latency s min, quartiles, max " + " ".join(f"{v:.6f}" for v in q)
              + f" ({rec.jobs[0]['clock']} clock)")
    if rec.trace is not None:
        print(rec.trace.summary())
    for note in notes:
        print(note)
    print(json.dumps(result), flush=True)
    for k, v in numbers.items():
        lim = ctx.limits[k]
        print(f"check {k} {v!r} limit {lim!r} {'ok' if passed(v, lim) else 'FAIL'}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            code = 2
        else:
            code = e.code or 0
    sys.exit(code)
