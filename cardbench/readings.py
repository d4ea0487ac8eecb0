"""The two readings each limit is set from, for many seeds in one process.

    python3 -m cardbench.readings --workload <cell> --seeds 11,12,13 --seconds 3

Per seed, with the cell's inputs from that seed: set-up and a short window
of the program at the cell's own sizes and load, then its check (the
lower reading: what sound runs of the program give), and the control: the
plain reference put in the program's place, computed one step below the
precision the configuration states (``high``: float64 -> float32;
``fast``: float32 -> bfloat16), then the same check (the upper reading:
it has to fail). One JSON line per seed, then the largest program reading
and the smallest control reading of each number. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

CONTROL = {"high": "float32", "fast": "bfloat16"}


def readings(cell: str, seed: int, seconds: float, device=None, params=None) -> dict:
    import torch

    from . import run

    args = run.build_parser().parse_args(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    _, ctx, kind = run.start(args, device, params)
    try:
        st = kind.setup(ctx)
        run._window(ctx, kind, st, seconds, False)
        out = kind.finish(ctx, st)
        program, _ = kind.check(ctx, st, out)
        del out
        precision = CONTROL[ctx.cfg["precision"]]
        control, _ = kind.check(ctx, st, kind.control(ctx, st, precision))
        jobs = len(ctx.rec.jobs)
        del st
    finally:
        shutil.rmtree(ctx.workdir, ignore_errors=True)
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return {"seed": seed, "jobs": jobs, "control_precision": precision,
            "program": program, "control": control,
            "program_correct": all(run.passed(v, ctx.limits[k]) for k, v in program.items()),
            "control_correct": all(run.passed(v, ctx.limits[k]) for k, v in control.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        rows.append(readings(a.workload, seed, a.seconds))
        print(json.dumps(rows[-1]), flush=True)
    keys = rows[0]["program"].keys()
    print(json.dumps({
        "workload": a.workload, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in keys},
        "control_min": {k: min(r["control"][k] for r in rows) for k in keys},
        "program_all_correct": all(r["program_correct"] for r in rows),
        "control_any_correct": any(r["control_correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
