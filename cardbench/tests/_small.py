"""Small sizes at which every cell runs on the CPU in a test, and a helper
that runs one cell there and returns its result line."""

import contextlib
import io
import json

from cardbench import run

SMALL = {
    "hires96k.device": {"frames": 400_000},
    "cd44k.device": {"frames": 400_000},
}
CELLS = sorted(SMALL)


def run_cell(cell: str, seed: int = 4294967311, trace: int = 0, seconds: float = 0.3):
    """(exit code, result dict or None, stdout, stderr) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", params=SMALL[cell])
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, out.getvalue(), err.getvalue()
