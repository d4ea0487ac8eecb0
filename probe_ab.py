"""The copy-floor probes of two checkouts of the repository, timed in turns
on one card.

    python3 probe_ab.py OTHER_ROOT

Run from this checkout's root with another checkout (say, the parent commit
unpacked by ``git archive``) as ``OTHER_ROOT``. Both checkouts build their
``probe_floors`` library at once; then one child process per turn, in the
order other, this, this, other, with the turn's checkout as its working
directory, imports that checkout's probes and prints the median device ms
(``experiments/_probe.event_ms``, 10 calls) of:

- ``dma_bw_micro.bw(x, "both", split)`` at rows 2048, split 1 and 4;
- ``copy_floor_probe.copy_floor(x, v)`` at 8 and 1008 pairs for ``tr``
  and, where the checkout has it, ``cluster``;
- ``x.clone()`` on each of those inputs.

Every output is checked bitwise against ``x.clone()``. A difference between
the checkouts reads only against the spread of one checkout's two turns.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from audio_fir_filter_tpu_torch.ops import _build; "
          "_build.build('probe_floors', force=True)")

_TURN = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, ".")
    import torch
    from audio_fir_filter_tpu_torch.experiments import _probe
    from audio_fir_filter_tpu_torch.experiments import copy_floor_probe as cfp
    from audio_fir_filter_tpu_torch.experiments import dma_bw_micro as bwm

    ms = {}
    def timed(name, fn, x):
        _probe.expect(name, fn(), x, None)
        ms[name] = _probe.event_ms(fn, 10)

    x = bwm._input(2048, torch.device("cuda"))
    for split in bwm.SPLITS:
        timed(f"bw both rows 2048 split {split}", lambda: bwm.bw(x, "both", split), x)
    timed("x.clone() rows 2048", lambda: x.clone(), x)
    del x
    for pairs in (8, 1008):
        # Both checkouts' copy-floor input, at this shape.
        i = torch.arange(pairs * 2 * 512 * 512, device="cuda",
                         dtype=torch.float32)
        x = (0.3 * torch.sin(0.37 * i)).reshape(pairs, 2, 512, 512)
        del i
        for v in ("tr", "cluster"):
            if v in cfp.VARIANTS:
                timed(f"{v} pairs {pairs}", lambda: cfp.copy_floor(x, v), x)
        timed(f"x.clone() pairs {pairs}", lambda: x.clone(), x)
        del x
    print(json.dumps(ms))
""")


def _turn(root: Path) -> dict:
    r = subprocess.run([sys.executable, "-c", _TURN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"turn in {root} exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run(other: Path) -> list[str]:
    """The four turns; returns the printed lines (a table, ms per turn)."""
    other = Path(other).resolve()
    roots = (other, ROOT, ROOT, other)
    with ThreadPoolExecutor(2) as pool:
        for r in pool.map(lambda root: subprocess.run(
                [sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
                text=True, timeout=600), (other, ROOT)):
            if r.returncode != 0:
                raise RuntimeError(f"build failed: {r.stderr[-3000:]}")
    turns = [_turn(root) for root in roots]
    names = sorted({k for t in turns for k in t})
    lines = [f"turns: {' / '.join(str(r) for r in roots)} (ms, CUDA events, "
             f"median of 10; outputs bitwise equal to x.clone())"]
    for k in names:
        lines.append(f"  {k:28s} " + "  ".join(
            f"{t[k]:.4f}" if k in t else "     -" for t in turns))
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    print("\n".join(run(Path(argv[0]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
