"""The shipped segment kernel of two checkouts of the repository, held
against each other on one card.

    python3 segment_ab.py OTHER_ROOT [--new-code]

For a change that must leave the shipped kernel as it was (a refactor of
``csrc/``), run from this checkout's root with another checkout (say, the
parent commit unpacked by ``git archive``) as ``OTHER_ROOT``. Both
checkouts build their ``segment_filter`` and ``conv_blocks`` libraries at
once; then one child
process per turn, in the order other, this, this, other, with the turn's
checkout as its working directory, imports that checkout's package and
``chip_smoke.py`` and prints:

- the ``ptxas`` summary line of its build (``chip_smoke._ptxas_summary``),
  and the ``ptxas`` report of each B = 2^18 (512 x 512) instantiation,
  with the sha256 of its SASS where the toolkit has ``cuobjdump``;
- the block path's (``conv_blocks``, which shares ``fourstep.cuh``)
  ``ptxas`` summary line and the sha256 of all its SASS;
- the sha256 of the kernel's output and peak on chip_smoke's phase-3 calls
  (the seeded 2 x 30 s inputs: f64 and f32 at 96 kHz, i16 at 44.1 kHz)
  and on 2 x 30 s of the long filter in f64 (``-f 10 -s 5``: B = 2^19,
  the 1024 x 512 split);
- the sha256 of file (a) (chip_smoke's 10-minute 96 kHz 24-bit WAV, made
  once here) filtered through the CLI;
- the median device ms of each of those calls (``chip_smoke._time_ms``).

It fails unless every turn's hashes and ``ptxas`` lines are equal, and
prints each turn's times: a difference between the two checkouts reads
only against the spread of one checkout's two turns. ``--new-code``: the
change compiles to other code by design (a redesigned pass with the same
arithmetic, or one that changes only other splits); the hashes must still
be equal, the ``ptxas`` lines, the 2^18 instantiations and the block path
of the two checkouts may differ (each checkout's two turns must still
agree), and it prints, kernel by kernel at 2^18, which are equal in
``ptxas`` report and SASS in both checkouts, which differ and which only
one has, and whether the block path is the same.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import textwrap
from concurrent.futures import ThreadPoolExecutor
from itertools import zip_longest
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from audio_fir_filter_tpu_torch.ops import _build; "
          "[_build.build(n, force=True) for n in ('segment_filter', 'conv_blocks')]")

_TURN = textwrap.dedent("""
    import hashlib, json, os, re, shutil, subprocess, sys
    sys.path.insert(0, ".")
    import numpy as np
    import torch
    import chip_smoke as cs
    from audio_fir_filter_tpu_torch.cli import main as cli
    from audio_fir_filter_tpu_torch.models import LowCut
    from audio_fir_filter_tpu_torch.ops import _build
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    log = (_build.BUILD_DIR / "segment_filter.ptxas.log").read_text()
    out = {"root": str(__import__("pathlib").Path(".").resolve()),
           "ptxas": cs._ptxas_summary(log), "sha": {}, "ms": {},
           "ptxas18": {}, "sass18": None}
    # The 2^18 (512 x 512) instantiations: their ptxas reports and SASS,
    # with the anonymous namespace's name (it hashes the source's path),
    # the ablation policy's arguments (a new switch adds one) and ptxas's
    # compile times left out.
    tag, cur = "SplitILi9ELi9E", None
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\\d+_\\w+?_cu_[0-9a-f]{8}"
                      r"|(?<=NS_6Ablate)I(?:L[bi]\\d+E)+E")
    for line in log.splitlines():
        line = anon.sub("anon", line)
        m = re.search(r"Compiling entry function '(\\S+)'", line)
        if m:
            cur = m[1] if tag in m[1] else None
            if cur:
                out["ptxas18"][cur] = []
        elif cur and "Compile time" not in line:
            out["ptxas18"][cur].append(line.split(":", 1)[-1].strip())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")

    def sass(lib, keep):
        dump = subprocess.run(
            [cuobjdump, "-sass", str(_build.BUILD_DIR / f"lib{lib}.so")],
            capture_output=True, text=True).stdout
        got = {}
        for fn in re.split(r"\\n\\s*Function : ", dump)[1:]:
            name, _, body = fn.partition("\\n")
            if keep(name):
                # Whitespace taken out: cuobjdump pads every instruction
                # to the widest in the whole library, so a kernel added
                # anywhere would change every kernel's text.
                got[anon.sub("anon", name.strip())] = hashlib.sha256(
                    " ".join(anon.sub("anon", body).split()).encode()).hexdigest()
        return got

    # The block path (conv_blocks.cu, which shares fourstep.cuh): its
    # ptxas line and the sha256 of all its SASS.
    out["blocks"] = {"ptxas": cs._ptxas_summary(
        (_build.BUILD_DIR / "conv_blocks.ptxas.log").read_text()), "sass": None}
    if os.path.isfile(cuobjdump):
        out["sass18"] = sass("segment_filter", lambda name: tag in name)
        out["blocks"]["sass"] = hashlib.sha256(json.dumps(
            sass("conv_blocks", lambda name: True), sort_keys=True).encode()).hexdigest()
    rng = np.random.default_rng(cs.SEED)
    for mode, precision, fs, i16, _ in cs.MODES:
        plan = LowCut(freq=15.0, slope=10.0).plan(fs, precision=precision,
                                                  device="cuda")
        x = cs._signal(fs, 30.0, rng)
        if i16:
            x = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
        xd = torch.from_numpy(x).cuda()
        n = x.shape[1]
        y, pk = sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16)
        out["sha"][mode] = hashlib.sha256(
            y.cpu().numpy().tobytes() + pk.cpu().numpy().tobytes()).hexdigest()
        out["ms"][mode] = cs._time_ms(
            lambda: sf.segment_filter(xd, plan, plan.mo2, n, i16_io=i16))
    # The long filter in f64 (M = 76,800 at 96 kHz, B = 2^19, 1024 x 512).
    plan = LowCut(freq=10.0, slope=5.0).plan(96000.0, precision="high",
                                             device="cuda")
    xd = torch.from_numpy(cs._signal(96000.0, 30.0, rng)).cuda()
    n = xd.shape[1]
    y, pk = sf.segment_filter(xd, plan, plan.mo2, n)
    out["sha"]["f64 2^19"] = hashlib.sha256(
        y.cpu().numpy().tobytes() + pk.cpu().numpy().tobytes()).hexdigest()
    out["ms"]["f64 2^19"] = cs._time_ms(
        lambda: sf.segment_filter(xd, plan, plan.mo2, n))
    assert cli([sys.argv[1], sys.argv[2], "-O"]) == 0
    with open(sys.argv[2], "rb") as f:
        out["sha"]["file (a)"] = hashlib.sha256(f.read()).hexdigest()
    print(json.dumps(out))
""")


def _turn(root: Path, file_a: Path, out: Path) -> dict:
    r = subprocess.run([sys.executable, "-c", _TURN, str(file_a), str(out)],
                       cwd=root, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"turn in {root} exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run(other: Path, new_code: bool = False) -> list[str]:
    """The four turns; raises unless both checkouts agree (with
    ``new_code``, unless their hashes agree and each checkout's ``ptxas``
    line is the same in its two turns). Returns the printed lines."""
    import chip_smoke as cs

    other = Path(other).resolve()
    roots = (other, ROOT, ROOT, other)
    with ThreadPoolExecutor(2) as pool:
        for r in pool.map(lambda root: subprocess.run(
                [sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
                text=True, timeout=900), (other, ROOT)):
            if r.returncode != 0:
                raise RuntimeError(f"build failed: {r.stderr[-3000:]}")
    with tempfile.TemporaryDirectory(prefix="lowcut_ab_") as tmp:
        file_a = cs.make_inputs(Path(tmp))["a"]
        turns = [_turn(root, file_a, Path(tmp) / f"a_{i}.wav")
                 for i, root in enumerate(roots)]
    lines = [f"turn {i}: {t['root']}: ptxas segment_filter: {t['ptxas']}; ms "
             + ", ".join(f"{k} {v:.4f}" for k, v in t["ms"].items())
             for i, t in enumerate(turns)]
    ptxas_pairs = ((turns[0], turns[3]), (turns[1], turns[2])) if new_code \
        else ((turns[0], t) for t in turns)
    if any(a["ptxas"] != b["ptxas"] for a, b in ptxas_pairs):
        raise RuntimeError("the turns differ in ptxas:\n" + "\n".join(lines))
    if any(t["sha"] != turns[0]["sha"] for t in turns):
        raise RuntimeError("the checkouts differ in sha:\n"
                           + "\n".join(lines + [json.dumps(t["sha"]) for t in turns]))
    same = turns[0]["ptxas"] == turns[1]["ptxas"]
    lines.append("outputs byte-identical in every turn ("
                 + ", ".join(turns[0]["sha"]) + "); ptxas lines "
                 + ("equal" if same else "differ (other, this)"))
    # Each checkout's two turns must agree; without --new-code the two
    # checkouts too.
    within = ((turns[0], turns[3]), (turns[1], turns[2]))
    across = within if new_code else tuple((turns[0], t) for t in turns)
    p18 = [t["ptxas18"] for t in turns]
    if not p18[0] or any(a["ptxas18"] != b["ptxas18"] for a, b in across):
        raise RuntimeError("the 2^18 instantiations' ptxas reports differ "
                           f"between the turns (or none was found):\n{p18}")
    s18 = [t["sass18"] for t in turns]
    if None in s18:
        sass_said = "SASS not compared (no cuobjdump)"
    elif all(a["sass18"] == b["sass18"] for a, b in across):
        sass_said = ("SASS equal in every turn" if s18[0] == s18[1]
                     else "SASS equal in each checkout's two turns")
    else:
        sass_said = "SASS differs between the turns"
    if p18[0] == p18[1] and s18[0] == s18[1]:
        lines.append(f"the {len(p18[0])} kernels at B = 2^18 (512 x 512): ptxas "
                     f"reports equal in every turn; {sass_said}")
    else:
        # --new-code: kernel by kernel, this checkout against the other.
        (po, so), (pt, st) = (p18[0], s18[0] or {}), (p18[1], s18[1] or {})
        both = set(po) & set(pt)
        same = sorted(k for k in both if po[k] == pt[k] and so.get(k) == st.get(k))
        # Each kernel that differs: in what, and its first ptxas lines that
        # differ (the other's, this one's).
        differ = {k: ("ptxas " + str(next((a, b) for a, b in zip_longest(
                          po[k], pt[k], fillvalue="") if a != b)) if po[k] != pt[k] else "")
                  + (" SASS" if so.get(k) != st.get(k) else "")
                  for k in sorted(both - set(same))}
        lines.append(
            f"the kernels at B = 2^18 (512 x 512), this checkout against the "
            f"other ({sass_said}): equal in ptxas and SASS {same}; differ "
            f"{differ}; only in the other "
            f"{sorted(set(po) - set(pt))}; only in this {sorted(set(pt) - set(po))}")
    blocks = [t["blocks"] for t in turns]
    if any(a["blocks"] != b["blocks"] for a, b in across):
        raise RuntimeError(f"the block path differs between the turns: {blocks}")
    lines.append("the block path (conv_blocks): ptxas line and SASS "
                 + ("equal in every turn" if blocks[0] == blocks[1]
                    else f"differ (other, this): {blocks[0]}, {blocks[1]}")
                 + ("" if blocks[0]["sass"] else " (SASS not compared: no cuobjdump)"))
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    new_code = "--new-code" in argv
    argv = [a for a in argv if a != "--new-code"]
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    print("\n".join(run(Path(argv[0]), new_code)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
