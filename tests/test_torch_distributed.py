"""The port's multi-process runtime (``parallel/distributed.py``) and the
halo path across a process boundary.

Counterpart of tests/test_distributed.py over ``torch.distributed``: real
CPU processes in a gloo group (rendezvous through a file in ``tmp_path``,
or a free localhost port for the CLI's ``--coordinator``). Asserted:
(a) batch file sharding is a disjoint exact cover; (b) a join that fails
raises (through the CLI: exit 1, nothing written) and only an initialised
group is left alone; (c) the halo exchange of a (1, 8) time mesh over 2
processes x 4 cells, the shard-3 | shard-4 halo crossing the process
boundary, against the float64 oracle (``fast`` engine on normalized full
scale: max abs error < 5e-5, peak ``rtol=1e-5``, as the JAX test); (d) each
process of a 2-process batch filters its own files through the CLI, and
with ``--resume`` both record them in the one manifest.
"""

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.cli import main
from audio_fir_filter_tpu_torch.parallel import distributed
from audio_fir_filter_tpu_torch.parallel.distributed import shard_files

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu", "--block-size", "1024", "-f", "100", "-s", "200"]
TIMEOUT = 120


def test_shard_files_disjoint_cover():
    paths = [f"f{i}.wav" for i in range(10)]
    a = shard_files(paths, 0, 3)
    b = shard_files(paths, 1, 3)
    c = shard_files(paths, 2, 3)
    assert sorted(a + b + c) == sorted(paths)
    assert not (set(a) & set(b)) and not (set(b) & set(c))
    assert shard_files(paths) == paths          # no group: one process


def test_initialize_only_leaves_an_initialised_group_alone(monkeypatch):
    """A genuinely failed join must abort, not silently proceed as one
    process; and after it ``process_info`` does not answer (0, 1)."""
    calls = []

    def boom(**kw):
        calls.append(kw)
        raise RuntimeError("Barrier timed out joining coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    try:
        with pytest.raises(RuntimeError, match="Barrier timed out"):
            distributed.initialize("127.0.0.1:1", 2, 0)
        assert calls[0]["init_method"] == "tcp://127.0.0.1:1"
        assert (calls[0]["world_size"], calls[0]["rank"]) == (2, 0)
        assert calls[0]["backend"] == "gloo"            # no card here
        with pytest.raises(RuntimeError, match="not initialised"):
            distributed.process_info()
        with pytest.raises(RuntimeError, match="not initialised"):
            shard_files(["a.wav", "b.wav"])
        with pytest.raises(RuntimeError):
            distributed.initialize("file:///tmp/x", 2, 1, backend="nccl")
        assert calls[1]["init_method"] == "file:///tmp/x"
        assert calls[1]["backend"] == "nccl"
        with pytest.raises(RuntimeError):
            distributed.initialize()
        assert calls[2]["init_method"] == "env://"
        assert (calls[2]["world_size"], calls[2]["rank"]) == (-1, -1)

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        distributed.initialize("127.0.0.1:1", 2, 0)     # idempotent: left alone
        assert len(calls) == 3
    finally:
        monkeypatch.undo()
        distributed.shutdown()
    assert distributed.process_info() == (0, 1)


def _run_workers(script, args_of_rank, world=2):
    procs = [subprocess.Popen([sys.executable, "-c", script, str(REPO),
                               *args_of_rank(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO)
             for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed: {err[-1500:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


HALO_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    rank, world, rendezvous = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from audio_fir_filter_tpu_torch.ops import kernel_design as kd, oracle
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv
    from audio_fir_filter_tpu_torch.parallel import distributed
    from audio_fir_filter_tpu_torch.parallel import (LocalShards, assemble,
                                                     make_mesh, sharded_filter)

    distributed.initialize("file://" + rendezvous, world, rank, backend="gloo")
    try:
        assert distributed.process_info() == (rank, world)
        taps = kd.highpass_taps(0.02, 128)   # M=128 -> 129 taps, Mo2=64
        plan = osv.make_plan(taps, "fast", 1024, "cpu")
        rng = np.random.default_rng(11)
        C, per, T = 2, 4, 4 * world
        S = 640                              # shard span 640 > Mo2=64
        N = T * S
        xg = rng.uniform(-1.0, 1.0, (C, N)).astype(np.float32)
        mesh = make_mesh((1, T), [(r, "cpu") for r in range(world)
                                  for _ in range(per)])
        # This process reads only its own cells' slices: everything else is
        # poisoned, so a halo that did not come from the other process
        # would show as NaN.
        mine = xg.copy()
        mine[:, : rank * per * S] = np.nan
        mine[:, (rank + 1) * per * S :] = np.nan
        y, peak = sharded_filter(mine, plan, mesh, normalize=True)
        assert isinstance(y, LocalShards) and y.shape == (C, N)

        want = np.stack([oracle.direct_filter(xg[ch], taps) for ch in range(C)])
        wpeak = float(np.abs(want).max())
        wnorm = (want / wpeak).astype(np.float32)
        errs = [float(np.abs(part.numpy() - wnorm[:, j * S : (j + 1) * S]).max())
                for (i, j), part in y.parts.items()]
        whole = assemble(y, mesh, dst=0)
        whole_err = (float(np.abs(whole - wnorm).max()) if rank == 0 else None)
        assert (whole is None) == (rank != 0)
        print(json.dumps({"rank": rank, "peak": peak, "wpeak": wpeak,
                          "maxerr": max(errs), "cells": sorted(j for _, j in y.parts),
                          "whole_err": whole_err}))
    finally:
        distributed.shutdown()
""")


def test_two_process_halo_exchange(tmp_path):
    """The halo path across a real process boundary: 2 gloo processes x 4
    CPU cells, a global (1, 8) time mesh, sharded_filter + normalize vs the
    float64 oracle."""
    rendezvous = str(tmp_path / "rendezvous")
    results = _run_workers(HALO_WORKER, lambda r: [str(r), "2", rendezvous])
    assert [r["cells"] for r in results] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for r in results:
        # fast (f32) engine vs float64 oracle on normalized full scale
        assert r["maxerr"] < 5e-5, r
        assert abs(r["peak"] - r["wpeak"]) < 1e-5 * r["wpeak"], r
    assert results[0]["whole_err"] < 5e-5 and results[1]["whole_err"] is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wavs(tmp_path, count=4):
    rng = np.random.default_rng(0)
    files = []
    for i in range(count):
        p = tmp_path / f"in{i}.wav"
        x = rng.uniform(-0.5, 0.5, (1, 2000)).astype(np.float32)
        create_audio_file(p, x, 8000.0, encoding=Encoding.PCM_16)
        files.append(str(p))
    return files


def _batch_processes(files, outdir, extra):
    """Run a 2-process batch through the CLI; returns each process's
    standard output."""
    port = _free_port()
    launcher = str(REPO / "bin" / "lowcut-torch")
    procs = [subprocess.Popen(
        [sys.executable, launcher, *files, str(outdir), "-v", *extra,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), *CPU],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"process failed: {err[-1500:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_process_batch_through_the_cli(tmp_path):
    """``--coordinator --num-processes --process-id``: each process joins,
    takes its round-robin share of the batch and filters it; together they
    write every file, each equal to the single-process output."""
    files = _wavs(tmp_path)
    outdir = tmp_path / "out"
    outs = _batch_processes(files, outdir, [])
    for r, out in enumerate(outs):
        assert f"Joined distributed runtime: process {r}/2." in out
        done = [ln.split(": ")[1] for ln in out.splitlines()
                if ln.startswith("Processing file: ")]
        assert done == [f"in{i}.wav" for i in range(r, 4, 2)]
    single = tmp_path / "single"
    assert main([*files, str(single), *CPU]) == 0
    for f in files:
        name = Path(f).name
        assert (outdir / name).read_bytes() == (single / name).read_bytes()


def test_two_process_resume_batch_shares_one_manifest(tmp_path):
    """Both processes of a ``--resume`` batch record their files in the one
    manifest (a write merges the other process's entries), so the rerun
    filters nothing and leaves every output as it was."""
    files = _wavs(tmp_path)
    outdir = tmp_path / "out"
    outs = _batch_processes(files, outdir, ["--resume"])
    assert sum(o.count("Processing file: ") for o in outs) == 4
    done = json.loads((outdir / ".lowcut_manifest.json").read_text())["done"]
    assert sorted(done) == sorted(files)
    stamps = {f: (outdir / Path(f).name).stat().st_mtime_ns for f in files}
    outs = _batch_processes(files, outdir, ["--resume"])
    assert not any("Processing file: " in o for o in outs), outs
    assert stamps == {f: (outdir / Path(f).name).stat().st_mtime_ns
                      for f in files}


@pytest.mark.parametrize("flags,message", [
    # Process 0 cannot open its store: the port is taken.
    (["--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
      "--process-id", "0"], ""),
    # Process 1 finds no coordinator before the join's time limit.
    (["--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
      "--process-id", "1"], ""),
    # No coordinator and no environment to read one from.
    (["--num-processes", "2", "--process-id", "1"], "MASTER_ADDR"),
])
def test_a_failed_join_exits_1_and_writes_nothing(tmp_path, capsys, monkeypatch,
                                                  flags, message):
    monkeypatch.setattr(distributed, "JOIN_TIMEOUT_S", 1.0)
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    files = _wavs(tmp_path, 2)
    outdir = tmp_path / "out"
    with socket.socket() as taken:
        # Bound but not listening: nothing can bind it, nothing connects.
        taken.bind(("127.0.0.1", 0))
        port = taken.getsockname()[1]
        argv = [a.format(port=port) for a in flags]
        assert main([*files, str(outdir), *argv, *CPU]) == 1
        err = capsys.readouterr().err
        assert err.strip() and message in err
        assert not outdir.exists()
        # One file to one file, too.
        out = tmp_path / "o.wav"
        assert main([files[0], str(out), *argv, *CPU]) == 1
        assert not out.exists()
    assert distributed.process_info() == (0, 1)      # the request was withdrawn
