"""The port's pipelined batch (``pipeline/batch.py``), its manifest and the
CLI's batch scenario, on ``device='cpu'``.

The JAX package's tests/test_batch.py, ported: argument-order processing,
per-file checks at each file's turn, earlier files staying written after an
abort, duplicate names, the shared plan cache, the manifest — plus output
equality with the single-file path. Then the CLI's scenario 2 (its usage
errors, ``--resume``) and the port's own resume fingerprint.
"""

import json

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch import audio
from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.cli import main
from audio_fir_filter_tpu_torch.pipeline import process_file
from audio_fir_filter_tpu_torch.pipeline.batch import run_batch
from audio_fir_filter_tpu_torch.pipeline.manifest import (MANIFEST_NAME,
                                                          BatchManifest,
                                                          options_fingerprint)
from audio_fir_filter_tpu_torch.utils.errors import FileExists, FileNotFound
from audio_fir_filter_tpu_torch.utils.options import FilterOptions

FS = 8000.0
CPU = "cpu"
CLI = ["--device", "cpu", "--block-size", "1024", "-f", "100", "-s", "200",
       "--precision", "fast", "-t", "3"]


def opts(**kw):
    base = dict(freq=100.0, slope=200.0, precision="fast", block_size=1024,
                num_threads=3)
    base.update(kw)
    return FilterOptions(**base)


def wav(path, frames=3000, channels=1, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (channels, frames)).astype(np.float32)
    create_audio_file(path, x, FS, encoding=Encoding.PCM_16)
    return path


def batch(ins, dest, o, **kw):
    return run_batch(ins, dest, o, device=CPU, show_progress=False, **kw)


@pytest.mark.parametrize("engine", ["auto", "fourstep"])
def test_outputs_match_single_file_path(tmp_path, engine):
    ins = [wav(tmp_path / f"f{i}.wav", frames=2000 + 700 * i, seed=i)
           for i in range(4)]
    dest = tmp_path / "batch_out"
    dest.mkdir()
    batch(ins, dest, opts(engine=engine), overwrite=False)

    serial = tmp_path / "serial_out"
    serial.mkdir()
    for p in ins:
        process_file(p, serial / p.name, opts(engine=engine),
                     show_progress=False, device=CPU)
    for p in ins:
        a = audio.read_audio(dest / p.name)
        b = audio.read_audio(serial / p.name)
        np.testing.assert_array_equal(a.samples, b.samples)


def test_metrics_emitted_per_file_in_order(tmp_path):
    ins = [wav(tmp_path / f"m{i}.wav", seed=i) for i in range(5)]
    dest = tmp_path / "out"
    dest.mkdir()
    seen = []
    batch(ins, dest, opts(), metrics_cb=lambda m, d: seen.append((m, d)))
    # Writes may land out of order across 2 writer threads, but every file
    # reports exactly once with a complete metrics dict.
    assert sorted(d.name for _, d in seen) == sorted(p.name for p in ins)
    for m, _ in seen:
        for key in ("read", "design", "filter", "normalize", "write",
                    "frames", "channels", "sample_rate", "peak", "precision"):
            assert key in m


def test_collision_aborts_after_earlier_files_written(tmp_path):
    ins = [wav(tmp_path / f"c{i}.wav", seed=i) for i in range(3)]
    dest = tmp_path / "out"
    dest.mkdir()
    (dest / ins[1].name).write_bytes(b"occupied")  # collide on file #2
    with pytest.raises(FileExists):
        batch(ins, dest, opts(), overwrite=False)
    assert (dest / ins[0].name).exists()
    assert (dest / ins[1].name).read_bytes() == b"occupied"
    assert not (dest / ins[2].name).exists()


def test_missing_input_aborts_at_its_turn(tmp_path):
    first = wav(tmp_path / "ok.wav")
    dest = tmp_path / "out"
    dest.mkdir()
    with pytest.raises(FileNotFound):
        batch([first, tmp_path / "missing.wav"], dest, opts())
    assert (dest / "ok.wav").exists()


def test_duplicate_filenames_last_wins_with_overwrite(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    p1 = wav(d1 / "same.wav", seed=1)
    p2 = wav(d2 / "same.wav", seed=2)
    dest = tmp_path / "out"
    dest.mkdir()
    batch([p1, p2], dest, opts(), overwrite=True)
    got = audio.read_audio(dest / "same.wav")
    want = tmp_path / "want.wav"
    process_file(p2, want, opts(), show_progress=False, device=CPU)
    np.testing.assert_array_equal(got.samples,
                                  audio.read_audio(want).samples)


def test_manifest_skip_and_mark(tmp_path):
    ins = [wav(tmp_path / f"r{i}.wav", seed=i) for i in range(3)]
    dest = tmp_path / "out"
    dest.mkdir()
    o = opts()
    man = BatchManifest(dest, options_fingerprint(o, CPU))
    batch(ins, dest, o, manifest=man)
    assert all(man.is_done(p) for p in ins)

    # Second run skips everything: outputs untouched (compare mtimes).
    stamps = {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}
    man2 = BatchManifest(dest, options_fingerprint(o, CPU))
    batch(ins, dest, o, manifest=man2)
    assert stamps == {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}


def test_two_manifest_writers_keep_both_entries(tmp_path):
    """Two processes of one batch share the manifest: each constructed it
    before either wrote, and each marks its own file. The second write
    merges the first's entry instead of dropping it; an entry of other
    settings is not merged."""
    fp = options_fingerprint(opts(), CPU)
    a, b = BatchManifest(tmp_path, fp), BatchManifest(tmp_path, fp)
    a.mark_done("x.wav")
    b.mark_done("y.wav")
    a.mark_done("z.wav")
    data = json.loads((tmp_path / MANIFEST_NAME).read_text())
    assert data["options"] == fp
    assert sorted(data["done"]) == ["x.wav", "y.wav", "z.wav"]
    rerun = BatchManifest(tmp_path, fp)
    assert all(rerun.is_done(p) for p in ("x.wav", "y.wav", "z.wav"))
    other = BatchManifest(tmp_path, options_fingerprint(opts(freq=90.0), CPU))
    other.mark_done("w.wav")
    assert json.loads((tmp_path / MANIFEST_NAME).read_text())["done"] == {
        "w.wav": True}


def test_shared_plan_cache_across_batch(tmp_path, monkeypatch):
    """Files at one sample rate share one designed kernel: the plan is
    made once for the batch."""
    from audio_fir_filter_tpu_torch.ops import overlap_save as osv

    made = []
    real = osv.make_plan
    monkeypatch.setattr(osv, "make_plan",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    ins = [wav(tmp_path / f"s{i}.wav", seed=i) for i in range(4)]
    dest = tmp_path / "out"
    dest.mkdir()
    seen = []
    batch(ins, dest, opts(), metrics_cb=lambda m, d: seen.append(m))
    assert len(seen) == 4 and len(made) == 1


def test_manifest_engine_flip_not_skipped(tmp_path):
    """A resume that flips --engine must reprocess, not skip (the
    fingerprint holds the resolved engine)."""
    ins = [wav(tmp_path / "e0.wav", seed=3)]
    dest = tmp_path / "out"
    dest.mkdir()
    o1 = opts(engine="fourstep")
    man = BatchManifest(dest, options_fingerprint(o1, CPU))
    batch(ins, dest, o1, manifest=man)
    assert man.is_done(ins[0])

    o2 = opts(engine="pallas")
    assert options_fingerprint(o1, CPU) != options_fingerprint(o2, CPU)
    man2 = BatchManifest(dest, options_fingerprint(o2, CPU))
    assert not man2.is_done(str(ins[0]))  # fingerprint mismatch: fresh state


def test_fingerprint_covers_engine_and_device_and_is_the_ports_own():
    from audio_fir_filter_tpu.pipeline.manifest import \
        options_fingerprint as jax_fingerprint

    o = opts()
    fp = options_fingerprint(o, CPU)
    assert fp == options_fingerprint(opts(engine="pallas"), torch.device("cpu"))
    assert fp != options_fingerprint(opts(engine="stockham"), CPU)
    assert fp != options_fingerprint(o, "cuda")
    assert fp != options_fingerprint(opts(precision="high"), CPU)
    assert fp != options_fingerprint(opts(block_size=2048), CPU)
    assert fp != jax_fingerprint(o)
    assert json.loads(fp)[0] == "audio_fir_filter_tpu_torch"


def test_jax_manifest_does_not_make_the_port_skip(tmp_path):
    from audio_fir_filter_tpu.pipeline.manifest import \
        options_fingerprint as jax_fingerprint

    ins = [wav(tmp_path / "j.wav"), wav(tmp_path / "k.wav", seed=2)]
    dest = tmp_path / "out"
    dest.mkdir()
    jax_manifest = BatchManifest(dest, jax_fingerprint(opts()))
    for p in ins:
        jax_manifest.mark_done(p)
        (dest / p.name).write_bytes(b"stale")
    assert main([*map(str, ins), str(dest), "--resume", *CLI]) == 0
    for p in ins:
        assert (dest / p.name).read_bytes() != b"stale"


def test_cli_batch_and_resume_skip(tmp_path, capsys):
    ins = [wav(tmp_path / f"b{i}.wav", seed=i) for i in range(3)]
    dest = tmp_path / "new" / "dir"
    argv = [*map(str, ins), str(dest), "--resume", "--json-metrics", "-v", *CLI]
    assert main(argv) == 0
    out = capsys.readouterr()
    assert f"Creating directory: {dest}" in out.out
    assert sorted(json.loads(line)["file"] for line in out.err.splitlines()) \
        == sorted(str(dest / p.name) for p in ins)
    done = json.loads((dest / MANIFEST_NAME).read_text())["done"]
    assert sorted(done) == sorted(map(str, ins))

    stamps = {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}
    assert main(argv) == 0
    out = capsys.readouterr()
    assert out.out.count("Skipping (already done)") == 3 and not out.err
    assert stamps == {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}


def test_cli_batch_abort_then_resume_finishes_the_rest(tmp_path, capsys):
    a, c = wav(tmp_path / "a.wav", seed=1), wav(tmp_path / "c.wav", seed=3)
    late = tmp_path / "late.wav"
    dest = tmp_path / "out"
    argv = [str(a), str(late), str(c), str(dest), "--resume", "-v", *CLI]
    assert main(argv) == 1
    assert "not found" in capsys.readouterr().err.lower()
    assert (dest / "a.wav").exists() and not (dest / "c.wav").exists()
    assert sorted(json.loads((dest / MANIFEST_NAME).read_text())["done"]) \
        == [str(a)]

    wav(late, seed=2)
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "Skipping (already done): a.wav" in out
    assert "Processing file: late.wav" in out and "Processing file: c.wav" in out
    assert "Processing file: a.wav" not in out


def test_cli_batch_usage_errors(tmp_path, capsys):
    p = wav(tmp_path / "a.wav")
    q = wav(tmp_path / "b.wav", seed=2)
    assert main([str(p), str(q), str(p), *CLI]) == 1
    assert "not a directory" in capsys.readouterr().err
    assert main([str(p), str(q), str(tmp_path / "out.wav"), *CLI]) == 1
    assert "Undefined scenario" in capsys.readouterr().err
    assert not (tmp_path / "out.wav").exists()


def test_cli_batch_cuda_without_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, q = wav(tmp_path / "a.wav"), wav(tmp_path / "b.wav", seed=2)
    dest = tmp_path / "out"
    assert main([str(p), str(q), str(dest), "--engine", "fourstep"]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not dest.exists()


def test_cli_batch_existing_output_without_overwrite(tmp_path, capsys):
    p, q = wav(tmp_path / "a.wav"), wav(tmp_path / "b.wav", seed=2)
    dest = tmp_path / "out"
    dest.mkdir()
    (dest / "b.wav").write_bytes(b"occupied")
    assert main([str(p), str(q), str(dest), *CLI]) == 1
    assert "exists" in capsys.readouterr().err.lower()
    assert (dest / "a.wav").exists()
    assert (dest / "b.wav").read_bytes() == b"occupied"
    assert main([str(p), str(q), str(dest), "-O", *CLI]) == 0
    assert (dest / "b.wav").read_bytes() != b"occupied"
