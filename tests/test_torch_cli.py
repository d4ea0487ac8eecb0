"""The port's CLI (``audio_fir_filter_tpu_torch.cli``): the JAX package's
scenario checks, error texts and exit codes for two paths, ``--device``,
``--engine``, ``--profile`` and ``--mesh`` (the batch scenario has its own
tests in test_torch_batch.py, the multi-process flags theirs in
test_torch_distributed.py)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu_torch import audio
from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.cli import main

FS = 8000.0
CPU = ["--device", "cpu", "--block-size", "1024", "-f", "100", "-s", "200"]
REPO = Path(__file__).resolve().parent.parent


def wav(tmp_path, name, frames=3000):
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (1, frames)).astype(np.float32)
    p = tmp_path / name
    create_audio_file(p, x, FS, encoding=Encoding.PCM_16)
    return p


def test_single_file_success(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "b.wav"
    assert main([str(p), str(out), "-v", *CPU]) == 0
    text = capsys.readouterr().out
    assert "Processing file: a.wav" in text and "Filtering." in text
    taps = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))
    ref = oracle.direct_filter(audio.read_audio(p).samples[0], taps)
    assert oracle.max_lsb_error(audio.read_audio(out).samples[0], ref,
                                bits=16) <= 1.0


def test_help_exits_zero(capsys):
    assert main(["--help"]) == 0
    text = capsys.readouterr().out
    assert "low-cut" in text and "lowcut" in text and "--device" in text


def test_too_few_args_exit_1(capsys):
    assert main(["only_one_arg.wav"]) == 1
    assert "Invalid number of parameters" in capsys.readouterr().err


def test_missing_input_exit_1(tmp_path, capsys):
    assert main([str(tmp_path / "no.wav"), str(tmp_path / "o.wav")]) == 1
    assert "not found" in capsys.readouterr().err.lower()


def test_extension_mismatch_error(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    assert main([str(p), str(tmp_path / "b.aif")]) == 1
    assert "extensions must match" in capsys.readouterr().err


def test_file_exists_without_overwrite(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = wav(tmp_path, "b.wav")
    before = out.read_bytes()
    assert main([str(p), str(out), *CPU]) == 1
    assert "exists" in capsys.readouterr().err.lower()
    assert out.read_bytes() == before
    assert main([str(p), str(out), "-O", *CPU]) == 0
    assert out.read_bytes() != before


def test_output_is_directory_error(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    (tmp_path / "d").mkdir()
    assert main([str(p), str(tmp_path / "d")]) == 1
    assert "must be a file path" in capsys.readouterr().err


def test_cuda_without_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "b.wav"
    assert main([str(p), str(out)]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not out.exists()


def _mesh_case(tmp_path, encoding, frames=9000):
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (2, frames)).astype(np.float32)
    p = tmp_path / "m.wav"
    create_audio_file(p, x, FS, encoding=encoding)
    plain = tmp_path / "plain.wav"
    assert main([str(p), str(plain), *CPU]) == 0
    return p, plain


@pytest.mark.parametrize("encoding", [Encoding.PCM_24, Encoding.PCM_16])
def test_mesh_1x1_is_the_single_device_byte_for_byte(tmp_path, encoding):
    """``--mesh 1x1`` takes the same route as no ``--mesh`` (the
    16-bit-native route included), so the files are identical."""
    p, plain = _mesh_case(tmp_path, encoding)
    out = tmp_path / "mesh.wav"
    assert main([str(p), str(out), "--mesh", "1x1", *CPU]) == 0
    assert out.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("mesh", ["1x8", "1x2", "2x4", "2X2"])
def test_mesh_on_cpu_cells_equals_the_unsharded_output(tmp_path, mesh):
    """``--mesh DxT --device cpu`` runs on D*T CPU cells; a 24-bit file
    comes out within 1 LSB @ 24-bit of the unsharded output (``high`` is
    float64: the same samples unless a rounding tie falls the other way)."""
    p, plain = _mesh_case(tmp_path, Encoding.PCM_24)
    out = tmp_path / "mesh.wav"
    assert main([str(p), str(out), "--mesh", mesh, *CPU]) == 0
    got, ref = audio.read_audio(out), audio.read_audio(plain)
    assert got.samples.shape == ref.samples.shape == (2, 9000)
    assert oracle.max_lsb_error(got.samples, ref.samples, bits=24) <= 1.0
    taps = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))
    x = audio.read_audio(p).samples
    want = np.stack([oracle.direct_filter(xi, taps) for xi in x])
    assert oracle.max_lsb_error(got.samples, want, bits=24) <= 1.0


def test_a_larger_mesh_filters_a_16bit_file_in_float32(tmp_path, monkeypatch):
    """Under a mesh larger than 1x1 the 16-bit-native route is not taken
    (as in the JAX package): the file is filtered in float32 and the codec
    rounds, so a sample may differ from the single-device output by a
    rounding tie, never by more than 1 LSB @ 16-bit."""
    import importlib

    pf = importlib.import_module("audio_fir_filter_tpu_torch.pipeline.process_file")
    p, plain = _mesh_case(tmp_path, Encoding.PCM_16)

    def no_i16(*a, **k):
        raise AssertionError("the 16-bit-native route ran under a mesh")

    monkeypatch.setattr(pf, "filter_array_streamed_i16", no_i16)
    out = tmp_path / "mesh.wav"
    assert main([str(p), str(out), "--mesh", "1x2", *CPU]) == 0
    got, ref = audio.read_audio(out).samples, audio.read_audio(plain).samples
    assert oracle.max_lsb_error(got, ref, bits=16) <= 1.0
    # ... while 1x1 does take it.
    assert main([str(p), str(out), "-O", "--mesh", "1x1", *CPU]) == 1


@pytest.mark.parametrize("spec", ["banana", "1x", "0x2", "2x-1", "1x2x3", "x"])
def test_mesh_rejects_a_malformed_shape(tmp_path, capsys, spec):
    p = wav(tmp_path, "a.wav")
    assert main([str(p), str(tmp_path / "b.wav"), "--mesh", spec, *CPU]) == 1
    assert f"--mesh expects DxT (e.g. 1x8), got {spec!r}" in capsys.readouterr().err
    assert not (tmp_path / "b.wav").exists()


def test_mesh_of_more_cells_than_cards_raises(monkeypatch):
    """On ``--device cuda`` the mesh is made of this process's cards, and
    never of the CPU in their place: ``1x2`` with one card names 2 devices
    against 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    from audio_fir_filter_tpu_torch.parallel import local_devices, make_mesh

    assert local_devices("cuda", 2) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match=r"mesh shape \(1, 2\) needs 2 devices, "
                                         "have 1"):
        make_mesh((1, 2), local_devices("cuda", 2))
    assert local_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_mesh_batch_runs_the_serial_loop_with_resume(tmp_path, capsys):
    """A batch under a mesh: the serial per-file loop, its manifest and its
    checks."""
    a, b = wav(tmp_path, "a.wav"), wav(tmp_path, "b.wav", frames=5000)
    dest = tmp_path / "out"
    argv = [str(a), str(b), str(dest), "--mesh", "1x4", "--resume", "-v", *CPU]
    assert main(argv) == 0
    assert "Processing file: b.wav" in capsys.readouterr().out
    plain = tmp_path / "plain"
    assert main([str(a), str(b), str(plain), *CPU]) == 0
    for name in ("a.wav", "b.wav"):
        got = audio.read_audio(dest / name).samples
        ref = audio.read_audio(plain / name).samples
        assert oracle.max_lsb_error(got, ref, bits=16) <= 1.0
    stamps = {n: (dest / n).stat().st_mtime_ns for n in ("a.wav", "b.wav")}
    capsys.readouterr()
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert "Skipping (already done): a.wav" in text and "Processing" not in text
    assert stamps == {n: (dest / n).stat().st_mtime_ns for n in stamps}
    # Without --resume or -O an existing output is an error, as in the batch.
    assert main([str(a), str(b), str(dest), "--mesh", "1x4", *CPU]) == 1
    assert "exists" in capsys.readouterr().err.lower()
    assert main([str(a), str(tmp_path / "no.wav"), str(tmp_path / "o2"),
                 "--mesh", "1x4", *CPU]) == 1
    assert "not found" in capsys.readouterr().err.lower()


def test_the_resume_fingerprint_carries_a_mesh_larger_than_1x1():
    from audio_fir_filter_tpu_torch.pipeline.manifest import options_fingerprint
    from audio_fir_filter_tpu_torch.utils.options import FilterOptions

    def fp(mesh):
        return options_fingerprint(FilterOptions(mesh_shape=mesh), "cpu")

    assert fp(None) == fp((1, 1))            # the same bytes: one fingerprint
    assert len({fp(None), fp((1, 2)), fp((2, 1)), fp((1, 4))}) == 4
    assert json.loads(fp((2, 4)))[-1] == [2, 4]


def _trace_names(path):
    trace = json.loads(path.read_text())
    return {e.get("name", "") for e in trace["traceEvents"]}


@pytest.mark.parametrize("engine", ["auto", "fourstep"])
def test_profile_writes_a_chrome_trace(tmp_path, capsys, engine):
    p = wav(tmp_path, "a.wav")
    prof = tmp_path / "prof" / "run1"
    assert main([str(p), str(tmp_path / "b.wav"), "--profile", str(prof),
                 "--engine", engine, "-v", *CPU]) == 0
    assert f"Profiling to {prof} (torch.profiler trace)." in capsys.readouterr().out
    names = _trace_names(prof / "trace.json")
    # The plain versions' FFTs ran inside the traced window.
    assert any("fft" in n for n in names), sorted(names)[:20]
    # The program's spans: each stage of the file.
    assert {f"lowcut.stage.{k}" for k in ("read", "design", "filter", "normalize",
                                          "write")} <= names


def test_profile_trace_is_written_on_the_error_path(tmp_path, capsys):
    prof = tmp_path / "prof"
    argv = [str(tmp_path / "missing.wav"), str(tmp_path / "b.wav"),
            "--profile", str(prof), *CPU]
    assert main(argv) == 1
    assert "not found" in capsys.readouterr().err.lower()
    assert "traceEvents" in json.loads((prof / "trace.json").read_text())


@pytest.mark.parametrize("engine", ["auto", "pallas", "fourstep", "pease",
                                    "stockham"])
def test_engine_choices_filter_within_the_gate(tmp_path, engine):
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "b.wav"
    assert main([str(p), str(out), "--engine", engine, *CPU]) == 0
    taps = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))
    ref = oracle.direct_filter(audio.read_audio(p).samples[0], taps)
    assert oracle.max_lsb_error(audio.read_audio(out).samples[0], ref,
                                bits=16) <= 1.0


def test_engine_rejects_unknown_names(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    assert main([str(p), str(tmp_path / "b.wav"), "--engine", "cufft", *CPU]) == 1
    assert "invalid choice" in capsys.readouterr().err
    assert not (tmp_path / "b.wav").exists()


def test_engine_fourstep_cuda_without_card_exits_1(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "b.wav"
    assert main([str(p), str(out), "--engine", "fourstep",
                 "--device", "cuda"]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not out.exists()


def test_band_filter_checks(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    o = str(tmp_path / "o.wav")
    assert main([str(p), o, "--filter", "bandpass", *CPU]) == 1
    assert "--frequency-high" in capsys.readouterr().err
    assert main([str(p), o, "--filter", "bandreject", "-F", "50", *CPU]) == 1
    assert "must exceed" in capsys.readouterr().err
    assert main([str(p), o, "-F", "500", *CPU]) == 1
    assert "only applies" in capsys.readouterr().err


def test_launcher_help_subprocess():
    r = subprocess.run([sys.executable, str(REPO / "bin" / "lowcut-torch"),
                        "--help"], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "lowcut" in r.stdout
