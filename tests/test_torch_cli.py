"""The port's CLI (``audio_fir_filter_tpu_torch.cli``): the JAX package's
scenario checks, error texts and exit codes for two paths, ``--device``,
``--engine``, ``--profile``, and a UsageError for each path that is not
ported yet (the batch scenario has its own tests in test_torch_batch.py)."""

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


@pytest.mark.parametrize("extra,item", [
    (["--mesh", "1x2"], "parallel/ over NCCL"),
    (["--coordinator", "localhost:1234"], "parallel/ over NCCL"),
    (["--num-processes", "2"], "parallel/ over NCCL"),
    (["--process-id", "0"], "parallel/ over NCCL"),
])
def test_unported_paths_raise_usage_error(tmp_path, capsys, extra, item):
    p = wav(tmp_path, "a.wav")
    assert main([str(p), str(tmp_path / "b.wav"), *extra, *CPU]) == 1
    err = capsys.readouterr().err
    assert "not ported" in err and item in err and "ROADMAP.md" in err


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
