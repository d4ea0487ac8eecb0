"""A run of ``cd44k.pcm16`` with the timed path broken underneath comes out
not correct: the whole harness but its look for a card, on the CPU at a
small size, once for each fault the ``device_pcm16`` kind can have. A
sound run, quiet or hot, is correct."""

import contextlib
import io
import json

import pytest
import torch

from cardbench import run

CELL = "cd44k.pcm16"
SMALL = {"frames": 400_000}
HOT = {**SMALL, "peak_dbfs": 12}      # clipped input: outputs past the rails


def _run(params, seed=4294967311):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3",
                       "--trace", "0"], device="cpu", params=params)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()


def _fault(name: str, wrapped: list):
    """A stand-in for ``ops/segment_filter.segment_filter``: the real call,
    then the fault planted in what it returns. ``wrapped`` gets, per call
    of the ``wrap`` fault, whether the wrap changed any code."""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    real = sf.segment_filter

    def broken(x, plan, left, out_len, i16_io=False):
        y, peak = real(x, plan, left, out_len, i16_io)
        y = y.clone()
        if name == "unchanged":          # the filter hands its input back
            start = plan.mo2 - left
            y = x[:, start : start + out_len].clone()
        elif name == "channel":          # a channel zeroed
            y[1] = 0
        elif name == "code":             # one code off by 2
            y[0, out_len // 2] += 2
        elif name == "float32":          # the route quietly converted to float
            y = y.to(torch.float32) / 32768.0
        elif name == "wrap":             # int16 wrap-around in place of the clamp
            f, _ = sf.reference(x.to(torch.float32) / 32768.0, plan, left, out_len)
            w = torch.round(f.to(torch.float64) * 32768.0).to(torch.int32).to(torch.int16)
            wrapped.append(bool((w != y).any()))
            y = w
        elif name == "peak":             # a wrong peak
            return y, peak * 0.5
        top = y.to(torch.float32)
        return y, torch.maximum(top.max(), -top.min())

    return broken


@pytest.mark.parametrize("fault,params", [
    ("unchanged", SMALL), ("channel", SMALL), ("code", SMALL), ("float32", SMALL),
    ("wrap", HOT), ("peak", SMALL), ("peak", HOT)])
def test_fault_is_not_correct(fault, params, monkeypatch):
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    wrapped = []
    monkeypatch.setattr(sf, "segment_filter", _fault(fault, wrapped))
    rc, result, err = _run(params)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0
    if fault == "wrap":
        assert wrapped and all(wrapped)
    if fault == "float32":
        assert result["checks"]["err_lsb"]["value"] == "inf"
    if fault == "peak":
        assert result["checks"]["peak_not_max"]["value"] == 1


@pytest.mark.parametrize("params", [SMALL, HOT], ids=["quiet", "hot"])
def test_sound_run_is_correct(params):
    rc, result, err = _run(params, seed=2**31 + 5)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["err_lsb"]["value"] <= 0.6
