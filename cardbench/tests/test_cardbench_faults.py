"""A run with the timed path broken underneath comes out not correct: the
whole harness but its look for a card, on the CPU at a small size, once
for each fault a cell can have (one card: no exchange between cards to
leave out)."""

import pytest
import torch

from ._small import CELLS, run_cell


def _fault(name: str):
    """A stand-in for ``ops/segment_filter.segment_filter``: the real call,
    then the fault planted in what it returns."""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    real = sf.segment_filter

    def broken(x, plan, left, out_len, i16_io=False):
        y, peak = real(x, plan, left, out_len, i16_io)
        y = y.clone()
        if name == "unchanged":        # the filter hands its input back
            start = plan.mo2 - left
            y = x[:, start : start + out_len].clone()
            peak = y.abs().max().to(torch.float32)
        elif name == "half":           # half the rows left out
            y[y.shape[0] // 2 :] = 0
        elif name == "altered":        # one answer altered where it is made
            y[0, out_len // 2] += 300 if i16_io else 1e-2
        return y, peak

    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    monkeypatch.setattr(sf, "segment_filter", _fault(fault))
    rc, result, _, err = run_cell(cell)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rc, result, _, err = run_cell(cell, seed=2**31 + 5)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]


def test_wrong_peak_is_not_correct(monkeypatch):
    """The device cell's peak is an answer of its own."""
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    real = sf.segment_filter

    def broken(x, plan, left, out_len, i16_io=False):
        y, peak = real(x, plan, left, out_len, i16_io)
        return y, peak * 0.5

    monkeypatch.setattr(sf, "segment_filter", broken)
    rc, result, _, err = run_cell("hires96k.device")
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
