"""The traffic generators repeat by seed, and every seed gets the same
sizes."""

import json
from pathlib import Path

import torch

from cardbench import inputs

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "hires96k-s24-high.json").read_text())
P = {"peak_dbfs": -6, "rumble_hz": 4}
BIG = 2**31 + 12345


def test_signal_repeats_by_seed_and_stays_under_its_peak():
    a = inputs.signal(BIG, (2, 50_000), 96000.0, P, "cpu")
    b = inputs.signal(BIG, (2, 50_000), 96000.0, P, "cpu")
    c = inputs.signal(BIG + 1, (2, 50_000), 96000.0, P, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == c.shape
    assert float(a.abs().max()) <= 10 ** (-6 / 20)
