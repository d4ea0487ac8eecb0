"""The control, the plain reference computed one step below the
configuration's precision, put in the program's place, comes out not
correct, where the program at the same inputs is correct. At the cells'
own sizes this runs on the card (``python3 -m cardbench.readings``); here
at a size a test run holds."""

import pytest

from cardbench import readings

from ._small import CELLS, SMALL


@pytest.mark.parametrize("seed", [11, 2**33 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, seed):
    r = readings.readings(cell, seed, 0.2, device="cpu", params=SMALL[cell])
    assert r["program_correct"] is True, r["program"]
    assert r["control_correct"] is False, r["control"]
    assert r["control"]["err_lsb"] > 2 * r["program"]["err_lsb"]


@pytest.mark.card
def test_a_cell_on_the_card():
    import json
    import subprocess
    import sys
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = Path(__file__).resolve().parents[2]
    got = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload",
                          "hires96k.device", "--seed", "2147483659", "--seconds", "2",
                          "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=900)
    assert got.returncode == 0, got.stderr[-4000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"] is True
