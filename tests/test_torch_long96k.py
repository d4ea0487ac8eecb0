"""The ``long96k-s24-high`` deployment on the CPU: ``lowcut -f 10 -s 5`` on
96 kHz stereo 24-bit audio, float64 on the card (``high``).

The port's plan for it (M = 76,800, B = 2^19, the four-step split
1024 x 512), the scratch chunks a card-resident hour walks, and the
port's plain path at that plan against the benchmark's independent
float64 reference (``cardbench/reference``: its own Blackman design and
a blocked FFT convolution)."""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch.models import make_model
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from cardbench import inputs
from cardbench.reference import convolve, design
from test_torch_pass1_ring import Pass1

FS = 96000.0
FREQ, SLOPE = 10.0, 5.0
HOUR = 345_600_000          # 1 h at 96 kHz
BITS = 24


@pytest.fixture(scope="module")
def plan():
    return make_model("lowcut", FREQ, SLOPE).plan(FS, precision="high", device="cpu")


def test_the_plan_is_the_long_split(plan):
    # M = ceil(4 / (5 / 96000)) = 76,800, even: 76,801 taps. B is the
    # smallest power of two >= 4 M, 2^19; hop = B - M.
    assert (plan.m, plan.num_taps) == (76_800, 76_801)
    assert plan.m == design.order(SLOPE, FS)
    assert plan.block_size == 1 << 19 == osv.choose_block_size(76_801)
    assert plan.hop == 447_488
    assert plan.engine == osv.PALLAS and plan.H.dtype == torch.complex128
    assert sf.split(plan.block_size) == (10, 9)
    assert sf.split_shape(plan.block_size) == tuple(plan.H.shape) == (1024, 512)
    assert sf.qualifies(plan.num_taps, plan.block_size)
    # Pass 1: 512 columns in tiles of 4 (1024-point columns, 512 threads).
    assert Pass1("f64", *sf.split(plan.block_size)).tiles == 128


def test_the_hour_walks_25_chunks_of_32_pairs(plan):
    pairs = sf.call_pairs(2, HOUR, plan.hop)
    chunk = sf.scratch_pairs(pairs, plan.block_size, plan.H.element_size())
    # 773 hops a channel, 387 pairs; a 256 MB scratch holds 32 complex128
    # pairs of 2^19 points.
    assert pairs == 774 and chunk == 32
    assert sf.entry_chunks(pairs, chunk) == len(range(0, pairs, chunk)) == 25
    assert chunk * plan.block_size * plan.H.element_size() == 256 << 20


def test_the_plain_path_holds_the_float64_reference(plan):
    # Three hops of the cell's seeded signal: both signal ends and two
    # block seams at the long kernel. The configuration's guarantee is
    # 1 LSB at 24 bits of the float64 convolution; the port's float32
    # output alone rounds by up to half an ulp (1/8 LSB@24 below 0.5), so
    # the bound is the guarantee itself, for every sample and the peak.
    params = {"peak_dbfs": -6, "rumble_hz": 4}
    x = inputs.signal(2**31 + 17, (2, 1_000_000), FS, params, "cpu")
    assert -(-x.shape[1] // plan.hop) == 3
    y, peak = osv.same_filter_peak(x, plan)
    taps = design.lowcut_taps(FREQ, SLOPE, FS)
    want = convolve.same_fir(x, taps)
    assert y.dtype == torch.float32 and y.shape == x.shape
    lsb = float(1 << (BITS - 1))
    err = float((y.to(torch.float64) - want).abs().max()) * lsb
    assert err <= 1.0, err
    assert abs(float(peak) - float(want.abs().max())) * lsb <= 1.0
    # The rumble is gone and the band kept: the output is not the input.
    assert float((y - x).abs().max()) > 0.01
    np.testing.assert_array_less(float(y.abs().max()), 1.0)
