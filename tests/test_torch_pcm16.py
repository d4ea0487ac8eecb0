"""The ``cd44k-s16-native`` deployment on the CPU: ``lowcut -f 20`` on
stereo 44.1 kHz 16-bit PCM, on the route every such file takes without
``-n``: int16 PCM into and out of the segment kernel's i16 mode, float32
arithmetic.

The port's plan for it (M = 17,640, B = 2^18, the split 512 x 512), the
scratch chunks a card-resident hour walks, the int16 input passing
through untouched, and the port's plain i16 path against the benchmark's
independent float64 reference quantized by the codec's rule
(``cardbench/reference``: its own Blackman design, a blocked FFT
convolution and ``pcm16``), on quiet input and on hot input whose output
reaches the rails."""

import json
from pathlib import Path

import pytest
import torch

from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.models import make_model
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from audio_fir_filter_tpu_torch.utils import spans
from audio_fir_filter_tpu_torch.utils.options import resolve_precision
from cardbench import inputs
from cardbench.reference import convolve, design, pcm16

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "cardbench" / "configs" / "cd44k-s16-native.json").read_text())
FS = 44100.0
FREQ, SLOPE = 20.0, 10.0
HOUR = 158_760_000          # 1 h at 44.1 kHz


@pytest.fixture(scope="module")
def plan():
    return make_model("lowcut", FREQ, SLOPE).plan(FS, precision="fast", device="cpu")


def test_auto_precision_is_fast_for_16_bit_output():
    assert resolve_precision("auto", Encoding.PCM_16) == "fast" == CONFIG["precision"]


def test_the_plan_takes_the_16_bit_route(plan):
    # M = ceil(4 / (10 / 44100)) = 17,640: 17,641 taps; B = 2^18 (the
    # floor for M >= 2^13), hop = B - M. The configuration's roofline
    # reads the same numbers from its file.
    assert (plan.m, plan.num_taps) == (17_640, 17_641)
    assert plan.m == design.order(SLOPE, FS)
    assert plan.block_size == 1 << 18 and plan.hop == 244_504
    assert (CONFIG["filter"]["num_taps"], CONFIG["block_size"], CONFIG["hop"]) == \
        (plan.num_taps, plan.block_size, plan.hop)
    assert CONFIG["cli"] == ["-f", "20"] and CONFIG["format"]["bits"] == 16
    assert osv.takes_i16(plan)
    assert plan.H.dtype == torch.complex64
    assert sf.split(plan.block_size) == (9, 9)
    assert sf.mode_of(plan, True) == "i16"


def test_the_hour_walks_6_chunks_of_128_pairs(plan):
    pairs = sf.call_pairs(2, HOUR, plan.hop)
    chunk = sf.scratch_pairs(pairs, plan.block_size, plan.H.element_size())
    # 650 hops a channel, 325 pairs; a 256 MiB scratch holds 128 complex64
    # pairs of 2^18 points.
    assert pairs == 650 and chunk == 128
    assert sf.entry_chunks(pairs, chunk) == len(range(0, pairs, chunk)) == 6


def test_int16_input_passes_through_untouched(plan):
    x16 = torch.zeros((2, 1000), dtype=torch.int16)
    got, squeeze = osv._as_input(x16, plan)
    assert got is x16 and not squeeze


def test_the_filter_span_says_two_bytes_a_sample(plan):
    x16 = torch.zeros((2, 3000), dtype=torch.int16)
    spans.clear()
    with spans.recording():
        y, _ = osv.same_filter_peak(x16, plan)
    (f,) = spans.spans()
    spans.clear()
    assert y.dtype == torch.int16
    assert f["info"] == {"engine": "pallas", "precision": "fast", "channels": 2,
                         "frames": 3000, "sample_bytes": 2}


def _codes(seed, peak_dbfs, frames=600_000):
    x = inputs.signal(seed, (2, frames), FS, {"peak_dbfs": peak_dbfs, "rumble_hz": 4},
                      "cpu")
    return pcm16.quantize(x).to(torch.int16)


@pytest.mark.parametrize("peak_dbfs,seed", [(-6, 1), (-6, 2**31 + 7), (-6, 5 * 10**9 + 3),
                                            (12, 3), (12, 2**33 + 1)])
def test_the_plain_i16_path_holds_the_quantized_reference(plan, peak_dbfs, seed):
    # Three hops of the cell's seeded signal as int16 codes: both signal
    # ends and two block seams. The guarantee is 1 LSB at 16 bits of the
    # float64 convolution of codes / 2^15, clamped to the rails; the
    # codec's rounding alone gives up to 0.5 of it. The peak is the max
    # |code| of the output itself, exactly, and within 1 LSB of the
    # quantized reference's. At +12 dBFS the input is clipped and the
    # output runs past the rails: the clamp, never a wrap, and a peak of
    # a rail.
    x16 = _codes(seed, peak_dbfs)
    assert -(-x16.shape[1] // plan.hop) == 3
    y, peak = osv.same_filter_peak(x16, plan)
    assert y.dtype == torch.int16 and y.shape == x16.shape
    want = torch.cat([c for _, _, c in convolve.same_fir_blocks(
        x16, design.lowcut_taps(FREQ, SLOPE, FS))], dim=1)
    err = float((y.to(torch.float64) - pcm16.rails(want)).abs().max())
    assert err <= 1.0, err
    assert float(peak) == pcm16.peak(y)
    assert abs(float(peak) - pcm16.peak(pcm16.quantize_codes(want))) <= 1.0
    hot = want.abs().max() > 32768
    assert bool(hot) == (peak_dbfs > 0)
    if hot:
        assert float(peak) >= 32767
        over = want > 32767
        assert (y[over] >= 32766).all()      # clamped at the rail, not wrapped
        under = want < -32768
        assert (y[under] <= -32767).all()
    else:
        assert float(peak) < 32767
    # The rumble is gone and the band kept: the output is not the input.
    assert int((y.to(torch.int32) - x16.to(torch.int32)).abs().max()) > 100
