"""The port's per-file pipeline and streaming (device='cpu') against the JAX
package's ``process_file`` and the float64 oracle.

Same synthesized WAVs through both (8 kHz, f = 100 Hz, s = 200 Hz,
B = 1024). Tolerances: each output within its gate of the oracle plus the
output quantization (0.5 LSB) — high: 1.0 + 0.5 LSB @ 24-bit for the port,
the JAX package's CPU tolerance for JAX; fast / 16-bit: 1.0 + 0.5 LSB @
16-bit — and the two packages within high_tol_lsb24() + 1.0 LSB @ 24-bit
or 1 LSB @ 16-bit of each other.
"""

import numpy as np
import pytest

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu.pipeline import process_file as jax_process_file
from audio_fir_filter_tpu.utils.options import FilterOptions as JaxOptions
from audio_fir_filter_tpu_torch import audio
from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.chunks import Chunk
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.pipeline import (filter_array_streamed,
                                                 filter_array_streamed_i16,
                                                 process_file)
from audio_fir_filter_tpu_torch.utils.options import FilterOptions

from util import high_tol_lsb24

FS = 8000.0
OPTS = dict(freq=100.0, slope=200.0, block_size=1024)
TAPS = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))


def make_input(tmp_path, name, encoding, frames=6000, scale=0.5, extra=()):
    rng = np.random.default_rng(42)
    x = rng.uniform(-scale, scale, (2, frames)).astype(np.float32)
    p = tmp_path / name
    create_audio_file(p, x, FS, encoding=encoding, extra_chunks=list(extra))
    return p


def run_both(tmp_path, src, **opts):
    kw = {**OPTS, **opts}
    outs, metrics = [], []
    for tag, fn, o, dev in (("torch", process_file, FilterOptions(**kw),
                             {"device": "cpu"}),
                            ("jax", jax_process_file, JaxOptions(**kw), {})):
        out = tmp_path / f"{tag}_{src.name}"
        metrics.append(fn(src, out, o, show_progress=False, **dev))
        outs.append(audio.read_audio(out))
    return outs, metrics


@pytest.mark.parametrize("encoding,bits", [(Encoding.PCM_24, 24),
                                           (Encoding.PCM_16, 16)])
def test_process_file_matches_jax_and_oracle(tmp_path, encoding, bits):
    meta = Chunk(b"bext", b"broadcast wav metadata blob\x00\x01")
    odd = Chunk(b"JUNK", b"xyz")  # odd-sized
    src = make_input(tmp_path, f"in{bits}.wav", encoding, extra=(meta, odd))
    (dt, dj), (mt, mj) = run_both(tmp_path, src)
    assert set(mt) == set(mj)
    assert mt["precision"] == mj["precision"] == ("high" if bits == 24 else "fast")
    assert mt["frames"] == 6000 and mt["channels"] == 2

    cin = audio.read_audio(src).container
    for d in (dt, dj):
        assert [c.ckid for c in d.container.chunks] == [c.ckid for c in cin.chunks]
        for a, b in zip(cin.chunks, d.container.chunks):
            if a.ckid != b"data":
                assert bytes(a.data) == bytes(b.data)

    xin = audio.read_audio(src).samples
    want = np.stack([oracle.direct_filter(xc, TAPS) for xc in xin])
    assert oracle.max_lsb_error(dt.samples, want, bits=bits) <= 1.5
    between = high_tol_lsb24() + 1.0 if bits == 24 else 1.0
    assert oracle.max_lsb_error(dt.samples, dj.samples, bits=bits) <= between
    assert mt["peak"] == pytest.approx(mj["peak"], abs=2.0 ** -(bits - 2))


def test_auto_normalize_on_clip_matches_jax(tmp_path):
    """A full-scale square wave overshoots after the high-pass: both
    packages normalize without -n and never write a clipped output."""
    t = np.arange(4000) / FS
    x = np.sign(np.sin(2 * np.pi * 300.0 * t)).astype(np.float32)[None, :] * 0.999
    for enc in (Encoding.PCM_24, Encoding.PCM_16):
        src = tmp_path / f"sq{enc.bits}.wav"
        create_audio_file(src, x, FS, encoding=enc)
        (dt, dj), (mt, mj) = run_both(tmp_path, src)
        assert mt["peak"] > 1.0 and mj["peak"] > 1.0
        assert mt["peak"] == pytest.approx(mj["peak"], rel=1e-5)
        for d in (dt, dj):
            assert np.max(np.abs(d.samples)) <= 1.0
        assert np.max(np.abs(dt.samples - dj.samples)) <= 2.0 ** -(enc.bits - 1)


def test_explicit_normalize(tmp_path):
    src = make_input(tmp_path, "quiet.wav", Encoding.PCM_16, scale=0.1)
    (dt, dj), _ = run_both(tmp_path, src, normalize=True)
    for d in (dt, dj):
        assert np.isclose(np.max(np.abs(d.samples)), 1.0, atol=2 ** -15)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_streamed_equals_single_call(precision):
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, 1024, "cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 20_000)).astype(np.float32)
    whole = osv.same_filter(x, plan).numpy()
    seg, peak = filter_array_streamed(x, plan, segment_len=plan.hop * 3)
    bits = 24 if precision == "high" else 16
    assert oracle.max_lsb_error(seg, whole, bits=bits) <= 1.0
    assert peak == pytest.approx(float(np.abs(whole).max()), rel=1e-6)
    # The last segment is short: its peak covers only real samples.
    seg1, peak1 = filter_array_streamed(x[:, :-5], plan,
                                        segment_len=plan.hop * 3)
    assert peak1 == pytest.approx(float(np.abs(seg1).max()), rel=1e-6)


def test_streamed_i16_multi_segment_equals_single_call():
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, "fast", 1024, "cpu")
    x = np.random.default_rng(5).uniform(-0.7, 0.7, (2, 9_001))
    x16 = np.rint(x * 32768).astype(np.int16)
    one, p1, s1 = filter_array_streamed_i16(x16, plan)
    seg, p2, s2 = filter_array_streamed_i16(x16, plan, segment_len=plan.hop * 2)
    assert np.abs(one.astype(np.int32) - seg.astype(np.int32)).max() <= 1
    assert abs(p1 - p2) <= 1 and not s1 and not s2
    want = np.stack([oracle.direct_filter(xc / 32768.0, ws.taps) for xc in x16])
    assert oracle.max_lsb_error(seg / 32768.0, want, bits=16) <= 1.0


def test_streamed_i16_rejects_plans_it_cannot_run():
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    x16 = np.zeros((2, 100), np.int16)
    high = osv.make_plan(ws.taps, "high", 1024, "cpu")
    with pytest.raises(ValueError, match="'fast' plan"):
        filter_array_streamed_i16(x16, high)
    with pytest.raises(TypeError):
        filter_array_streamed_i16(
            x16.astype(np.float32), osv.make_plan(ws.taps, "fast", 1024, "cpu"))
