"""The port's host layer (``audio/``, ``native/``, ``utils/``) against the
JAX package's modules of the same names, on the same NumPy inputs from a
seed: containers byte for byte, every encoding at both endiannesses
through the native and the NumPy codec, the read and write paths, the
normalize helpers, synthesis, options, error classes and the progress
bar. The two must agree exactly: the port's copies keep the behaviour."""

import dataclasses
import io
import os
import re
import threading
from pathlib import Path

import numpy as np
import pytest

import audio_fir_filter_tpu.audio as jaudio
import audio_fir_filter_tpu.audio.chunks as jchunks
import audio_fir_filter_tpu.audio.codec as jcodec
import audio_fir_filter_tpu.audio.file as jfile
import audio_fir_filter_tpu.audio.format as jformat
import audio_fir_filter_tpu.audio.synth as jsynth
import audio_fir_filter_tpu.utils.errors as jerrors
import audio_fir_filter_tpu.utils.options as joptions
import audio_fir_filter_tpu.utils.progress as jprogress
import audio_fir_filter_tpu_torch.audio as taudio
import audio_fir_filter_tpu_torch.audio.chunks as tchunks
import audio_fir_filter_tpu_torch.audio.codec as tcodec
import audio_fir_filter_tpu_torch.audio.file as tfile
import audio_fir_filter_tpu_torch.audio.format as tformat
import audio_fir_filter_tpu_torch.audio.synth as tsynth
import audio_fir_filter_tpu_torch.utils.errors as terrors
import audio_fir_filter_tpu_torch.utils.options as toptions
import audio_fir_filter_tpu_torch.utils.progress as tprogress
from audio_fir_filter_tpu_torch.native import pcm_codec as tpcm

REPO = Path(__file__).resolve().parent.parent

# (container kind, encoding name): every encoding each container writes.
CASES = [("wave", e) for e in ("PCM_U8", "PCM_16", "PCM_24", "PCM_32",
                                "FLOAT_32", "FLOAT_64")] + \
        [("aiff", e) for e in ("PCM_S8", "PCM_16", "PCM_24", "PCM_32")]


def samples(channels=2, frames=777, scale=0.9, seed=1234):
    return np.random.default_rng(seed).uniform(
        -scale, scale, (channels, frames)).astype(np.float32)


def extra(mod):
    return [mod.Chunk(b"JUNK", b"\x01\x02\x03"),            # odd size: pad byte
            mod.Chunk(b"uXyZ", bytes(range(16)))]


@pytest.fixture(params=["native", "numpy"])
def codec_path(request, monkeypatch):
    """Both packages on the native C++ codec, or both on the NumPy one."""
    if request.param == "numpy":
        for mod in (jcodec, tcodec):
            monkeypatch.setattr(mod, "_native", None)
            monkeypatch.setattr(mod, "_native_checked", True)
    else:
        assert tpcm.native_loaded(), "g++ failed to build the port's codec"
        assert jcodec._get_native() is not None
    return request.param


@pytest.mark.parametrize("kind,enc", CASES)
def test_container_and_codec_match_byte_for_byte(codec_path, kind, enc):
    x = samples(2, 333 if kind == "aiff" else 777)
    kj = jchunks.AIFF if kind == "aiff" else jchunks.WAVE
    kt = tchunks.AIFF if kind == "aiff" else tchunks.WAVE
    cj = jsynth.build_container(x, 48000, kj, jformat.Encoding[enc], extra(jchunks))
    ct = tsynth.build_container(x, 48000, kt, tformat.Encoding[enc], extra(tchunks))
    blob = jchunks.serialize_container(cj)
    assert tchunks.serialize_container(ct) == blob
    # Each parses the other's bytes and writes them back unchanged.
    back = tchunks.parse_container(blob)
    assert [c.ckid for c in back.chunks] == [c.ckid for c in cj.chunks]
    assert tchunks.serialize_container(back) == blob
    fj = jformat.format_from_container(cj)
    ft = tformat.format_from_container(back)
    assert (ft.channels, ft.sample_rate, ft.encoding.name, ft.big_endian_samples) \
        == (fj.channels, fj.sample_rate, fj.encoding.name, fj.big_endian_samples)
    payload = jfile._extract_sample_bytes(cj)
    dj = jcodec.decode(payload, fj)
    dt = tcodec.decode(tfile._extract_sample_bytes(back), ft)
    np.testing.assert_array_equal(dt, dj)
    assert bytes(tcodec.encode(dt, ft)) == bytes(jcodec.encode(dj, fj))


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("be", [False, True])
def test_native_codec_matches_the_jax_packages(bits, be):
    nj, nt = jcodec._get_native(), tcodec._get_native()
    assert nj is not None and nt is not None
    rng = np.random.default_rng(bits + be)
    x = rng.uniform(-1.2, 1.2, (3, 1009)).astype(np.float32)   # clips too
    x[:, 0] = 0.5 / (1 << (bits - 1))                           # half-LSB tie
    enc = nt.encode_planar(x, bits, be)
    assert bytes(enc) == bytes(nj.encode_planar(x, bits, be))
    raw = np.frombuffer(enc, dtype=np.uint8)
    np.testing.assert_array_equal(nt.decode_planar(raw, 3, bits, be),
                                  nj.decode_planar(raw, 3, bits, be))
    np.testing.assert_array_equal(nt.decode(raw, bits, be), nj.decode(raw, bits, be))
    assert nt.peak(x[0]) == nj.peak(x[0])


def test_native_codec_builds_under_build_not_in_the_package():
    assert tpcm.native_loaded()
    so = Path(tpcm._SO)
    assert so.is_file() and so.parent == REPO / "build" / "lowcut_torch"
    pkg = REPO / "audio_fir_filter_tpu_torch"
    assert not [p for p in pkg.rglob("*.so")], "a built library in the package"


def test_native_loaded_is_false_on_the_numpy_fallback(monkeypatch):
    monkeypatch.setenv("LOWCUT_NO_NATIVE", "1")
    assert tpcm.load() is None
    monkeypatch.setattr(tcodec, "_native", None)
    monkeypatch.setattr(tcodec, "_native_checked", False)
    assert tpcm.native_loaded() is False


@pytest.mark.parametrize("ext,enc", [(".wav", "PCM_16"), (".wav", "PCM_24"),
                                     (".wav", "FLOAT_32"), (".aif", "PCM_16"),
                                     (".aif", "PCM_24")])
@pytest.mark.parametrize("streamed", [False, True])
def test_files_read_and_write_alike(tmp_path, ext, enc, streamed):
    """create_audio_file, read_audio (whole and streamed) and write_audio
    with metadata chunks: the two packages' files are byte-identical."""
    x = samples(2, 500)
    meta_j, meta_t = (m.Chunk(b"bext", b"broadcast metadata\x00!")
                      for m in (jchunks, tchunks))
    pj, pt = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
    jsynth.create_audio_file(pj, x, 44100, encoding=jformat.Encoding[enc],
                             extra_chunks=[meta_j])
    tsynth.create_audio_file(pt, x, 44100, encoding=tformat.Encoding[enc],
                             extra_chunks=[meta_t])
    assert pt.read_bytes() == pj.read_bytes()
    limit = {"stream_threshold": 0} if streamed else {}
    dj, dt = jaudio.read_audio(pj, **limit), taudio.read_audio(pt, **limit)
    np.testing.assert_array_equal(dt.samples, dj.samples)
    assert (dt.num_channels, dt.num_frames, dt.kind) == \
        (dj.num_channels, dj.num_frames, dj.kind)
    half = dj.samples * np.float32(0.5)
    jaudio.write_audio(tmp_path / f"jo{ext}", dj, samples=half)
    taudio.write_audio(tmp_path / f"to{ext}", dt, samples=half.copy())
    assert (tmp_path / f"to{ext}").read_bytes() == (tmp_path / f"jo{ext}").read_bytes()


def test_aiff_ssnd_offset_survives_the_rewrite(tmp_path):
    x = samples(1, 50)
    c = tsynth.build_container(x, 44100, tchunks.AIFF, tformat.Encoding.PCM_16)
    idx = c.find_index(b"SSND")
    body = c.chunks[idx].data[8:]
    lead = b"\x00\x00\x00\x04\x00\x00\x00\x00\xde\xad\xbe\xef"
    c.chunks[idx] = tchunks.Chunk(b"SSND", lead + body)
    p = tmp_path / "t.aif"
    p.write_bytes(tchunks.serialize_container(c))
    for mod, name in ((taudio, "to.aif"), (jaudio, "jo.aif")):
        data = mod.read_audio(p)
        assert data.num_frames == 50
        mod.write_audio(tmp_path / name, data)
    assert (tmp_path / "to.aif").read_bytes() == (tmp_path / "jo.aif").read_bytes()
    out = tchunks.parse_container((tmp_path / "to.aif").read_bytes())
    assert out.find(b"SSND").data[:12] == lead


@pytest.mark.parametrize("rate", [8000.0, 22050.0, 44100.0, 96000.0, 192000.0])
def test_ext80_matches(rate):
    assert tformat._encode_ext80(rate) == jformat._encode_ext80(rate)
    assert tformat._decode_ext80(jformat._encode_ext80(rate)) == rate


@pytest.mark.parametrize("peak", [0.0, 0.37, 1.0, 2.5])
def test_scale_common_and_normalize_match(peak):
    x = samples(2, 301, scale=1.7, seed=9)
    np.testing.assert_array_equal(tfile._scale_common(x.copy(), peak),
                                  jfile._scale_common(x.copy(), peak))
    ro = x.copy()
    ro.flags.writeable = False            # a read-only array is copied
    np.testing.assert_array_equal(tfile._scale_common(ro, peak),
                                  jfile._scale_common(ro, peak))
    y = x * np.float32(peak)
    before = y.copy()
    np.testing.assert_array_equal(taudio.normalize(y), jaudio.normalize(y))
    np.testing.assert_array_equal(y, before)   # normalize never mutates


def test_parse_errors_raise_the_ports_own_class():
    for blob in (b"NOTATHING" + b"\x00" * 100, b"RIFF\x00\x00\x00\x00XXXX"):
        with pytest.raises(terrors.AudioFormatError) as e:
            tchunks.parse_container(blob)
        assert not isinstance(e.value, jerrors.DiskerrorError)
    with pytest.raises(terrors.FileNotFound):
        taudio.read_audio("/nonexistent/nope.wav")


@pytest.mark.parametrize("name", ["DiskerrorError", "FileNotFound",
                                  "FileExists", "UsageError",
                                  "AudioFormatError", "StopNoError"])
def test_error_classes_keep_their_exit_codes(monkeypatch, capsys, name):
    """Each class maps to the JAX package's exit code through the port's
    CLI (StopNoError 0, every other 1), and is the port's own class."""
    from audio_fir_filter_tpu import cli as jcli
    from audio_fir_filter_tpu_torch import cli as tcli

    arg = "x.wav" if name in ("FileNotFound", "FileExists") else "msg"
    rcs = []
    for cli, errors in ((tcli, terrors), (jcli, jerrors)):
        cls = getattr(errors, name)

        def boom(argv=None, cls=cls):
            raise cls(arg)

        monkeypatch.setattr(cli, "run", boom)
        rcs.append(cli.main([]))
    assert rcs[0] == rcs[1] == (0 if name == "StopNoError" else 1)
    assert getattr(terrors, name) is not getattr(jerrors, name)
    assert capsys.readouterr() is not None


def test_filter_options_and_precision_policy_match():
    assert dataclasses.asdict(toptions.FilterOptions()) == \
        dataclasses.asdict(joptions.FilterOptions())
    for n in (0, 3):
        assert toptions.FilterOptions(num_threads=n).resolved_num_threads() \
            == joptions.FilterOptions(num_threads=n).resolved_num_threads()
    for enc in tformat.Encoding:
        for p in ("auto", "high", "fast"):
            assert toptions.resolve_precision(p, enc) == \
                joptions.resolve_precision(p, jformat.Encoding[enc.name])


@pytest.mark.parametrize("steps", [[50], [10, 20, 35.5], [100, 1]])
def test_progress_bar_draws_alike(steps):
    outs = []
    for mod in (tprogress, jprogress):
        out = io.StringIO()
        bar = mod.ProgressBar(goal=100, bar_width=10, stream=out, enabled=True)
        for s in steps:
            bar.update(s)
        bar.set_progress(60)
        bar.final()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "[" + "=" * 11 + "]" in outs[0] and "100.0 %" in outs[0]


def test_threadsafe_progress_draws_monotone_totals():
    out = io.StringIO()
    total = 200_000
    bar = tprogress.ProgressBar(goal=total, bar_width=80, stream=out, enabled=True)
    tsp = tprogress.ThreadSafeProgress(bar, total)

    def worker():
        for _ in range(100):
            tsp.report(1000)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    pcts = [float(m) for m in re.findall(r"(\d+\.\d) %", out.getvalue())]
    assert pcts == sorted(pcts) and pcts[-1] == 100.0


def test_no_built_codec_next_to_the_source():
    assert not os.path.exists(REPO / "audio_fir_filter_tpu_torch" / "native"
                              / "_pcm_codec.so")
