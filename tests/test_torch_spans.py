"""The port's spans (``utils/spans``) and the kernel counts kept beside the
launch counts: recording off and on, nesting and call ids under a
profiler, the bounded store, the spans of the segment wrapper and of the
pipeline's stages, and the kernels a segment call issues (shape
arithmetic, no card)."""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.models import LowCut
from audio_fir_filter_tpu_torch.ops import _build
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from audio_fir_filter_tpu_torch.pipeline import process_file
from audio_fir_filter_tpu_torch.pipeline.stream import filter_array_streamed_i16
from audio_fir_filter_tpu_torch.utils import spans
from audio_fir_filter_tpu_torch.utils.options import FilterOptions
from test_torch_pass1_ring import Pass1

STAGES = ("read", "design", "filter", "normalize", "write")


@pytest.fixture(autouse=True)
def _empty_store():
    spans.clear()
    yield
    spans.clear()


def _small_plan(precision="high"):
    return LowCut(freq=100.0, slope=200.0).plan(8000.0, precision=precision,
                                                block_size=1024, device="cpu")


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def no_record_function(*a, **k):
        raise AssertionError("recording is off: no record function")

    monkeypatch.setattr(spans, "_mark", no_record_function)
    plan = _small_plan()
    s = spans.span("filter")
    assert s is spans.NULL and not s
    with s as got:
        got.set(frames=3)
        got.end()
    assert got.seconds is None
    # A timed span measures all the same, and is not recorded.
    with spans.timed("stage.read") as t:
        pass
    assert t.seconds is not None and t.seconds >= 0
    osv.same_filter_peak(torch.zeros((2, 3000)), plan)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.recording(False):
            assert spans.span("filter") is spans.NULL
            osv.same_filter_peak(torch.zeros((2, 3000)), plan)
    assert spans.spans() == []


def test_spans_nest_under_a_profiler_and_show_in_its_trace(tmp_path):
    plan = _small_plan()
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (2, 3000))
                         .astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer") as outer:
            outer.set(tag=1)
            with spans.span("inner") as inner:
                inner.set(more=2)
        osv.same_filter_peak(x, plan)
        osv.extended_filter_peak(torch.zeros((1, 3000 + plan.m)), plan, 3000)
    got = spans.spans()
    assert [s["name"] for s in got] == ["inner", "outer", "filter", "filter"]
    s_in, s_out, f1, f2 = got
    assert s_out["parent"] is None and s_out["call"] == s_out["id"] == outer.id
    assert s_in["parent"] == s_out["id"] and s_in["call"] == s_out["id"]
    assert s_in["info"] == {"more": 2} and s_out["info"] == {"tag": 1}
    assert s_out["t0_ns"] <= s_in["t0_ns"] <= s_in["t1_ns"] <= s_out["t1_ns"]
    assert inner.seconds == pytest.approx((s_in["t1_ns"] - s_in["t0_ns"]) / 1e9)
    # Each filter call is a call of its own, with what it filtered.
    assert f1["parent"] is None and f1["call"] == f1["id"] != f2["call"]
    assert f1["info"] == {"engine": "pallas", "precision": "high", "channels": 2,
                          "frames": 3000, "sample_bytes": 4}
    assert f2["info"]["channels"] == 1 and f2["info"]["frames"] == 3000
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("name", "").startswith("lowcut.")]
    assert sorted(names) == ["lowcut.filter", "lowcut.filter", "lowcut.inner",
                             "lowcut.outer"]


def test_the_store_stays_bounded():
    with spans.recording():
        for _ in range(spans.MAX_SPANS + 5):
            with spans.span("s"):
                pass
        with spans.span("last"):
            pass
    got = spans.spans()
    assert len(got) == spans.MAX_SPANS
    assert got[-1]["name"] == "last"
    assert got[-1]["id"] - got[0]["id"] == spans.MAX_SPANS - 1   # the oldest went
    spans.clear()
    assert spans.spans() == []


@pytest.mark.parametrize("precision,fs,freq,frames,kernels", [
    ("high", 96000.0, 15.0, 345_600_000, 75),       # M = 38,400
    ("fast", 44100.0, 20.0, 158_760_000, 18),       # M = 17,640
])
def test_kernels_of_a_call_are_three_per_chunk_of_the_entry_loop(
        precision, fs, freq, frames, kernels):
    plan = LowCut(freq=freq, slope=10.0).plan(fs, precision=precision, device="cpu")
    assert plan.block_size == 1 << 18
    assert plan.m == {"high": 38_400, "fast": 17_640}[precision]
    pairs = sf.call_pairs(2, frames, plan.hop)
    chunk = sf.scratch_pairs(pairs, plan.block_size, plan.H.element_size())
    # The loop of run_split (csrc/segment_filter.cuh), as the C runs it.
    loop = len(range(0, pairs, chunk))
    assert sf.entry_chunks(pairs, chunk) == loop
    assert sf.KERNELS_PER_CHUNK * loop == kernels


class _FakeEntry:
    """A C entry point that records its arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if name.startswith("lowcut_"):
            return lambda *a: (self.calls.append((name, a)), self.rc)[1]
        raise AttributeError(name)


def _fake_card(monkeypatch, entry):
    monkeypatch.setattr(_build, "library", lambda lib: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())


def test_the_segment_wrapper_counts_and_spans_its_launch(monkeypatch):
    entry = _FakeEntry()
    _fake_card(monkeypatch, entry)
    monkeypatch.setattr(sf, "_SCRATCH_BYTES", 4 * 1024 * 8)    # 4 pairs a chunk
    asked = []
    monkeypatch.setattr(sf, "pass1_occupancy", lambda *a: (
        asked.append(a), {"resident_ctas": 12, "ring_depth": 2})[1])
    monkeypatch.setattr(sf, "pass2_occupancy", lambda *a: (
        asked.append(("pass 2", *a)), {"resident_ctas": 0, "ring_depth": 0})[1])
    monkeypatch.setattr(sf, "pass3_occupancy", lambda *a: (
        asked.append(("pass 3", *a)), {"resident_ctas": 0, "ring_depth": 0})[1])
    plan = _small_plan("fast")
    x = torch.zeros((2, 50_000))
    before = (dict(sf.launches), dict(sf.kernels))
    pairs = sf.call_pairs(2, 50_000, plan.hop)
    chunks = sf.entry_chunks(pairs, sf.scratch_pairs(pairs, plan.block_size, 8))
    with spans.recording():
        with spans.span("filter"):
            y, peak = sf._launch(x, plan, plan.mo2, 50_000, False)
    assert y.shape == (2, 50_000) and len(entry.calls) == 1
    name, args = entry.calls[0]
    assert name == "lowcut_segment_filter_f32"
    assert args[-2] == 4 and chunks == -(-pairs // 4) > 1
    assert sf.launches["f32"] == before[0]["f32"] + 1
    assert sf.kernels["f32"] == before[1]["f32"] + 3 * chunks
    assert {k: v for k, v in sf.kernels.items() if k != "f32"} == \
        {k: v for k, v in before[1].items() if k != "f32"}
    # A 32 x 32 complex64 table is read whole: nothing factored.
    assert not sf.twiddle_layout(plan.block_size, plan.H.dtype)["factored"]
    prep, launch, outer = spans.spans()
    assert (prep["name"], launch["name"], outer["name"]) == \
        ("segment.prepare", "segment.launch", "filter")
    assert prep["parent"] == launch["parent"] == outer["id"]
    assert prep["call"] == launch["call"] == outer["id"]
    assert prep["t1_ns"] <= launch["t0_ns"]
    assert prep["info"] == {"scratch_bytes": args[-2] * plan.block_size * 8}
    # B = 1024 is 32 x 32: pass 1 walks 4 tiles of 8 columns a pair and
    # cuts its grid to the resident CTAs, which the library reckons; the
    # span carries the split and the ring depths the library reports.
    assert Pass1("f32", 5, 5).tiles == 4
    assert asked == [("f32", plan.block_size, 0), ("pass 2", "f32", plan.block_size, 0),
                     ("pass 3", "f32", plan.block_size, 0)]
    assert launch["info"] == {"mode": "f32", "chunks": chunks, "kernels": 3 * chunks,
                              "log_n1": 5, "log_n2": 5, "pairs": pairs,
                              "chunk_pairs": 4, "pass1_ring": 2, "pass2_ring": 0,
                              "pass3_ring": 0}


@pytest.mark.parametrize("precision,i16", [("high", False), ("fast", False),
                                           ("fast", True)])
def test_the_launch_span_holds_only_what_the_host_decided_and_the_ring(
        monkeypatch, precision, i16):
    # In every mode: the kernel mode, the host's chunking and split, and
    # the ring depths of passes 1, 2 and 3 as the library reports them;
    # nothing of the compiled launch geometry.
    _fake_card(monkeypatch, _FakeEntry())
    for name in ("pass1_occupancy", "pass2_occupancy", "pass3_occupancy"):
        monkeypatch.setattr(sf, name, lambda *a: {"resident_ctas": 132, "ring_depth": 1})
    plan = _small_plan(precision)
    x = torch.zeros((2, 5000), dtype=torch.int16 if i16 else torch.float32)
    with spans.recording():
        sf._launch(x, plan, plan.mo2, 5000, i16)
    (launch,) = [s for s in spans.spans() if s["name"] == "segment.launch"]
    assert set(launch["info"]) == {"mode", "chunks", "kernels", "pairs", "chunk_pairs",
                                   "log_n1", "log_n2", "pass1_ring", "pass2_ring",
                                   "pass3_ring"}
    assert launch["info"]["mode"] == {("high", False): "f64", ("fast", False): "f32",
                                      ("fast", True): "i16"}[precision, i16]


@pytest.mark.parametrize("freq,slope,split,pairs,chunk,ring", [
    (15.0, 10.0, (9, 9), 6, 6, 2),        # hires96k: M = 38,400, B = 2^18
    (10.0, 5.0, (10, 9), 4, 4, 2),        # long96k: M = 76,800, B = 2^19
])
def test_the_launch_span_names_the_split_it_ran(monkeypatch, freq, slope, split,
                                                pairs, chunk, ring):
    # A CPU-built plan of a 96 kHz deployment, launched on a stand-in card:
    # the span gives the split, the pairs and the chunk and the ring depths
    # the occupancy queries report; the entry point gets the twiddle table of
    # twiddle_layout (the 4 MiB table at 2^18, the factor tables of 128 + 8
    # rows of 512 complex128 at 2^19).
    entry = _FakeEntry()
    _fake_card(monkeypatch, entry)
    for name in ("pass1_occupancy", "pass2_occupancy", "pass3_occupancy"):
        monkeypatch.setattr(sf, name, lambda *a: {"resident_ctas": 132, "ring_depth": ring})
    plan = LowCut(freq=freq, slope=slope).plan(96000.0, precision="high",
                                               device="cpu")
    assert sf.split(plan.block_size) == split
    x = torch.zeros((2, 1_000_000))
    with spans.recording():
        sf._launch(x, plan, plan.mo2, x.shape[1], False)
    long = split == (10, 9)
    (launch,) = [s for s in spans.spans() if s["name"] == "segment.launch"]
    info = launch["info"]
    assert (info["log_n1"], info["log_n2"]) == split
    assert (info["pairs"], info["chunk_pairs"], info["pass1_ring"],
            info["pass2_ring"], info["pass3_ring"]) == (pairs, chunk, ring, ring, ring)
    assert info["pairs"] == sf.call_pairs(2, x.shape[1], plan.hop)
    # Pass 1's items (pair, column tile) in the tests' model: 64 or 128
    # tiles a pair.
    assert pairs * Pass1("f64", *split).tiles == (512 if long else 384)
    layout = sf.twiddle_layout(plan.block_size, plan.H.dtype)
    assert layout["factored"] == long
    assert layout["bytes"] == (1_114_112 if long else 4_194_304)
    assert entry.calls[0][1][-2] == chunk
    # The table the entry point got is the one twiddle_layout names.
    tw4 = sf.kernel_tables(plan.block_size, plan.H.dtype, plan.H.device)[0]
    assert entry.calls[0][1][4] == tw4.data_ptr()
    assert tw4.nbytes == layout["bytes"]
    assert tw4.shape == ((136, 512) if long else (512, 512))


def test_a_failed_launch_raises_and_counts_nothing(monkeypatch):
    _fake_card(monkeypatch, _FakeEntry(rc=700))
    before = (dict(sf.launches), dict(sf.kernels))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sf._launch(torch.zeros((2, 5000)), _small_plan(), 0, 4000, False)
    assert (dict(sf.launches), dict(sf.kernels)) == before


@pytest.mark.parametrize("segment_len,frames", [(0, [5000]),
                                                (2 * 864, [1728, 1728, 1544])])
def test_the_16bit_route_records_a_filter_span_a_segment(segment_len, frames):
    plan = _small_plan("fast")
    assert plan.hop == 864
    x16 = np.random.default_rng(4).integers(-20000, 20000, (2, 5000),
                                             dtype=np.int16)
    with spans.recording():
        filter_array_streamed_i16(x16, plan, segment_len=segment_len)
    got = spans.spans()
    assert [s["name"] for s in got] == ["filter"] * len(frames)
    assert [s["info"] for s in got] == [
        {"engine": "pallas", "precision": "fast", "channels": 2, "frames": f,
         "sample_bytes": 2} for f in frames]


def _wav(path, seed=3):
    x = np.random.default_rng(seed).uniform(-0.5, 0.5, (2, 3000)).astype(np.float32)
    create_audio_file(path, x, 8000.0, encoding=Encoding.PCM_24)
    return path


@pytest.mark.parametrize("recorded", [True, False])
def test_the_stages_are_spans_read_under_their_keys(tmp_path, recorded):
    # process_file returns the stage seconds whether its spans are
    # recorded or not, as the JAX package's does.
    opts = FilterOptions(freq=100.0, slope=200.0, block_size=1024)
    with spans.recording(recorded):
        m = process_file(_wav(tmp_path / "in.wav"), tmp_path / "out.wav", opts,
                         show_progress=False, device="cpu")
    assert m["frames"] == 3000 and m["precision"] == "high"
    assert all(m[k] >= 0 for k in STAGES)
    got = spans.spans()
    if not recorded:
        assert got == []
        return
    by_name = {s["name"]: s for s in got}
    for k in STAGES:
        s = by_name[f"stage.{k}"]
        assert s["parent"] is None
        assert m[k] == pytest.approx((s["t1_ns"] - s["t0_ns"]) / 1e9)
    # The filter calls of the stream sit inside the filter stage.
    inner = [s for s in got if s["name"] == "filter"]
    assert inner and all(s["call"] == by_name["stage.filter"]["id"] for s in inner)


def test_recording_is_one_setting_for_every_thread():
    # Bodies that overlap across threads: off wins while one is open, and
    # the profiler's rule is back only when the last has ended.
    on, off = threading.Event(), threading.Event()
    seen = []

    def other():
        with spans.recording(True):
            on.set()
            off.wait(5)
            seen.append(spans.span("x") is spans.NULL)
        seen.append(spans.span("x") is spans.NULL)

    t = threading.Thread(target=other)
    t.start()
    on.wait(5)
    assert spans.span("x") is not spans.NULL
    with spans.recording(False):
        off.set()
        t.join(5)
        assert spans.span("x") is spans.NULL
    assert seen == [True, True]
    assert spans.span("x") is spans.NULL and spans._mode is None


def test_recording_from_many_threads_loses_no_update():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(200):
                with spans.recording(i % 2 == 0):
                    with spans.span("t"):
                        pass

        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert spans._forced == [0, 0] and spans._mode is None
    got = spans.spans()
    assert got and all(s["parent"] is None and s["call"] == s["id"] for s in got)
