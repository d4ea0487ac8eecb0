"""The cell ``cd44k.pcm16`` (``lowcut -f 20`` on 16-bit PCM, the route
int16 into and out of the segment kernel's i16 mode) and its two readers:
its entries in ``BENCHMARK.json`` and its files, the cell on the CPU at a
small size, the control failing where the program passes, and the readers
on a synthetic trace whose launch spans say i16, f32 or no mode."""

import contextlib
import io
import json
from pathlib import Path

import pytest

from cardbench import readings, run
from cardbench.layer_metrics import (_program_spans, kernel_pcm16_roofline_share,
                                     kernel_roofline_share, segment_pcm16_cols_us_per_pair)
from cardbench.record import Record
from cardbench.reference import design
from cardbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "cd44k.pcm16"
SMALL = {"frames": 400_000}
READERS = {"kernel.pcm16_roofline_share", "segment.pcm16_cols_us_per_pair"}


def _run(trace=0, seed=4294967311, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", params=SMALL)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()


def test_the_entries_and_the_configuration():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("cd44k-s16-native", "pcm16_hour_on_card", 1)
    (c,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == [] and len(c["source"]) <= 200
    cfg = json.loads((ROOT / c["file"]).read_text())
    f = cfg["filter"]
    assert cfg["cli"] == ["-f", "20"] and cfg["precision"] == "fast"
    assert cfg["format"] == {"container": "wave", "sample_rate": 44100, "bits": 16}
    m = design.order(f["slope_hz"], cfg["format"]["sample_rate"])
    assert f["num_taps"] == m + 1 == 17_641
    assert (cfg["block_size"], cfg["hop"]) == (1 << 18, (1 << 18) - m)
    cell = run.load_cell(CELL)
    assert cell["workload"]["kind"] == "device_pcm16"
    assert cell["workload"]["params"] == {"channels": 2, "frames": 158_760_000,
                                          "peak_dbfs": -6, "rumble_hz": 4}
    assert cell["workload"]["limits"] == {"err_lsb": 1.0, "peaks_differ": 0,
                                          "peak_not_max": 0}
    assert {m["name"] for m in cell["end_to_end"]} >= {"samples_per_s", "setup_s"}
    assert "call_p95_ms" not in {m["name"] for m in cell["end_to_end"]}
    assert {m["name"] for m in cell["per_layer"]} >= READERS
    for m in BENCH["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "samples_per_s"


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu(trace):
    rc, result, err = _run(trace)
    assert rc == 0, err
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == want + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert {k: v["limit"] for k, v in result["checks"].items()} == \
        {"err_lsb": 1.0, "peaks_differ": 0, "peak_not_max": 0}
    # The codec's rounding alone is half an LSB.
    assert 0.5 <= result["checks"]["err_lsb"]["value"] <= 0.6
    if trace:
        # A CPU run launches no kernel: the device readers read nothing.
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"samples_per_s", "setup_s"}
        assert result["metrics"]["samples_per_s"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 2**33 + 1])
def test_control_fails_where_the_program_passes(seed):
    r = readings.readings(CELL, seed, 0.2, device="cpu", params=SMALL)
    assert r["control_precision"] == "bfloat16"
    assert r["program_correct"] is True, r["program"]
    assert r["control_correct"] is False, r["control"]
    assert r["control"]["err_lsb"] > 10 * r["program"]["err_lsb"]


@pytest.mark.parametrize("ref,codes,want", [
    ([100.49, -3.2, 7.0], [101, -3, 7], 0.51),          # the largest on a boundary
    ([32767.8, -32768.4, 5.0], [32767, -32768, 5], 0.0),  # both rails
])
def test_the_peak_is_judged_against_the_unrounded_reference(monkeypatch, ref, codes,
                                                            want):
    # A sound answer: float32 arithmetic lands the largest value, 100.49
    # codes in float64, a little past the rounding boundary and writes 101,
    # 0.51 LSB off, and the peak is that code. Against the rounded
    # reference's peak (100) it would read a whole LSB; against the
    # reference clamped to the rails, as every code is, it reads 0.51.
    from types import SimpleNamespace

    import torch

    from cardbench.reference import convolve
    from cardbench.traffic import device_pcm16

    c = torch.tensor([ref], dtype=torch.float64)
    monkeypatch.setattr(convolve, "same_fir_blocks",
                        lambda x, taps, precision="float64": iter([(0, 3, c)]))
    cell = run.load_cell(CELL)
    ctx = SimpleNamespace(cfg=cell["config"], limits=cell["workload"]["limits"])
    y = torch.tensor([codes], dtype=torch.int16)
    peak = float(max(abs(v) for v in codes))
    nums, failed = device_pcm16.check(ctx, {"x": torch.zeros((1, 3), dtype=torch.int16)},
                                      {"y": y, "peaks": torch.tensor([peak, peak])})
    assert nums["err_lsb"] == pytest.approx(want, abs=1e-9)
    assert (nums["peaks_differ"], nums["peak_not_max"], failed) == (0, 0, 0)


# A synthetic traced window: one harness filter span on the trace's clock
# at 100-600 us, the program's spans on a host clock 20 s ahead, and one
# launch of three passes at the split 512 x 512, 6 pairs.
OFFSET_US = 20_000_000.0
NAMES = {1: "void (anonymous namespace)::fill<float>",
         2: "void (anonymous namespace)::cols_forward<float, short, Split<9, 9> >",
         3: "void (anonymous namespace)::rows_multiply<float, Split<9, 9> >",
         4: "void (anonymous namespace)::cols_inverse<float, short, Split<9, 9> >"}


def _record():
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"cardbench.{n}", "ts": t,
           "dur": d} for n, t, d in [("window#1", 0, 1000), ("filter#2", 100, 500)]]
    for corr, launch, start, dur in [(1, 150, 160, 5), (2, 220, 300, 24),
                                     (3, 230, 330, 12), (4, 240, 370, 30)]:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": NAMES[corr], "ts": start,
                   "dur": dur, "args": {"correlation": corr}})
    rec = Record({"block_size": 1 << 18, "hop": 244_504, "precision": "fast"})
    rec.trace = Trace(ev)
    rec.spans = [{"name": "filter", "id": 2, "label": "cardbench.filter#2",
                  "t0": (100 + OFFSET_US) / 1e6, "t1": (600 + OFFSET_US) / 1e6,
                  "channels": 2, "frames": 1_000_000, "sample_bytes": 2}]
    return rec


def _program(fields):
    def ns(us):
        return round((us + OFFSET_US) * 1e3)

    info = {"chunks": 1, "kernels": 3, "log_n1": 9, "log_n2": 9, "pairs": 6,
            "chunk_pairs": 6, "pass1_ring": 0, "pass2_ring": 0, **fields}
    return [{"name": "segment.prepare", "id": 11, "parent": 10, "call": 10,
             "t0_ns": ns(125), "t1_ns": ns(200), "info": {"scratch_bytes": 1 << 24}},
            {"name": "segment.launch", "id": 12, "parent": 10, "call": 10,
             "t0_ns": ns(210), "t1_ns": ns(260), "info": info},
            {"name": "filter", "id": 10, "parent": None, "call": 10,
             "t0_ns": ns(120), "t1_ns": ns(580),
             "info": {"channels": 2, "sample_bytes": 2}}]


def test_the_readers_read_an_i16_launch(monkeypatch):
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program({"mode": "i16"}))
    rec = _record()
    cols = segment_pcm16_cols_us_per_pair.read(rec)
    # (24 + 30) us of column passes over 6 pairs; the rows' 12 over 6.
    assert cols["value"] == pytest.approx(9.0)
    assert cols["note"] == ("split 9x9 (ring 0); 1 calls of 6 pairs; window's us a "
                            "pair: cols_forward 4.0000, cols_inverse 5.0000, "
                            "rows_multiply 2.0000")
    share = kernel_pcm16_roofline_share.read(rec)
    whole = kernel_roofline_share.read(rec)
    assert share["value"] == pytest.approx(whole["value"])
    # Two bytes a sample: 8 MB in and out at 3.35 TB/s is under the
    # operations of 10 hops at B = 2^18, so the bound is operations.
    assert share["note"].startswith(
        "split 9x9 (ring 0); us a pair: cols_forward 4.0000, rows_multiply 2.0000, "
        "cols_inverse 5.0000; bound by operations")


@pytest.mark.parametrize("fields", [{"mode": "f32"}, {"mode": "f64"}, {}],
                         ids=["f32", "f64", "no mode"])
def test_the_readers_read_nothing_without_an_i16_launch(monkeypatch, fields):
    # A call that ran another mode (an int16 input converted to float on
    # the way), or a program whose launch spans carry no mode: the
    # harness's own roofline share still reads, these two do not.
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program(fields))
    rec = _record()
    assert kernel_roofline_share.read(rec) is not None
    assert segment_pcm16_cols_us_per_pair.read(rec) is None
    assert kernel_pcm16_roofline_share.read(rec) is None


def test_the_readers_read_nothing_untraced(monkeypatch):
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program({"mode": "i16"}))
    rec = _record()
    rec.trace = None
    assert segment_pcm16_cols_us_per_pair.read(rec) is None
    assert kernel_pcm16_roofline_share.read(rec) is None
