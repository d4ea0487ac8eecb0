"""The cell ``long96k.device`` (``lowcut -f 10 -s 5`` at 96 kHz: 76,801
taps, B = 2^19) and its two readers: the cell on the CPU at a small size,
its entries in ``BENCHMARK.json``, the faults of
``test_cardbench_faults.py`` failing its check, and the readers of the
segment kernel's passes on a synthetic trace with and without the
program's split fields."""

import contextlib
import io
import json
from pathlib import Path

import pytest

from cardbench import run
from cardbench.layer_metrics import (_program_spans, kernel_long_taps_roofline_share,
                                     kernel_roofline_share, segment_cols_us_per_pair)
from cardbench.record import Record
from cardbench.reference import design
from cardbench.trace import Trace

from .test_cardbench_faults import _fault

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "long96k.device"
SMALL = {"frames": 400_000}


def _run(trace=0, seed=4294967311, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", params=SMALL)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()


def test_the_entries_and_the_configuration():
    assert len(BENCH["workloads"]) == 3
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("long96k-s24-high", "hour_on_card", 1)
    (c,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == [] and len(c["source"]) <= 200
    cfg = json.loads((ROOT / c["file"]).read_text())
    f = cfg["filter"]
    assert cfg["cli"] == ["-f", "10", "-s", "5"] and cfg["precision"] == "high"
    # The tap count the tool's design rule gives, and the B and hop the
    # port plans for it (the roofline's, never read from the plan).
    m = design.order(f["slope_hz"], cfg["format"]["sample_rate"])
    assert f["num_taps"] == m + 1 == 76_801
    assert (cfg["block_size"], cfg["hop"]) == (1 << 19, (1 << 19) - m)
    cell = run.load_cell(CELL)
    assert cell["workload"]["params"]["frames"] == 345_600_000
    assert {m["name"] for m in cell["end_to_end"]} == {"samples_per_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "kernel.long_taps_roofline_share", "segment.cols_us_per_pair"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu(trace):
    rc, result, err = _run(trace)
    assert rc == 0, err
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == want + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["err_lsb"]["limit"] == 1.0
    if trace:
        # A CPU run launches no kernel: the device readers read nothing.
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"samples_per_s", "setup_s"}
        assert result["metrics"]["samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "peak"])
def test_a_fault_is_not_correct(fault, monkeypatch):
    from audio_fir_filter_tpu_torch.ops import segment_filter as sf

    if fault == "peak":
        real = sf.segment_filter

        def broken(x, plan, left, out_len, i16_io=False):
            y, peak = real(x, plan, left, out_len, i16_io)
            return y, peak * 0.5
    else:
        broken = _fault(fault)
    monkeypatch.setattr(sf, "segment_filter", broken)
    rc, result, err = _run()
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0


# A synthetic traced window: one harness filter span on the trace's clock
# at 100-600 us, the program's spans on a host clock 20 s ahead, and one
# launch of three passes at the long split, 4 pairs.
OFFSET_US = 20_000_000.0
NAMES = {1: "void (anonymous namespace)::fill<float>",
         2: "void (anonymous namespace)::cols_forward<double, float, Split<10, 9> >",
         3: "void (anonymous namespace)::rows_multiply<double, Split<10, 9> >",
         4: "void (anonymous namespace)::cols_inverse<double, float, Split<10, 9> >"}


def _record():
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"cardbench.{n}", "ts": t,
           "dur": d} for n, t, d in [("window#1", 0, 1000), ("filter#2", 100, 500)]]
    for corr, launch, start, dur in [(1, 150, 160, 5), (2, 220, 300, 24),
                                     (3, 230, 330, 36), (4, 240, 370, 20)]:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": NAMES[corr], "ts": start,
                   "dur": dur, "args": {"correlation": corr}})
    rec = Record({"block_size": 1 << 19, "hop": 447_488, "precision": "high"})
    rec.trace = Trace(ev)
    rec.spans = [{"name": "filter", "id": 2, "label": "cardbench.filter#2",
                  "t0": (100 + OFFSET_US) / 1e6, "t1": (600 + OFFSET_US) / 1e6,
                  "channels": 2, "frames": 1_000_000, "sample_bytes": 4}]
    return rec


def _program(fields):
    def ns(us):
        return round((us + OFFSET_US) * 1e3)

    info = {"chunks": 1, "kernels": 3, **fields}
    return [{"name": "segment.prepare", "id": 11, "parent": 10, "call": 10,
             "t0_ns": ns(125), "t1_ns": ns(200), "info": {"scratch_bytes": 1 << 28}},
            {"name": "segment.launch", "id": 12, "parent": 10, "call": 10,
             "t0_ns": ns(210), "t1_ns": ns(260), "info": info},
            {"name": "filter", "id": 10, "parent": None, "call": 10,
             "t0_ns": ns(120), "t1_ns": ns(580), "info": {"channels": 2}}]


SPLIT = {"log_n1": 10, "log_n2": 9, "pairs": 4, "chunk_pairs": 4, "pass1_ring": 2}


def test_the_readers_on_the_long_split(monkeypatch):
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program(SPLIT))
    rec = _record()
    cols = segment_cols_us_per_pair.read(rec)
    # (24 + 20) us of column passes over 4 pairs.
    assert cols["value"] == pytest.approx(11.0)
    assert cols["note"].startswith("split 10x9 (ring 2); 1 calls of 4 pairs")
    assert "cols_forward 6.0000, cols_inverse 5.0000" in cols["note"]
    share = kernel_long_taps_roofline_share.read(rec)
    assert share["value"] == pytest.approx(kernel_roofline_share.read(rec)["value"])
    assert share["note"].startswith(
        "split 10x9 (ring 2); us a pair: cols_forward 6.0000, rows_multiply 9.0000, "
        "cols_inverse 5.0000; bound by operations")


@pytest.mark.parametrize("program", ["no split fields", "no spans"])
def test_the_readers_read_nothing_without_the_split_fields(monkeypatch, program):
    # A program older than the fields, or one that recorded no spans: the
    # harness's own roofline share still reads, these two do not.
    spans = _program({}) if program == "no split fields" else []
    monkeypatch.setattr(_program_spans, "recorded", lambda: spans)
    rec = _record()
    assert kernel_roofline_share.read(rec) is not None
    assert segment_cols_us_per_pair.read(rec) is None
    assert kernel_long_taps_roofline_share.read(rec) is None
    untraced = _record()
    untraced.trace = None
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program(SPLIT))
    assert segment_cols_us_per_pair.read(untraced) is None
    assert kernel_long_taps_roofline_share.read(untraced) is None
