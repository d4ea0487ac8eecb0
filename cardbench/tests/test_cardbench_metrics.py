"""The yardstick's arithmetic: the frozen roofline, and reading a trace."""

import pytest

from cardbench import roofline
from cardbench.layer_metrics import device_idle_share, kernel_roofline_share
from cardbench.record import Record
from cardbench.trace import Trace


def test_roofline_of_the_headline_and_the_hour():
    # 1008 pairs of 2 x 223,744 frames, f64: operations bind at 34 TFLOP/s.
    r = roofline.bound(1, 2016 * 223744, 4, 1 << 18, 223744, "high")
    assert r["flops"] == pytest.approx(49.148866e9, rel=1e-6)
    assert r["bound_by"] == "operations"
    assert r["bound_s"] == pytest.approx(1.44556e-3, rel=1e-4)
    assert r["bytes_s"] == pytest.approx(1.0773e-3, rel=1e-3)
    hour = roofline.bound(2, 345_600_000, 4, 1 << 18, 223744, "high")
    assert hour["flops"] == pytest.approx(75.3e9, rel=1e-3)
    assert hour["bound_s"] == pytest.approx(2.215e-3, rel=1e-3)
    fast = roofline.bound(2, 1000, 4, 1 << 18, 244504, "fast")
    assert fast["ops_s"] == pytest.approx(fast["flops"] / 67e12)


def _events():
    ann = [("window#1", 0, 100), ("read#2", 0, 30), ("filter#3", 30, 40),
           ("encode#4", 70, 20)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"cardbench.{n}", "ts": t,
           "dur": d} for n, t, d in ann]
    # One kernel launched inside the filter span, one memcpy.
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 35,
            "dur": 1, "args": {"correlation": 7}},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": 40, "dur": 10,
            "args": {"correlation": 7}},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 31, "dur": 4,
            "args": {"correlation": 6}}]
    return ev


def test_trace_reading():
    t = Trace(_events())
    assert t.window_s() == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(14e-6)
    assert t.kernels_in("cardbench.filter#3") == [(40.0, 50.0)]
    assert t.kernels_in("cardbench.read#2") == []
    gaps = dict(t.idle_gaps())
    assert gaps["host: cardbench.read"] == pytest.approx(30e-6)
    assert gaps["host: cardbench.filter"] == pytest.approx(26e-6)
    assert gaps["host: cardbench.encode"] == pytest.approx(20e-6)
    assert gaps["host: outside any span"] == pytest.approx(10e-6)
    assert sum(gaps.values()) + t.busy_s() == pytest.approx(t.window_s())
    assert t.device_ops()[0] == ["k", pytest.approx(10e-6)]


def test_layer_readers_on_a_trace():
    rec = Record({"block_size": 1 << 18, "hop": 223744, "precision": "high"})
    rec.trace = Trace(_events())
    rec.spans = [{"name": "filter", "label": "cardbench.filter#3", "channels": 1,
                  "frames": 1000, "sample_bytes": 4}]
    got = kernel_roofline_share.read(rec)
    bound = roofline.bound(1, 1000, 4, 1 << 18, 223744, "high")["bound_s"]
    assert got["value"] == pytest.approx(100 * bound / 10e-6)
    assert "operations" in got["note"]
    assert device_idle_share.read(rec) == pytest.approx(86.0)
    assert kernel_roofline_share.read(Record()) is None
