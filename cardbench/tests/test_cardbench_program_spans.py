"""The readers of the program's own spans on a synthetic trace: a gap that
was queued and one that was not, program spans carried onto the trace's
clock by a known offset, only the C loop's boundaries counted as such,
and the parts of the idle time summing to ``device.idle_share``."""

import pytest

from cardbench.layer_metrics import (_program_spans, device_idle_share,
                                     kernel_boundary_idle_share,
                                     wrapper_host_us_per_call, wrapper_idle_share)
from cardbench.record import Record
from cardbench.trace import Trace

# Host clock = trace clock + 20 s: the harness's span starts at 20.0001 s
# on the host and at 100 us in the trace.
OFFSET_US = 20_000_000.0


def _trace():
    ann = [("window#1", 0, 1000), ("filter#2", 100, 500)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"cardbench.{n}", "ts": t,
           "dur": d} for n, t, d in ann]

    def kernel(corr, launch, start, dur):
        if launch is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start,
                   "dur": dur, "args": {"correlation": corr}})

    kernel(1, 150, 160, 5)       # the peak's fill, launched in prepare
    kernel(2, 220, 300, 100)     # three passes launched in the launch span
    kernel(3, 230, 420, 80)      # queued at 400: 20 us of boundary
    kernel(4, 240, 500, 60)      # no gap
    kernel(5, None, 700, 50)     # no launch in the trace: not queued
    return Trace(ev)


def _record(trace=True):
    rec = Record({"block_size": 1 << 18, "hop": 223744, "precision": "high"})
    rec.trace = _trace() if trace else None
    rec.spans = [{"name": "filter", "id": 2, "label": "cardbench.filter#2",
                  "t0": (100 + OFFSET_US) / 1e6, "t1": (600 + OFFSET_US) / 1e6,
                  "channels": 2, "frames": 1000, "sample_bytes": 4}]
    return rec


def _program(*extra):
    def ns(us):
        return round((us + OFFSET_US) * 1e3)

    got = [{"name": "segment.prepare", "id": 11, "parent": 10, "call": 10,
            "t0_ns": ns(125), "t1_ns": ns(200), "info": {"scratch_bytes": 1 << 28}},
           {"name": "segment.launch", "id": 12, "parent": 10, "call": 10,
            "t0_ns": ns(210), "t1_ns": ns(260), "info": {"chunks": 1, "kernels": 3}},
           {"name": "filter", "id": 10, "parent": None, "call": 10,
            "t0_ns": ns(120), "t1_ns": ns(580), "info": {"channels": 2}}]
    return got + list(extra)


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(_program_spans, "recorded", lambda: spans)
    return use


def test_queued_and_free_gaps():
    parts = _program_spans.gaps(_trace())
    # [0, 160): queued from the launch at 150; [165, 300): from 220;
    # [400, 420): the whole gap; [560, 700) and [750, 1000): never.
    assert parts["window"] == 1000
    assert parts["gaps"] == [(0, 150, 160), (165, 220, 300), (400, 400, 420),
                             (560, 700, 700), (750, 1000, 1000)]


def test_program_spans_land_on_the_trace_clock(program):
    # A call of another window (before this one) is not matched.
    program(_program({"name": "filter", "id": 1, "parent": None, "call": 1,
                      "t0_ns": 5, "t1_ns": 9, "info": {}}))
    rec = _record()
    calls = _program_spans.calls(rec)
    assert len(calls) == 1
    c = calls[0]
    assert c["offset_us"] == pytest.approx(-OFFSET_US)
    assert c["spans"]["filter"] == [pytest.approx((120, 580))]
    assert c["spans"]["segment.prepare"] == [pytest.approx((125, 200))]
    assert c["launches"] == [pytest.approx((210, 260, 3))]
    assert c["kernels"] == 3 and c["host_us"] == pytest.approx(460)
    got = wrapper_idle_share.read(rec)
    # Idle inside [120, 580) and not at a boundary: [120, 160), [165, 300)
    # (the fill's and the first pass's launch latency queued in it) and
    # [560, 580).
    assert got["value"] == pytest.approx(100 * (40 + 135 + 20) / 1000)
    assert ("prepare 0.000070 s, launch 0.000050 s, rest 0.000075 s; "
            "queued (first launches) 0.000090 s") in got["note"]


@pytest.mark.parametrize("shift_us", [-4.0, 0.0, 4.0])
def test_only_the_loops_boundaries_count(program, shift_us):
    # The launch span carried a few us off still finds its three kernels:
    # the fill (launched in prepare) and the first pass end gaps that are
    # the wrapper's, the second pass's queued gap is the one boundary.
    got = _program()
    got[1] = {**got[1], "t0_ns": got[1]["t0_ns"] + round(shift_us * 1e3),
              "t1_ns": got[1]["t1_ns"] + round(shift_us * 1e3)}
    program(got)
    parts = _program_spans.split(_record())
    assert parts["boundary"] == pytest.approx(20)
    assert (parts["boundaries"], parts["exact"], parts["launch_spans"]) == (2, 1, 1)


def test_the_parts_sum_to_the_idle_share(program):
    program(_program())
    rec = _record()
    boundary = kernel_boundary_idle_share.read(rec)
    wrapper = wrapper_idle_share.read(rec)
    idle = device_idle_share.read(rec)
    assert boundary["value"] == pytest.approx(2.0)
    assert ("1 calls of 3 kernels; 2 boundaries in the trace, 10.000 us a boundary; "
            "1 of 1 launch spans") in boundary["note"]
    caller = float(wrapper["note"].split("nor in the span) ")[1]
                   .split(" s")[0]) * 1e6
    assert caller == pytest.approx(490, abs=1e-3)
    assert boundary["value"] + wrapper["value"] + 100 * caller / 1000 == \
        pytest.approx(idle)
    host = wrapper_host_us_per_call.read(rec)
    assert host["value"] == pytest.approx(460)
    assert "prepare 75.000 us, launch 50.000 us" in host["note"]


def test_without_the_programs_spans(program):
    program([])
    rec = _record()
    assert _program_spans.split(rec) is None
    for reader in (kernel_boundary_idle_share, wrapper_idle_share,
                   wrapper_host_us_per_call):
        assert reader.read(rec) is None
    program(_program())
    untraced = _record(trace=False)
    assert kernel_boundary_idle_share.read(untraced) is None
    assert wrapper_idle_share.read(untraced) is None
    assert wrapper_host_us_per_call.read(untraced)["value"] == pytest.approx(460)
