"""The port's bench contract (``python3 -m audio_fir_filter_tpu_torch.bench``)
on ``--device cpu`` at a tiny size (B = 1024, 2-4 segment blocks, 1-2
reps), where the wrappers take their plain versions: the stdout contract,
the roofline model against a hand count, the fidelity gate, ``--all``,
``--scaling`` (the model's rows, the mesh in one process and
the exchange measured between two gloo processes), and the refusal of
``cuda`` without a card."""

import json
import math

import pytest
import torch

from audio_fir_filter_tpu_torch import bench
from audio_fir_filter_tpu_torch.ops import kernel_design as kd
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import roofline
from audio_fir_filter_tpu_torch.parallel import scaling_bench

TINY = ["--device", "cpu", "--block-size", "1024", "--freq", "100",
        "--slope", "200", "--sample-rate", "8000", "--segment-blocks", "4",
        "--reps", "2"]


def run(capsys, argv):
    rc = bench.main(argv)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err


@pytest.mark.parametrize("engine", ["auto", "pallas", "fourstep"])
def test_one_json_line_with_the_four_keys(capsys, engine):
    rc, out, err = run(capsys, [*TINY, "--engine", engine])
    assert rc == 0, err
    assert len(out) == 1
    result = json.loads(out[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["value"] > 0 and result["unit"] == "samples/s"
    assert result["vs_baseline"] == pytest.approx(
        result["value"] / (100 * 8000.0 * 2), rel=1e-3)
    assert "on cpu" in result["metric"] and "TPU" not in result["metric"]
    assert "device-resident: 2 calls" in err


def _hand_count(b, hop, m, channels, hops, sample_bytes, in_halo=True):
    frames = hops * hop
    nbytes = sample_bytes * channels * ((frames + (m if in_halo else 0)) + frames)
    per_block = 2 * 2.5 * b * math.log2(b) + 6 * (b // 2 + 1)
    return nbytes, channels * hops * per_block


# float64 and float32 outside the tensor cores.
@pytest.mark.parametrize("precision,peak", [("high", 34e12), ("fast", 67e12)])
def test_roofline_equals_a_hand_count(precision, peak):
    ws = kd.WindowedSinc(100.0 / 8000.0, 200.0 / 8000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, 1024, "cpu")
    assert (plan.block_size, plan.m, plan.hop) == (1024, 160, 864)
    w = roofline.work(plan, 2, 4 * 864 + 160, 4 * 864)
    nbytes, flops = _hand_count(1024, 864, 160, 2, 4, 4)
    assert w["bytes"] == nbytes == 4 * 2 * (3616 + 3456)
    assert w["flops"] == pytest.approx(flops) and flops == 8 * (51200 + 3078)
    assert w["bytes_s"] == pytest.approx(nbytes / 3.35e12)
    assert w["ops_s"] == pytest.approx(flops / peak)
    assert w["bound_s"] == max(w["bytes_s"], w["ops_s"])
    assert w["bound_by"] == ("bytes" if w["bytes_s"] >= w["ops_s"] else "operations")


def test_kernels_line_bounds_come_from_the_same_model():
    """chip_smoke.py's bound keys, for its program rows (bound_keys) and
    the probes' (roofline.bound)."""
    copy = roofline.bound(2 * 8 * 2 * 512 * 512 * 4, 0, "f32")
    assert copy == {"bound_ms": pytest.approx(33554432 / 3.35e12 * 1e3),
                    "bound_by": "bytes"}
    fft = roofline.bound(1e6, 3.4e10, "f64")
    assert fft == {"bound_ms": pytest.approx(1.0), "bound_by": "operations"}
    w = roofline.roofline(3.35e9, 0, "fast")
    assert roofline.bound_keys(w) == {"bound_ms": pytest.approx(1.0),
                                      "bound_by": "bytes"}


def test_roofline_of_16bit_io_counts_two_bytes_a_sample():
    ws = kd.WindowedSinc(100.0 / 8000.0, 200.0 / 8000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, "fast", 1024, "cpu")
    w = roofline.work(plan, 2, 4 * 864, 4 * 864, sample_bytes=2)
    nbytes, flops = _hand_count(1024, 864, 160, 2, 4, 2, in_halo=False)
    assert (w["bytes"], w["samples"]) == (nbytes, 2 * 4 * 864)
    assert w["flops"] == pytest.approx(flops)


def test_headline_roofline_binds_as_reckoned():
    """The headline plan (M = 38,400, B = 2^18): 4 B in and 4 B out a
    sample at 3.35 TB/s (2.39 ns) against 108.96 flops a sample: ``fast``
    is bound by the bytes (1.63 ns at 67 TFLOP/s), ``high`` by the
    operations (3.20 ns at 34 TFLOP/s)."""
    ws = kd.WindowedSinc(15.0 / 96000.0, 10.0 / 96000.0).make_low_cut()
    for precision, bound_by, ratio in (("high", "operations", 1.342),
                                       ("fast", "bytes", 0.681)):
        plan = osv.make_plan(ws.taps, precision, 0, "cpu")
        w = roofline.work(plan, 2, 1008 * plan.hop + plan.m, 1008 * plan.hop)
        assert w["bound_by"] == bound_by
        assert w["flops"] / w["samples"] == pytest.approx(108.961, abs=1e-3)
        assert w["ops_s"] == pytest.approx(ratio * w["bytes_s"], rel=1e-3)


@pytest.mark.parametrize("engine,channels,frames,want", [
    ("auto", 2, 10 * 864, 1),
    ("fourstep", 2, 4 * 864, 1),        # 8 blocks, one chunk of 16
    ("fourstep", 2, 9 * 864, 2),        # 10 + 10 blocks: 20 -> 2 chunks
    ("fourstep", 3, 16 * 864, 3),       # 48 blocks: 3 chunks
])
def test_launches_per_call(engine, channels, frames, want, monkeypatch):
    """The reckoning, and the calls the filter really makes of the block
    kernel's wrapper (the segment path calls its wrapper once)."""
    ws = kd.WindowedSinc(100.0 / 8000.0, 200.0 / 8000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, "high", 1024, "cpu", engine=engine)
    assert osv.launches_per_call(plan, channels, frames) == want
    calls = []
    for mod, name in ((osv.cb, "conv_real_blocks"), (osv.sf, "segment_filter")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, **k:
                            calls.append(1) or real(*a, **k))
    osv.extended_filter(torch.zeros((channels, frames + plan.m)), plan, frames)
    assert len(calls) == want


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_a_non_finite_output_fails_the_run(bad):
    ws = kd.WindowedSinc(100.0 / 8000.0, 200.0 / 8000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, "high", 1024, "cpu")
    y = torch.zeros((2, 100))
    y[1, 17] = bad
    with pytest.raises(RuntimeError, match="non-finite"):
        bench._timed_calls(lambda: y, 1, torch.device("cpu"), plan, 1)


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("engine", ["auto", "fourstep"])
def test_fidelity_gate_passes_with_the_plain_versions(capsys, precision, engine):
    rc, out, err = run(capsys, [*TINY, "--fidelity", "--precision", precision,
                                "--engine", engine])
    assert rc == 0, err
    assert len(out) == 1
    assert err.count("PASS") == 2 and "FAIL" not in err


def test_fidelity_gate_failure_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(bench, "fidelity_report", lambda *a: (1.5, 24))
    rc, out, err = run(capsys, [*TINY, "--fidelity"])
    assert rc == 1 and len(out) == 1
    assert "FIDELITY GATE FAILED" in err


def test_roofline_report_on_the_cpu_gives_no_share(capsys):
    rc, out, err = run(capsys, [*TINY, "--roofline"])
    assert rc == 0 and len(out) == 1
    assert "bound by" in err and "no roofline share" in err
    assert "% of the binding bound" not in err


def test_scaling_reports_the_model_and_the_measured_halo(capsys):
    """``--scaling --device cpu`` at a tiny size: rc 0, the one JSON line on
    stdout, and on stderr the model's rows at the rates this run measured
    (both precisions), the mesh at 1/2/4/8 cells, and the measured halo
    line; every link figure with its source, the rows marked as a model."""
    rc, out, err = run(capsys, [*TINY, "--scaling"])
    assert rc == 0, err
    assert len(out) == 1 and json.loads(out[0])["value"] > 0
    for precision in ("high", "fast"):
        assert f"{precision} path: " in err
    assert err.count("measured in this run on cpu") == 2
    assert err.count("halo-cost model (1 h 8 kHz x 2 ch, M=160; model, not "
                     "measured: one card)") == 2
    assert "NVIDIA H100 SXM data sheet" in err and "DGX H100 data sheet" in err
    rows = [ln.split() for ln in err.splitlines()
            if len(ln.split()) == 7 and ln.split()[0] in map(
                str, scaling_bench.SHARD_COUNTS)]
    assert len(rows) == 2 * len(scaling_bench.SHARD_COUNTS)
    for r in rows:
        assert len(r) == 7 and 0.0 < float(r[4]) <= 1.0 and 0.0 < float(r[6]) <= 1.0
    assert [ln.split(":")[0].strip() for ln in err.splitlines()
            if ln.startswith("  T=")] == ["T=1", "T=2", "T=4", "T=8"]
    assert "halo exchange (production _halo_exchange, Mo2=80)" in err
    assert "no-communication twin" in err and "weak-scaling ratio" in err
    assert err.count("-> eff ") == 2
    assert "TPU" not in err and "ICI" not in err and "DCN" not in err


def test_scaling_model_formula():
    """The model's rows: t_comp = C * (N / t) / rate, t_halo = 2 * C * Mo2
    * 4 B / link rate, efficiency = t_comp / (t_comp + t_halo)."""
    lines = []
    rows = scaling_bench.halo_cost_model(lines.append, 4.0e10)
    m, n = 38400, 3600 * 96000
    assert [r["shards"] for r in rows] == list(scaling_bench.SHARD_COUNTS)
    for r in rows:
        t_comp = 2 * (n // r["shards"]) / 4.0e10
        assert r["local_span"] == n // r["shards"]
        assert r["eff_nvlink"] == pytest.approx(
            t_comp / (t_comp + 2 * 2 * (m // 2) * 4.0 / 4.5e11))
        assert r["eff_nic"] == pytest.approx(
            t_comp / (t_comp + 2 * 2 * (m // 2) * 4.0 / 5.0e10))
    assert f"M={m}" in lines[0] and "model, not measured" in lines[0]
    # The per-cell rate is the caller's measurement: there is no default.
    with pytest.raises(TypeError):
        scaling_bench.halo_cost_model(lines.append)
    assert not {"CHIP_RATE", "CHIP_RATE_FAST", "ICI_BW", "DCN_BW"} & set(
        vars(scaling_bench))


def test_a_failed_scaling_child_fails_the_run(capsys, monkeypatch):
    """A child that fails makes ``--scaling`` fail with no result line."""
    monkeypatch.setattr(scaling_bench.sys, "executable", "/bin/false")
    with pytest.raises(RuntimeError, match="scaling child 0 of 2 exited 1"):
        bench.main([*TINY, "--scaling"])
    assert capsys.readouterr().out == ""


def test_cuda_without_a_card_exits_1_with_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(capsys, ["--reps", "1"])
    assert rc == 1 and out == []
    assert "no CUDA card" in err


def test_all_reports_every_config_and_fast16(capsys):
    rc, out, err = run(capsys, ["--device", "cpu", "--segment-blocks", "2",
                                "--reps", "1", "--all"])
    assert rc == 0 and len(out) == 1
    rows = json.loads(err[err.index("{\n"):err.rindex("}") + 1])
    assert list(rows) == [c[0] for c in bench.BASELINE_CONFIGS] + [
        "fast16 16-bit I/O (headline shape)"]
    for row in rows.values():
        assert row["samples_per_sec"] > 0
        assert row["bound_by"] in ("bytes", "operations")
        assert "roofline_share" not in row        # no share from a CPU run


def test_segment_bytes_reckons_the_block_path_above_the_segment_path():
    ws = kd.WindowedSinc(15.0 / 96000.0, 10.0 / 96000.0).make_low_cut()
    seg = osv.make_plan(ws.taps, "high", 0, "cpu")
    blk = osv.make_plan(ws.taps, "high", 0, "cpu", engine="fourstep")
    frames = 1008 * seg.hop
    io = 4 * 2 * (2 * frames + seg.m)
    # Segment path: input, output and a 256 MiB scratch.
    assert osv.call_bytes(seg, 2, frames) == io + (256 << 20)
    assert osv.call_bytes(blk, 2, frames) > io + 2 * 4 * 2 * 1008 * (1 << 18)


@pytest.mark.parametrize("precision,bits", [("high", 24), ("fast", 16)])
@pytest.mark.parametrize("engine,hops", [("auto", 128), ("fourstep", 16)])
def test_first_seam_is_where_the_scratch_chunk_or_launch_ends(
        precision, bits, engine, hops):
    """At the headline plan the segment kernel's 256 MiB scratch holds 64
    float64 pairs (128 hops; 128 float32 pairs, 256 hops), and a block-path
    launch covers conv_chunk = 16 blocks."""
    ws = kd.WindowedSinc(15.0 / 96000.0, 10.0 / 96000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, 0, "cpu", engine=engine)
    if engine == "auto" and precision == "fast":
        hops *= 2
    assert osv.chunk_hops(plan) == hops


def _tiny_case(left):
    ws = kd.WindowedSinc(100.0 / 8000.0, 200.0 / 8000.0).make_low_cut()
    plan = osv.make_plan(ws.taps, "high", 1024, "cpu")
    x = bench._signal(2 * (12 * plan.hop + plan.m), torch.device("cpu"))
    x = x.reshape(2, -1)
    n = 12 * plan.hop + (plan.m if left else 0)
    y, _ = osv.sf.reference(x, plan, left, n)
    return ws.taps, plan, x, y


@pytest.mark.parametrize("left", [0, 80])
def test_excerpt_check_passes_the_plain_version(left):
    taps, plan, x, y = _tiny_case(left)
    assert bench.check_excerpts(y, x, taps, left, 24, 2 * plan.hop) < 1.0


@pytest.mark.parametrize("where", ["head", "seam", "tail", "channel 1 tail"])
def test_excerpt_check_fails_a_wrong_sample(where):
    """One sample off by 2 LSB @ 24-bit at any excerpt fails the check; the
    seam excerpt (channel 0 only) covers a frame that neither the head nor
    the tail excerpt does."""
    taps, plan, x, y = _tiny_case(0)
    n = y.shape[1]
    seam = 6 * plan.hop
    assert bench.EXCERPT <= seam + 3 < n - bench.EXCERPT
    c, i = {"head": (0, 5), "seam": (0, seam + 3), "tail": (0, n - 2),
            "channel 1 tail": (1, n - 1)}[where]
    y = y.clone()
    y[c, i] += 2.0 ** -22
    with pytest.raises(RuntimeError, match="float64 oracle at the timed shape"):
        bench.check_excerpts(y, x, taps, 0, 24, seam)


def test_a_wrong_output_at_the_timed_shape_fails_the_run(capsys, monkeypatch):
    """A filter wrong only at the bench's own shape (here: past the first
    launch seam of a block-path call) fails the run with no result line."""
    real = osv.extended_filter

    def wrong(xe, plan, out_len):
        y = real(xe, plan, out_len)
        y[0, osv.chunk_hops(plan) * plan.hop + 1] += 1e-3
        return y

    monkeypatch.setattr(osv, "extended_filter", wrong)
    with pytest.raises(RuntimeError, match="float64 oracle at the timed shape"):
        bench.main([*TINY, "--engine", "fourstep", "--conv-chunk", "2"])
    assert capsys.readouterr().out == ""


def test_the_timed_output_check_reports_its_error(capsys):
    rc, out, err = run(capsys, [*TINY, "--engine", "fourstep", "--conv-chunk", "2"])
    assert rc == 0 and len(out) == 1
    assert "(head/seam/tail excerpts)" in err and "(<= 1.0)" in err
