"""The reader ``segment.rows_us_per_pair`` on the synthetic traced window of
``test_cardbench_long96k.py`` (one call, one launch of three passes at the
long split, 4 pairs): with the program's pass-2 ring field, without it (a
program older than the field still gives the value), with the persistent
row pass's kernel name, and with nothing to read; its ``BENCHMARK.json``
entry."""

import json
from pathlib import Path

import pytest

from cardbench.layer_metrics import _program_spans, segment_rows_us_per_pair

from .test_cardbench_long96k import NAMES, SPLIT, _program, _record

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_entry():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "segment.rows_us_per_pair"]
    assert BENCH["per_layer"][-1] is m
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "us", "lower", "device_trace", "segment kernel", "samples_per_s")
    assert m["workloads"] == [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("ring,shown", [(2, "2"), (0, "0"), (None, "not reported")])
def test_the_row_pass_over_its_pairs(monkeypatch, ring, shown):
    info = dict(SPLIT) if ring is None else {**SPLIT, "pass2_ring": ring}
    monkeypatch.setattr(_program_spans, "recorded", lambda: _program(info))
    got = segment_rows_us_per_pair.read(_record())
    # 36 us of rows_multiply over 4 pairs.
    assert got["value"] == pytest.approx(9.0)
    assert got["note"] == (f"split 10x9 (pass 2 ring {shown}); 1 calls of 4 pairs; "
                           "window's us a pair: rows_multiply 9.0000")


def test_the_persistent_row_pass_is_read_by_its_name(monkeypatch):
    monkeypatch.setattr(_program_spans, "recorded",
                        lambda: _program({**SPLIT, "pass2_ring": 2}))
    rec = _record()
    ring = NAMES[3].replace("rows_multiply<", "rows_multiply_ring<")
    rec.trace.ops = [(c, ring if n == NAMES[3] else n, a, b, k)
                     for c, n, a, b, k in rec.trace.ops]
    assert segment_rows_us_per_pair.read(rec)["value"] == pytest.approx(9.0)


@pytest.mark.parametrize("program", ["no split fields", "no spans", "untraced"])
def test_nothing_to_read(monkeypatch, program):
    spans = {"no split fields": _program({}), "no spans": []}.get(program,
                                                                  _program(SPLIT))
    monkeypatch.setattr(_program_spans, "recorded", lambda: spans)
    rec = _record()
    if program == "untraced":
        rec.trace = None
    assert segment_rows_us_per_pair.read(rec) is None
