"""BENCHMARK.json and the files it names; the import rules; the result
line's keys; exits without a card or without the program."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench import run

from ._small import CELLS, run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "audio_fir_filter_tpu"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # A full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s of compiling a cell, 1200 s spare.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_names_units_and_files():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"] == f"cardbench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == []
        names.append(c["name"])
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = json.loads((ROOT / "cardbench" / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert (ROOT / "cardbench" / "traffic" / f"{cell['kind']}.py").is_file()
    assert used == set(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "cardbench" / "end_to_end" / f"{run.module_name(m['name'])}.py").is_file()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m["workloads"]) <= cells
        assert (ROOT / "cardbench" / "layer_metrics" / f"{run.module_name(m['name'])}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
    for w in cells:      # every cell: setup_s, another end-to-end metric, a layer metric
        mine = [m for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", [w]) for m in BENCH["per_layer"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "cardbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_by_whole_top_level_name(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(ROOT / "cardbench").parts:
        assert "audio_fir_filter_tpu_torch" not in tops
        assert all(t in {"__future__", "math", "struct", "numpy", "torch"} for t in tops), tops


def test_nothing_loads_jax():
    code = ("import importlib, pkgutil, sys, cardbench\n"
            "for m in pkgutil.walk_packages(cardbench.__path__, 'cardbench.'):\n"
            "    importlib.import_module(m.name)\n"
            "import audio_fir_filter_tpu_torch.models, audio_fir_filter_tpu_torch.ops.overlap_save\n"
            "from cardbench import run\n"
            "print(run.forbidden_modules())")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    got = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload", "cd44k.device",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA card" in got.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload", "cd44k.device",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(cell, trace):
    rc, result, out, err = run_cell(cell, trace=trace)
    assert rc == 0, err
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(result) == want + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m for m in BENCH[kind] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= set(names)
    for name, m in result["metrics"].items():
        assert m["unit"] == names[name]["unit"]
    # A CPU run reads nothing from the card; every other metric is there.
    assert {n for n, m in names.items() if m["source"] != "device_trace"} <= set(result["metrics"])
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert [ln.split()[1] for ln in last] == list(result["checks"])
