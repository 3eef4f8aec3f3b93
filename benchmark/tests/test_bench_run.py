"""Whole runs of the tiny cells on the CPU: the result line, the guard
against JAX, the refusal without a card, and a metric added by a file."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.run import forbidden_modules, run_cell
from benchmark.spec import Bench
from benchmark.tests.conftest import REPO, TINY_CELLS

CELLS = [f"{c}.{t}" for c, t in TINY_CELLS]


def _check_line(out: dict, trace: bool, bench: Bench, cell: str):
    line = json.loads(json.dumps(out))
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    section = "per_layer" if trace else "end_to_end"
    declared = {m["name"]: m["unit"] for m in bench.metrics_of(cell, section)}
    assert set(line["metrics"]) <= set(declared)
    for name, m in line["metrics"].items():
        assert m["unit"] == declared[name] and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev and "breakdown" in line) == trace
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    return line


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_prints_a_valid_line(tiny_root, cell, trace):
    bench = Bench(tiny_root)
    out = run_cell(bench, cell, 2**31 + 11, 1.0, bool(trace), device="cpu",
                   t_process=time.perf_counter())
    line = _check_line(out, bool(trace), bench, cell)
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2


def test_traced_run_traces_only_the_last_part(tiny_root):
    from benchmark.run import TRACED_SHARE

    out = run_cell(Bench(tiny_root), "unet-tiny.ens-tiny", 2**31 + 12, 2.0, True, device="cpu",
                   t_process=time.perf_counter())
    # requests of both parts are counted and checked; the trace spans the last
    assert out["correct"] is True and out["attempted"] >= 2
    assert 2.0 * TRACED_SHARE <= out["device"]["window_s"] < 2.0 * TRACED_SHARE + 0.5


def test_a_metric_added_by_files(tmp_path):
    from benchmark.tests.conftest import make_tiny

    root = make_tiny(tmp_path)
    (root / "benchmark" / "metrics" / "window_calls.py").write_text(
        "def read(run):\n    return float(run.calls) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "window_calls.ens", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "host path",
                              "moves": "ens_member_days_per_s",
                              "workloads": ["unet-tiny.ens-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(Bench(root), "unet-tiny.ens-tiny", 3, 0.5, True, device="cpu",
                   t_process=time.perf_counter())
    assert out["metrics"]["window_calls.ens"]["value"] > 0


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    import dlwp_cs_tpu_torch  # noqa: F401 — its name begins with the JAX package's

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert forbidden_modules() == ["jaxlib"]


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "unet-c48.ens51-14d",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _cli(REPO)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
