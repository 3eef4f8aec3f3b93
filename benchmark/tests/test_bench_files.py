"""Every file the benchmark names exists and parses, every metric has a
reader, and BENCHMARK.json keeps to its contract's shapes."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.spec import Bench
from benchmark.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"ensemble": {"mean_err", "spread_err"}}


@pytest.fixture(scope="module")
def bench():
    return Bench(REPO)


def test_top_level_keys(bench):
    assert set(bench.spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert bench.spec["paths"] == ["benchmark"]
    assert 1 <= bench.spec["run_seconds"] <= 51
    assert len(json.dumps(bench.spec)) < 64 * 1024


def test_names_units_and_lengths(bench):
    s = bench.spec
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[section]]
        assert len(names) == len(set(names)), section
        for e in s[section]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, section):
    for m in bench.spec[section]:
        assert callable(bench.reader(section, m["name"]))


def test_every_cell_finds_its_files(bench):
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        kind = cell["traffic_params"]["load"]
        assert hasattr(bench.load(kind), "Load")
        assert set(cell["limits"]) == CHECKS[kind]
        assert bench.flops(cell["model"]["kind"]).conv_layers(cell["model"])
        assert w["chips"] == 1


def test_configs_name_every_change(bench):
    for c in bench.spec["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert f["model"]["compute_dtype"] in bench.json("peaks.json")["NVIDIA H100 80GB HBM3"]


def test_per_layer_metrics_report_their_moves(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    for m in bench.spec["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moves.get("workloads", [cell]), (m["name"], cell)
    layers = {}
    for m in bench.spec["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough(bench):
    for w in bench.spec["workloads"]:
        e2e = [m["name"] for m in bench.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_of(w["name"], "per_layer")


def test_kernel_families(bench):
    pats = bench.conv_kernel_patterns()
    assert "cs_conv3x3" in pats
    assert not any(p in "void gemm_kernel_sm90_f32" for p in pats)
