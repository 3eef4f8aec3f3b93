"""On the card: each cell's configuration at its own widths, with
lighter traffic, passes its limits, and the control (the reference in
TF32 in the program's place) fails them.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q

Each test decides inside itself whether a card is present."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.calibrate import readings
from benchmark.spec import Bench
from benchmark.tests.conftest import REPO

LIGHTER = {"ens51-14d": {"members": 9}}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bench(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for traffic, change in LIGHTER.items():
        p = tmp_path / "benchmark" / "traffic" / f"{traffic}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **change)))
    return Bench(tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["unet-c48.ens51-14d", "convlstm-c48.ens51-14d"])
def test_program_passes_and_control_fails(tmp_path, cell):
    _card()
    bench = _bench(tmp_path)
    limits = bench.cell(cell)["limits"]
    for seed in (3, 2**31 + 3, 2**33 + 3):
        r = readings(bench, cell, seed, 2.0, control=True)
        assert r["failed"] == 0
        assert all(r["program"][k] <= limits[k] for k in limits), r
        assert any(r["control"][k] > limits[k] for k in limits), r
