"""A tiny copy of the benchmark in a temporary directory: the repo's
``benchmark/`` files plus tiny configurations, traffic mixes and cells
added as files, and a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_DATA = {"grid_n": 8, "variables": ["z500", "z1000", "tau300-700", "t2m"],
             "input_time_steps": 2, "output_time_steps": 2, "step_hours": 6.0, "interval": 1,
             "add_insolation": True, "constants": ["topography", "land_sea_mask"]}
STATS = {"mean": [54000.0, 900.0, 62000.0, 278.0], "std": [3300.0, 900.0, 2200.0, 21.0],
         "insol_mean": 340.6, "insol_std": 439.3}
TINY_CONFIGS = {
    "unet-tiny": {"kind": "unet", "input_channels": 12, "data": TINY_DATA, "stats": STATS,
                  "model": {"kind": "unet", "output_channels": 8, "filters": [4, 8],
                            "convs_per_block": 2, "kernel_size": [3, 3],
                            "activation": "leaky_relu", "activation_slope": 0.1,
                            "pooling": "avg", "upsample": "nearest",
                            "separate_polar_weights": True, "final_kernel_size": [1, 1],
                            "compute_dtype": "float32", "conv_backend": "auto"}},
    "convlstm-tiny": {"kind": "convlstm", "input_channels": 12, "data": TINY_DATA, "stats": STATS,
                      "model": {"kind": "convlstm", "output_channels": 8, "filters": [4, 4],
                                "kernel_size": [3, 3], "head_kernel_size": [1, 1],
                                "separate_polar_weights": True, "compute_dtype": "float32",
                                "conv_backend": "auto", "input_time_steps": 2,
                                "variable_channels": 4, "add_insolation": True}},
}
TINY_TRAFFIC = {
    "ens-tiny": {"load": "ensemble", "steps": 2, "members": 3, "amplitude": 0.05,
                 "antithetic": True, "window_pool": 3, "perturbation_pool": 2,
                 "t0_days": [8766.0, 10227.0], "check_sample": 2},
}
LIMITS = {"ensemble": {"mean_err": 1e-5, "spread_err": 1e-5}}
TINY_CELLS = [("unet-tiny", "ens-tiny"), ("convlstm-tiny", "ens-tiny")]


def make_tiny(tmp: Path) -> Path:
    """``tmp`` as a checkout root holding the benchmark and the tiny cells,
    added as files only; returns ``tmp``."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for name, cfg in TINY_CONFIGS.items():
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "tests", "file": f"benchmark/configs/{name}.json",
                                "reduced": ["grid_n", "filters"], "why": "CPU test"})
    for name, tp in TINY_TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(tp))
    for cfg, tr in TINY_CELLS:
        cell = f"{cfg}.{tr}"
        (b / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": LIMITS[TINY_TRAFFIC[tr]["load"]]}))
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": tr, "chips": 1,
                                  "why": "CPU test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "unet-c48.ens51-14d" in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))
