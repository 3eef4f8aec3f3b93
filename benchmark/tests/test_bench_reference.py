"""The plain reference against the program on the CPU at tiny sizes: the
halo, both models, and a rollout through the service's path.  (The
reference itself imports nothing of the program; these tests do.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.inputs import Inputs
from benchmark.reference import ops
from benchmark.reference.geometry import cell_latlon, edge_table
from benchmark.reference.models import forward
from benchmark.reference.rollout import Rollout
from benchmark.tests.conftest import STATS, TINY_CONFIGS

torch.set_num_threads(2)


def test_edge_table_is_the_programs():
    from dlwp_cs_tpu_torch.geometry.cubed_sphere import edge_table as prog_table

    got = [[(l.face, l.edge, l.reverse) for l in row] for row in prog_table()]
    assert got == [list(row) for row in edge_table()]


@pytest.mark.parametrize("n", [4, 8, 48])
def test_halo_equals_the_programs_pad(n):
    from dlwp_cs_tpu_torch.ops.padding import cs_pad

    x = torch.randn(2, 6, n, n, 3, dtype=torch.float64)
    assert torch.equal(ops.cs_pad1(x), cs_pad(x, 1))


@pytest.mark.parametrize("name", ["unet-tiny", "convlstm-tiny"])
def test_models_agree(name):
    from dlwp_cs_tpu_torch.models import build_model
    from benchmark import program

    cfg = TINY_CONFIGS[name]
    inp = Inputs(7, "cpu")
    w = inp.weights(cfg["kind"], cfg["model"], cfg["data"], cfg["input_channels"])
    exp = program.experiment(cfg)
    model = build_model(exp.resolved_model(), 12, device="cpu", generator=torch.Generator())
    model.load_state_dict(w, strict=True)
    x = torch.randn(3, 6, 8, 8, 12)
    with torch.no_grad():
        assert torch.allclose(model(x), forward(cfg["kind"], w, cfg["model"], cfg["data"], x),
                              rtol=1e-5, atol=1e-5)


def test_rollout_agrees_with_the_service():
    from benchmark import program

    cfg = TINY_CONFIGS["unet-tiny"]
    inp = Inputs(9, "cpu")
    w = inp.weights(cfg["kind"], cfg["model"], cfg["data"], cfg["input_channels"])
    const = inp.constants(cfg["data"])
    raw = inp.raw_windows(2, cfg["data"], STATS)
    t0 = np.array([9000.25, 9500.5])
    svc = program.service(cfg, w, const, "cpu")
    fc = svc.forecast(raw, t0, steps=3)
    lat, lon = cell_latlon(8)
    ro = Rollout("unet", w, cfg["model"], cfg["data"], STATS, const, lat, lon)
    norm = (torch.as_tensor(raw) - torch.tensor(STATS["mean"])) / torch.tensor(STATS["std"])
    ref = ro.run(norm, t0, 3).numpy()
    got = (fc.fields - np.asarray(STATS["mean"])) / np.asarray(STATS["std"])
    assert got.shape == ref.shape and np.sqrt(np.mean((got - ref) ** 2)) < 1e-5
