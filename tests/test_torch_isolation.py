"""The port stands alone: no JAX, no flax, nothing of ``dlwp_cs_tpu``.

Also: with no GPU, entry points called without ``device=`` raise instead
of running on the CPU.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dlwp_cs_tpu_torch

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dlwp_cs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dlwp_cs_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="dlwp_cs_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("ops.hopper_conv", "ops.ring_kernel", "ops.ringfix", "ops.cuda_build",
              "models.convlstm", "parallel.halo", "parallel.halo2d", "parallel.hopper_band",
              "parallel.hopper_tile", "parallel.sharding", "parallel.launch",
              "ops.conv_variants", "tools.timing", "tools.probes", "tools.conv_micro",
              "tools.kernel_variants", "tools.mosaic_bisect", "tools.npack_phases",
              "rollout.ensemble", "utils.misc", "verify", "verify.alignment",
              "verify.ensemble", "verify.metrics", "verify.oracle", "verify.relabel",
              "ops.library", "serve.export", "serve.http", "tools.export_artifact",
              "parallel.scaling", "train.sequence", "remap", "remap.apply",
              "remap.native", "remap.weights", "data.era5", "data.cfsr", "data.grib2",
              "data.tscache", "data.preprocessing", "ops.quant", "ops.latlon",
              "models.latlon_unet", "models.registry", "models.torch_mirror",
              "barotropic", "barotropic.model", "barotropic.spharm", "plot", "plot.maps",
              "utils.profiling", "tools.capacity_bench", "tools.trainer_wallclock",
              "tools.serve_bench", "tools.ensemble_bench", "tools.scaling_bench",
              "parallel.device_collectives"):
        assert f"dlwp_cs_tpu_torch.{m}" in mods
    assert len(mods) >= 62
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_plot_and_utils_import_no_matplotlib():
    """matplotlib is imported when a plot is drawn, not with the package."""
    code = (
        "import sys\n"
        "import dlwp_cs_tpu_torch.plot, dlwp_cs_tpu_torch.utils, dlwp_cs_tpu_torch.barotropic\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]
))
def test_sources_import_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)], names


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.models import (
        CubeSphereUNet,
        DataConfig,
        ExperimentConfig,
        UNetConfig,
    )
    from dlwp_cs_tpu_torch.rollout import make_rollout_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(data=DataConfig(grid_n=8, variables=("a",), constants=()),
                           model=UNetConfig(filters=(4,)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DLWPEstimator(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CubeSphereUNet(UNetConfig(filters=(4,)), 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_rollout_fn(lambda x: x, cfg.data, lat=[0.0], lon=[0.0], steps=1)
    from dlwp_cs_tpu_torch.data import prefetch_to_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter([]))
    from dlwp_cs_tpu_torch.parallel import create_mesh, global_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh(data=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        global_mesh()
    import numpy as np

    from dlwp_cs_tpu_torch.data import Preprocessor

    pre = Preprocessor({"z500": np.zeros((2, 4, 8))}, np.linspace(-1.5, 1.5, 4),
                       np.arange(8) * np.pi / 4, [0.0, 0.25])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pre.data_to_series(4)
    assert pre.data_to_series(4, device="cpu").fields.shape == (2, 6, 4, 4, 1)
    from dlwp_cs_tpu_torch.models import LatLonUNet, SequentialSpec
    from dlwp_cs_tpu_torch.models.torch_mirror import (
        TorchCubeSphereConv2D,
        TorchCubeSphereUNet,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LatLonUNet(UNetConfig(filters=(4,)), 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SequentialSpec([("ReLU", (), {})], 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchCubeSphereConv2D(np.zeros((3, 3, 1, 1)), np.zeros((3, 3, 1, 1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchCubeSphereUNet(UNetConfig(filters=(4,)))
    from dlwp_cs_tpu_torch.barotropic import SphericalHarmonics

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SphericalHarmonics(10)
    est = DLWPEstimator(cfg, device="cpu")  # an explicit device is honoured
    assert est.device.type == "cpu"
    assert dlwp_cs_tpu_torch.DLWPEstimator is DLWPEstimator
