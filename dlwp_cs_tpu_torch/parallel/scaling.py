"""Scaling-efficiency harness: grid points per second across mesh shapes.

The counterpart of ``dlwp_cs_tpu.parallel.scaling``: the throughput of the
train step at every ``(data, spatial)`` configuration the process group can
form, with the per-device efficiency against a one-device run.  A
collective call: every rank of the group calls :func:`measure_scaling` with
the same arguments.  A one-device row runs on every rank by itself; a row
of ``data * spatial`` ranks runs when that is the group's size (the port's
meshes span the whole group), and any other row is skipped, as the
reference skips a configuration that lacks devices.

Ranks that share one card (the gloo groups of ``parallel/launch.py``) take
turns on it, so the efficiency column then measures time slicing, not
scaling: it means what it says only with a card per rank.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dlwp_cs_tpu_torch.models.config import TrainConfig
from dlwp_cs_tpu_torch.ops.losses import mse
from dlwp_cs_tpu_torch.parallel.mesh import create_mesh
from dlwp_cs_tpu_torch.parallel.sharding import (
    make_dp_train_step,
    make_spatial_train_step,
    shard_batch,
)
from dlwp_cs_tpu_torch.train.train_step import (
    init_params,
    init_state,
    make_optimizer,
    make_train_step,
    model_apply,
)

__all__ = ["ScalingResult", "measure_scaling"]


@dataclass
class ScalingResult:
    mesh_shape: tuple[int, int]  # (data, spatial)
    n_devices: int
    step_seconds: float
    gridpoints_per_s: float
    gridpoints_per_s_per_chip: float
    efficiency_vs_single: float | None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _throughput(step_fn, state, x, y, *, iters: int, gridpoints: int):
    for _ in range(2):
        state, _ = step_fn(state, x, y)
    dev = x.device
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = step_fn(state, x, y)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    return dt, gridpoints / dt


def measure_scaling(model, *, n_grid: int, in_channels: int, out_channels: int,
                    batch_per_device: int = 8,
                    mesh_configs=((1, 1), (2, 1), (4, 1), (8, 1), (2, 4)),
                    iters: int = 10, seed: int = 0, device=None) -> list[ScalingResult]:
    """Weak-scaling sweep of the train step of ``model`` (a port model on
    the device its meshes use; ``device`` as in ``create_mesh``): global
    batch = ``batch_per_device * data``, Adam at 1e-3 on MSE, seeded data
    and the parameters of ``seed``.  ``mesh_configs``: ``(data, spatial)``
    tuples; ``spatial > 1`` runs the spatial step (the halo exchange),
    ``spatial == 1`` the data-parallel step on this rank's block.  Each
    rank returns its own timings; the wall clock runs from the third step
    to a device synchronisation after the last."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    opt = make_optimizer(TrainConfig(learning_rate=1e-3))
    apply_fn = model_apply(model)
    params = init_params(model, seed)
    results: list[ScalingResult] = []
    for data, spatial in mesh_configs:
        n_dev = data * spatial
        if n_dev != 1 and n_dev != world:
            continue  # the group cannot form this mesh
        b = batch_per_device * data
        x = torch.from_numpy(rng.normal(size=(b, 6, n_grid, n_grid, in_channels))
                             .astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.normal(size=(b, 6, n_grid, n_grid, out_channels))
                             .astype(np.float32)).to(dev)
        state = init_state({k: p.detach().clone().requires_grad_(True)
                            for k, p in params.items()}, opt)
        if n_dev == 1:
            step = make_train_step(apply_fn, opt, mse)
        else:
            mesh = create_mesh(data=data, spatial=spatial, device=device)
            if spatial == 1:
                step = make_dp_train_step(apply_fn, opt, mse, mesh)
                x, y = shard_batch((x, y), mesh)
            else:
                step = make_spatial_train_step(apply_fn, opt, mse, mesh)
        gridpoints = b * 6 * n_grid * n_grid
        dt, gps = _throughput(step, state, x, y, iters=iters, gridpoints=gridpoints)
        results.append(ScalingResult(
            mesh_shape=(data, spatial), n_devices=n_dev, step_seconds=dt,
            gridpoints_per_s=gps, gridpoints_per_s_per_chip=gps / n_dev,
            efficiency_vs_single=None,
        ))
    # the efficiency only where a one-device row was measured (it is 1.0)
    single = next((r for r in results if r.n_devices == 1), None)
    if single is not None:
        base = single.gridpoints_per_s_per_chip
        results = [dataclasses.replace(r, efficiency_vs_single=r.gridpoints_per_s_per_chip / base)
                   for r in results]
    return results
