"""Autoregressive multi-step (sequence) training.

The counterpart of ``dlwp_cs_tpu.train.sequence``: during training the
model is applied ``sequence`` times, each call feeding its outputs back as
inputs with the insolation recomputed at the new valid times, and the loss
is the mean over the ``sequence`` predicted windows.  The window advance
and the insolation clock are those of the rollout (``data/channels.py``:
:func:`~dlwp_cs_tpu_torch.data.channels.pack_inputs`,
:func:`~dlwp_cs_tpu_torch.data.channels.make_input_insolation`,
:func:`~dlwp_cs_tpu_torch.data.channels.advance_window`), so training and
inference rewire the window the same way.  The reference's ``lax.scan``
over the sequence is a loop here.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.data.channels import advance_window, make_input_insolation, pack_inputs
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS
from dlwp_cs_tpu_torch.ops.losses import mse
from dlwp_cs_tpu_torch.train.train_step import apply_gradients

__all__ = [
    "make_sequence_loss",
    "make_sequence_train_step",
    "make_sharded_sequence_train_step",
]


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32).to(device)


def make_sequence_loss(apply_fn, data_cfg, *, lat, lon, constants=None,
                       insol_mean: float = 0.0, insol_std: float = 1.0, sequence: int,
                       loss_fn=None):
    """``loss(params, window, t0_days, targets) -> scalar``.

    ``window`` ``(B, T_in, 6, n, n, C)`` normalized initial fields;
    ``t0_days`` ``(B,)`` the valid time of the last input step; ``targets``
    ``(B, sequence, 6, n, n, T_out*C)`` folded target windows.  ``lat`` /
    ``lon`` ``(6, n, n)`` radians and ``constants`` ``(6, n, n, K)`` (numpy
    or tensors) go to the window's device at the first call there.
    ``loss_fn(pred, target)`` defaults to the mean squared error.
    """
    t_out = data_cfg.output_time_steps
    dt_days = data_cfg.step_hours / 24.0
    loss_fn = mse if loss_fn is None else loss_fn
    grids: dict = {}  # device -> (insolation closure, constants)

    def on(device):
        if device not in grids:
            const = None if constants is None else _f32(constants, device)
            grids[device] = (make_input_insolation(data_cfg, _f32(lat, device), _f32(lon, device),
                                                   insol_mean, insol_std), const)
        return grids[device]

    def loss(params, window, t0_days, targets):
        if targets.shape[1] != sequence:
            raise ValueError(
                f"targets carry {targets.shape[1]} autoregressive steps but the loss "
                f"was built with sequence={sequence}: the dataset window setting and "
                "the config disagree"
            )
        input_insolation, const = on(window.device)
        # the clock drives only insolation: reduced mod its period in float32
        t = torch.remainder(_f32(t0_days, window.device), INSOLATION_PERIOD_DAYS)
        losses = []
        for k in range(sequence):
            out = apply_fn(params, pack_inputs(window, input_insolation(t), const))
            losses.append(loss_fn(out, targets[:, k]))
            window, _ = advance_window(window, out, t_out)
            t = t + t_out * dt_days
        return torch.mean(torch.stack(losses))

    return loss


def make_sequence_train_step(loss, optimizer, *, jit: bool = True):
    """``step(state, window, t0_days, targets) -> (state, metrics)`` over
    sequence batches, ``loss`` from :func:`make_sequence_loss`.  ``jit`` is
    accepted and changes nothing."""

    def step(state, window, t0_days, targets):
        value = loss(state.params, window, t0_days, targets)
        grads = torch.autograd.grad(value, list(state.params.values()))
        return apply_gradients(optimizer, state, value.detach(), dict(zip(state.params, grads)))

    return step


def make_sharded_sequence_train_step(apply_fn, data_cfg, optimizer, mesh, *, lat, lon,
                                     constants=None, insol_mean: float = 0.0,
                                     insol_std: float = 1.0, sequence: int, loss_fn=None,
                                     jit: bool = True):
    """Mesh-parallel sequence training over ``('data', 'spatial'[,
    'spatial_x'])``: ``step(state, window, t0_days, targets)``, a collective
    call of every rank with the same global batch.  Each rank takes its
    block (the batch over ``data``, face rows, dimension 3 of ``window
    (B, T_in, 6, n, n, C)`` and ``targets (B, sequence, 6, n, n, T_out*C)``,
    over ``spatial``, columns, dimension 4, over ``spatial_x``), runs the
    sequence loss on it with the halo exchange under every conv
    (:func:`~dlwp_cs_tpu_torch.parallel.sharding.sharded_model_ctx`) and the
    insolation of its own tile only (``lat`` / ``lon`` sliced by its
    coordinates), and the loss and gradients are averaged over every mesh
    dimension.  The blocks go to the parameters' device.  ``loss_fn``
    must be an unweighted elementwise mean.
    """
    from dlwp_cs_tpu_torch.parallel import collectives
    from dlwp_cs_tpu_torch.parallel.collectives import axis_index, axis_size
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, SPATIAL_X_AXIS, local_block
    from dlwp_cs_tpu_torch.parallel.sharding import mesh_axes, pmean_update, sharded_model_ctx

    model_ctx = sharded_model_ctx(mesh)
    axes = mesh_axes(mesh)
    lat = torch.as_tensor(lat, dtype=torch.float32)
    lon = torch.as_tensor(lon, dtype=torch.float32)
    n = lat.shape[1]
    n_spatial, n_spatial_x = axis_size(mesh, SPATIAL_AXIS), axis_size(mesh, SPATIAL_X_AXIS)
    h, wl = n // n_spatial, n // n_spatial_x
    if h * n_spatial != n:
        raise ValueError(f"grid n={n} not divisible by spatial={n_spatial}")
    if wl * n_spatial_x != n:
        raise ValueError(f"grid n={n} not divisible by spatial_x={n_spatial_x}")
    s, jx = axis_index(mesh, SPATIAL_AXIS), axis_index(mesh, SPATIAL_X_AXIS)

    def tile(a):
        return a[:, s * h:(s + 1) * h, jx * wl:(jx + 1) * wl]

    loss = make_sequence_loss(
        apply_fn, data_cfg, lat=tile(lat), lon=tile(lon),
        constants=None if constants is None else tile(torch.as_tensor(constants)),
        insol_mean=insol_mean, insol_std=insol_std, sequence=sequence, loss_fn=loss_fn)

    def step(state, window, t0_days, targets):
        params = list(state.params.values())
        dev = params[0].device
        window, targets = (local_block(torch.as_tensor(a), mesh, rows_dim=3).to(dev)
                           for a in (window, targets))
        t0 = local_block(torch.as_tensor(t0_days), mesh, spatial=False).to(dev)
        with collectives.recording() as rec, model_ctx():
            value = loss(state.params, window, t0, targets)
        grads = collectives.grad(rec, [value], params)
        return pmean_update(optimizer, state, value, grads, mesh, axes)

    return step
