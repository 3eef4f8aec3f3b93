"""Losses and metrics.

The counterpart of ``dlwp_cs_tpu.ops.losses``: plain and area-weighted
MSE/MAE on the cubed sphere, the cos(lat)-weighted loss of lat-lon grids,
and the anomaly correlation.  Weights are numpy arrays or tensors, moved to
the prediction's device at each call (a few KB).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "mse",
    "mae",
    "weighted_mse",
    "weighted_mae",
    "AreaWeightedLoss",
    "latitude_weights",
    "latitude_weighted_loss",
    "anomaly_correlation",
]


def mse(pred, target):
    return torch.mean(torch.square(pred - target))


def mae(pred, target):
    return torch.mean(torch.abs(pred - target))


def _as_weights(weights, like):
    return torch.as_tensor(weights, dtype=like.dtype, device=like.device)


def _expand(w, err):
    """``w`` with leading axes added up to ``err.ndim - 1`` and a trailing
    channel axis."""
    while w.ndim < err.ndim - 1:
        w = w[None]
    return w[..., None]


def _weight_total(w, err):
    """``sum(broadcast_to(w, err.shape))``, as the weights' sum times the
    number of times the broadcast repeats each: on the CPU a sum over a
    stride-0 expanded tensor runs sequentially and drifts (2.8e-5 relative
    at 2e5 terms)."""
    return torch.sum(w) * (err.numel() // w.numel())


def _apply_weights(err, weights):
    """Weighted mean of ``err`` with ``weights`` broadcast over space and
    channels (e.g. cubed-sphere ``(6, n, n)`` weights against
    ``(B, 6, n, n, C)`` errors)."""
    w = _expand(_as_weights(weights, err), err)
    return torch.sum(err * w) / _weight_total(w, err)


def weighted_mse(pred, target, weights):
    """MSE weighted over spatial cells (e.g. CubedSphere.area_weights)."""
    return _apply_weights(torch.square(pred - target), weights)


def weighted_mae(pred, target, weights):
    return _apply_weights(torch.abs(pred - target), weights)


class AreaWeightedLoss:
    """Area-weighted MSE/MAE.

    Callable like any ``loss(pred, target)``.  :meth:`local_terms` returns
    a shard's ``(sum(w * err), sum(w))``, the terms the spatially sharded
    step (``parallel.sharding.make_spatial_train_step``) adds across shards
    before dividing: the global weighted mean, exactly, though the shards'
    weight sums differ.

    Args:
      base: 'mse' or 'mae'.
      weights: ``(6, n, n)`` cell weights (``CubedSphere.area_weights``).
    """

    def __init__(self, base: str, weights):
        if base not in ("mse", "mae"):
            raise ValueError(f"base must be 'mse' or 'mae', got {base!r}")
        self.base = base
        self.weights = torch.as_tensor(np.asarray(weights, np.float32))

    def _err(self, pred, target):
        d = pred - target
        return torch.square(d) if self.base == "mse" else torch.abs(d)

    def __call__(self, pred, target):
        return _apply_weights(self._err(pred, target), self.weights)

    def local_terms(self, pred, target, *, spatial_axis=None, spatial_x_axis=None, mesh=None):
        """Per-shard ``(sum(w * err), sum(w))`` for ``psum``-combining.

        When ``pred`` holds only a tile of each face (its row or column
        count is smaller than the weight table's), ``spatial_axis`` /
        ``spatial_x_axis`` name the dimensions of ``mesh`` that carry the
        row / column decomposition, and the weights are sliced to this
        rank's rows and columns by its coordinates
        (:func:`~dlwp_cs_tpu_torch.parallel.collectives.axis_index`).
        """
        w = self.weights
        h, wl = pred.shape[2], pred.shape[3]
        if h != w.shape[1]:
            if spatial_axis is None:
                raise ValueError(
                    f"pred rows {h} != weight rows {w.shape[1]} but no "
                    "spatial_axis given to slice by"
                )
            w = w.narrow(1, _coordinate(mesh, spatial_axis) * h, h)
        if wl != w.shape[2]:
            if spatial_x_axis is None:
                raise ValueError(
                    f"pred cols {wl} != weight cols {w.shape[2]} but no "
                    "spatial_x_axis given to slice by"
                )
            w = w.narrow(2, _coordinate(mesh, spatial_x_axis) * wl, wl)
        err = self._err(pred, target)
        w = _expand(_as_weights(w, err), err)
        return torch.sum(err * w), _weight_total(w, err)


def _coordinate(mesh, name: str) -> int:
    if mesh is None:
        raise ValueError(f"slicing the weights by {name!r} needs the mesh (mesh=...)")
    from dlwp_cs_tpu_torch.parallel.collectives import axis_index

    return axis_index(mesh, name)


def latitude_weights(lats_deg) -> np.ndarray:
    """cos(lat) weights normalized to mean 1, for lat-lon grids."""
    w = np.cos(np.deg2rad(np.asarray(lats_deg, dtype=np.float64)))
    w = np.clip(w, 0.0, None)
    return w / w.mean()


def latitude_weighted_loss(base: str, lats_deg):
    """Closure computing cos(lat)-weighted MSE/MAE over ``(..., H, W, C)``,
    the latitude axis third from last."""
    if base not in ("mse", "mae"):
        raise ValueError(f"base must be 'mse' or 'mae', got {base!r}")
    w = latitude_weights(lats_deg).astype(np.float32)[:, None]

    def loss(pred, target):
        d = pred - target
        err = torch.square(d) if base == "mse" else torch.abs(d)
        return _apply_weights(err, w)

    return loss


def anomaly_correlation(pred, target, climatology, weights=None, spatial_axes=None):
    """Anomaly correlation coefficient.

    ``acc = <p' t'> / sqrt(<p'^2><t'^2>)`` with anomalies w.r.t.
    ``climatology`` and optional area weights, over ``spatial_axes``
    (default: all but the first axis).
    """
    p = pred - climatology
    t = target - climatology
    if spatial_axes is None:
        spatial_axes = tuple(range(1, p.ndim))
    if weights is not None:
        w = _expand(_as_weights(weights, p), p)
    else:
        w = torch.ones((1,) * p.ndim, dtype=p.dtype, device=p.device)
    num = torch.sum(w * p * t, dim=spatial_axes)
    den = torch.sqrt(
        torch.sum(w * p * p, dim=spatial_axes) * torch.sum(w * t * t, dim=spatial_axes)
    )
    return num / torch.clamp_min(den, 1e-12)
