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


def _apply_weights(err, weights):
    """Weighted mean of ``err`` with ``weights`` broadcast over space and
    channels (e.g. cubed-sphere ``(6, n, n)`` weights against
    ``(B, 6, n, n, C)`` errors)."""
    w = _expand(_as_weights(weights, err), err)
    return torch.sum(err * w) / torch.sum(w.expand(err.shape))


def weighted_mse(pred, target, weights):
    """MSE weighted over spatial cells (e.g. CubedSphere.area_weights)."""
    return _apply_weights(torch.square(pred - target), weights)


def weighted_mae(pred, target, weights):
    return _apply_weights(torch.abs(pred - target), weights)


class AreaWeightedLoss:
    """Area-weighted MSE/MAE.

    Callable like any ``loss(pred, target)``.  :meth:`local_terms` returns
    ``(sum(w * err), sum(w))``, the terms a spatially sharded step adds
    across shards before dividing.

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

    def local_terms(self, pred, target, *, spatial_axis=None, spatial_x_axis=None):
        """``(sum(w * err), sum(w))`` over the whole field.

        The reference slices the weights to a shard's tile by its mesh axes
        for sharded training, the next slice of ``parallel/`` (``ROADMAP.md``
        queue 1, item 17).
        """
        if spatial_axis is not None or spatial_x_axis is not None:
            raise NotImplementedError(
                "spatially sharded losses are not ported yet: ROADMAP.md "
                "queue 1, item 17 (the training slice of parallel/)"
            )
        w = self.weights
        if tuple(pred.shape[2:4]) != tuple(w.shape[1:3]):
            raise ValueError(
                f"pred rows/cols {tuple(pred.shape[2:4])} != weight rows/cols "
                f"{tuple(w.shape[1:3])}"
            )
        err = self._err(pred, target)
        w = _expand(_as_weights(w, err), err)
        return torch.sum(err * w), torch.sum(w.expand(err.shape))


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
