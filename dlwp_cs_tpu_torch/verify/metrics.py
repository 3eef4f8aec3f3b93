"""Forecast verification: RMSE/MSE/MAE and ACC against persistence and
climatology baselines.

The port's copy of ``dlwp_cs_tpu.verify.metrics``: per-lead error curves
(``forecast_error``), ``persistence_error``, ``climo_error``,
``monthly_climo_error`` and the ACC curve, in float64 numpy, optionally
weighted by the cubed-sphere cell areas.  Inputs may be numpy arrays or
tensors on any device (a tensor is copied to the host first, so a
forecast's device fields verify as they are).

Array conventions:
  forecast: ``(B, L, 6, n, n, C)``: B initializations, L lead times.
  truth:    the same shape, aligned by (initialization, lead).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "forecast_error",
    "persistence_error",
    "climo_error",
    "monthly_climo_error",
    "acc_curve",
]

_SPATIAL = (-4, -3, -2)  # (face, i, j) axes of (..., 6, n, n, C)


def _host(x):
    """``x`` as something numpy takes: a tensor copied to the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _weights_like(x, weights):
    if weights is None:
        return np.ones(x.shape[-4:-1])
    w = np.asarray(_host(weights), dtype=np.float64)
    if w.shape != x.shape[-4:-1]:
        raise ValueError(f"weights {w.shape} do not match spatial dims {x.shape[-4:-1]}")
    return w


def _reduce(err, x, weights, keep_channels):
    w = _weights_like(x, weights)[..., None]
    num = (err * w).sum(axis=(0, *_SPATIAL))
    den = np.broadcast_to(w, err.shape).sum(axis=(0, *_SPATIAL))
    out = num / den  # (L, C)
    return out if keep_channels else out.mean(axis=-1)


def forecast_error(
    forecast,
    truth,
    method: str = "rmse",
    *,
    weights=None,
    keep_channels: bool = False,
):
    """Per-lead-time error curve: ``(L,)`` (or ``(L, C)``).

    ``method``: 'rmse' | 'mse' | 'mae'.  ``weights``: optional (6, n, n)
    cell weights (e.g. ``CubedSphere(n).area_weights``).
    """
    if method not in ("rmse", "mse", "mae"):  # fail fast, before the reduce
        raise ValueError(f"method must be rmse|mse|mae, got {method!r}")
    f = np.asarray(_host(forecast), dtype=np.float64)
    t = np.asarray(_host(truth), dtype=np.float64)
    if f.shape != t.shape:
        raise ValueError(f"forecast {f.shape} vs truth {t.shape}")
    if method == "mae":
        err = np.abs(f - t)
        return _reduce(err, f, weights, keep_channels)
    err = np.square(f - t)
    out = _reduce(err, f, weights, keep_channels)
    return np.sqrt(out) if method == "rmse" else out


def persistence_error(initial, truth, method: str = "rmse", *, weights=None,
                      keep_channels: bool = False):
    """Error of persisting ``initial`` ``(B, 6, n, n, C)`` over all leads."""
    init = np.asarray(_host(initial))[:, None]
    f = np.broadcast_to(init, np.asarray(_host(truth)).shape)
    return forecast_error(f, truth, method, weights=weights,
                          keep_channels=keep_channels)


def climo_error(climatology, truth, method: str = "rmse", *, weights=None,
                keep_channels: bool = False):
    """Error of a constant climatology ``(6, n, n, C)`` forecast."""
    t = np.asarray(_host(truth))
    f = np.broadcast_to(np.asarray(_host(climatology))[None, None], t.shape)
    return forecast_error(f, truth, method, weights=weights,
                          keep_channels=keep_channels)


def monthly_climo_error(
    monthly_climatology, truth, valid_months, method: str = "rmse", *,
    weights=None, keep_channels: bool = False,
):
    """Error of a per-month climatology.

    ``monthly_climatology``: ``(12, 6, n, n, C)`` (month index 0 = January).
    ``valid_months``: ``(B, L)`` integer months (0-11) of each valid time.
    """
    mc = np.asarray(_host(monthly_climatology))
    months = np.asarray(_host(valid_months))
    f = mc[months]  # (B, L, 6, n, n, C)
    return forecast_error(f, truth, method, weights=weights,
                          keep_channels=keep_channels)


def acc_curve(forecast, truth, climatology, *, weights=None,
              keep_channels: bool = False):
    """Anomaly correlation coefficient per lead time: ``(L,)`` (or
    ``(L, C)`` with ``keep_channels`` — mixing channels of different
    physical scales makes the all-channel ACC dominated by the largest).

    Anomalies are taken w.r.t. ``climatology`` ``(6, n, n, C)`` (or any
    broadcastable shape); averaged over initializations and cells.
    """
    f = np.asarray(_host(forecast), dtype=np.float64)
    t = np.asarray(_host(truth), dtype=np.float64)
    c = np.broadcast_to(np.asarray(_host(climatology), dtype=np.float64), f.shape)
    w = _weights_like(f, weights)[..., None]
    fa, ta = f - c, t - c
    axes = (0, *_SPATIAL) if keep_channels else (0, *_SPATIAL, f.ndim - 1)
    num = (w * fa * ta).sum(axis=axes)
    den = np.sqrt(
        (w * fa * fa).sum(axis=axes) * (w * ta * ta).sum(axis=axes)
    )
    return num / np.maximum(den, 1e-30)
