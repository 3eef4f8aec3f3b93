"""Autoregressive forecasting on the device.

The counterpart of ``dlwp_cs_tpu.rollout.estimator``: feed the model's
multi-step outputs back as the next inputs, recompute the insolation
channels at each new valid time, hold the constant fields fixed.  The
reference's ``lax.scan`` becomes a Python loop of device work with no host
synchronisation inside it: the window and the clock stay on the device.
The model's parameters live in the module, so the rollout takes no
``params`` argument.  The model is any callable with the module's contract:
the sharded forward of :func:`~dlwp_cs_tpu_torch.parallel.make_spatial_apply`
takes its place as the reference's ``apply_fn`` does.

Spans (:func:`~dlwp_cs_tpu_torch.utils.profiling.span`): ``rollout.build``
where a predictor builds its rollout, ``rollout.enqueue`` around the
rollout's call and ``rollout.call`` around each model call it enqueues.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from dlwp_cs_tpu_torch.data.channels import (
    advance_window,
    make_input_insolation,
    pack_inputs,
)
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS
from dlwp_cs_tpu_torch.models.config import DataConfig
from dlwp_cs_tpu_torch.utils.profiling import span

__all__ = ["Forecast", "RolloutStep", "TimeSeriesEstimator", "make_rollout_fn"]


class Forecast(NamedTuple):
    """Rollout result.

    ``fields``: ``(B, steps * T_out, 6, n, n, C_var)`` normalized forecasts,
    time ordered; ``lead_hours``: ``(steps * T_out,)``; ``init_times``:
    optional ``(B,)`` init times (days since 2000-01-01); ``variables``:
    optional channel names.
    """

    fields: Any
    lead_hours: Any
    init_times: Any = None
    variables: tuple[str, ...] | None = None

    def valid_times(self):
        """``(B, steps * T_out)`` valid times in days since 2000-01-01."""
        if self.init_times is None:
            raise ValueError("Forecast carries no init_times")
        t0 = np.atleast_1d(np.asarray(self.init_times, np.float64))
        lead = np.asarray(torch.as_tensor(self.lead_hours).cpu(), np.float64)
        return t0[:, None] + lead[None, :] / 24.0


class RolloutStep(torch.nn.Module):
    """One model call of the rollout: ``step(window, t_days) -> (window,
    out_window, t_days)``.

    Packs the normalized ``window`` ``(B, T_in, 6, n, n, C_var)``, the
    insolation of its valid times (ending at ``t_days``, ``(B,)`` or a
    scalar float32 tensor already reduced mod 1461) and the constants into
    the model input, calls the model and returns the next window, the
    ``(B, T_out, 6, n, n, C_var)`` predicted steps and the clock advanced by
    ``T_out`` steps.  The grid and the constants are tensors of the module
    (moved to ``device`` once); ``model`` is its submodule or, for a sharded
    apply, any callable.  :func:`make_rollout_fn` loops over it, and
    :mod:`dlwp_cs_tpu_torch.serve.export` exports it.
    """

    def __init__(self, model, data_cfg: DataConfig, *, lat, lon, constants=None,
                 insol_mean: float = 0.0, insol_std: float = 1.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.model = model
        self.t_out = data_cfg.output_time_steps
        self.dt_days = data_cfg.step_hours / 24.0
        lat = torch.as_tensor(np.asarray(lat), dtype=torch.float32, device=dev)
        lon = torch.as_tensor(np.asarray(lon), dtype=torch.float32, device=dev)
        if constants is not None:
            constants = torch.as_tensor(constants, dtype=torch.float32, device=dev)
        self.constants = constants
        self.device = dev
        self._insolation = make_input_insolation(data_cfg, lat, lon, insol_mean, insol_std)

    def forward(self, window, t_days):
        inputs = pack_inputs(window, self._insolation(t_days), self.constants)
        window, out_window = advance_window(window, self.model(inputs), self.t_out)
        return window, out_window, t_days + self.t_out * self.dt_days


def make_rollout_fn(
    model,
    data_cfg: DataConfig,
    *,
    lat,
    lon,
    constants=None,
    insol_mean: float = 0.0,
    insol_std: float = 1.0,
    steps: int,
    device=None,
):
    """Build ``rollout(window, t0_days) -> Forecast``.

    ``model`` maps inputs ``(B, 6, n, n, C_in)`` to outputs ``(B, 6, n, n,
    T_out*C_var)``: the module, or a sharded apply of it (every rank of its
    mesh then runs the rollout with the same arguments); ``lat``/``lon`` ``(6, n, n)`` radians and ``constants``
    ``(6, n, n, K)`` (normalized) are copied to ``device`` once.  The
    initial ``window`` ``(B, T_in, 6, n, n, C_var)`` holds normalized fields
    at valid times ``t0 - (T_in-1)*dt .. t0``.
    """
    step = RolloutStep(model, data_cfg, lat=lat, lon=lon, constants=constants,
                       insol_mean=insol_mean, insol_std=insol_std, device=device)
    dev = step.device
    t_in = data_cfg.input_time_steps

    @torch.no_grad()
    def rollout(window, t0_days) -> Forecast:
        window = torch.as_tensor(window, dtype=torch.float32, device=dev)
        if window.ndim != 6 or window.shape[1] != t_in:
            raise ValueError(
                f"window must be (B, {t_in}, 6, n, n, C), got {tuple(window.shape)}"
            )
        t = torch.as_tensor(t0_days, dtype=torch.float32, device=dev)
        if t.ndim not in (0, 1) or (t.ndim == 1 and t.shape[0] != window.shape[0]):
            raise ValueError(
                "t0_days must be a scalar or a (B,) vector matching the "
                f"window batch {window.shape[0]}, got shape {tuple(t.shape)}"
            )
        # insolation is periodic in 1461 days: keep the float32 clock small
        t = torch.remainder(t, INSOLATION_PERIOD_DAYS)
        outs = []
        for _ in range(steps):
            with span("rollout.call"):
                window, out_window, t = step(window, t)
            outs.append(out_window)
        fields = torch.cat(outs, dim=1)  # (B, steps*T_out, 6, n, n, C)
        lead = (torch.arange(steps * step.t_out, device=dev) + 1) * data_cfg.step_hours
        return Forecast(fields=fields, lead_hours=lead)

    return rollout


@dataclass
class TimeSeriesEstimator:
    """``TimeSeriesEstimator(model, data_cfg, lat=..., lon=...,
    constants=..., ...).predict(window, t0_days, steps=56)``."""

    model: Any
    data_cfg: DataConfig
    lat: Any
    lon: Any
    constants: Any = None
    insol_mean: float = 0.0
    insol_std: float = 1.0
    device: Any = None

    def predict(self, window, t0_days, *, steps: int) -> Forecast:
        cache = self.__dict__.setdefault("_rollout_cache", {})
        fn = cache.get(steps)
        if fn is None:
            with span("rollout.build"):
                fn = make_rollout_fn(
                    self.model,
                    self.data_cfg,
                    lat=self.lat,
                    lon=self.lon,
                    constants=self.constants,
                    insol_mean=self.insol_mean,
                    insol_std=self.insol_std,
                    steps=steps,
                    device=self.device,
                )
            cache[steps] = fn
        # float64 host-side periodic reduction before the float32 clock;
        # the Forecast keeps the original init times
        t0_red = np.mod(
            np.asarray(t0_days, np.float64), INSOLATION_PERIOD_DAYS
        ).astype(np.float32)
        with span("rollout.enqueue"):
            fc = fn(window, t0_red)
        return fc._replace(
            init_times=t0_days, variables=tuple(self.data_cfg.variables)
        )
