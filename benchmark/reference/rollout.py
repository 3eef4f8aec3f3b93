"""Normalisation, insolation and the autoregressive rollout in plain
PyTorch, and the ensemble's mean and spread.

A model call takes ``[T_in steps of the variables | T_in insolation
channels | constants]`` and returns ``T_out`` steps; the window then moves
on by ``T_out`` steps and the clock by ``T_out * step_hours``.  Insolation
is the Spencer (1971) series for declination, equation of time and the
Sun-Earth distance, then the zenith angle, on a float32 clock reduced
modulo 1461 days in float64 first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.models import forward

S0 = 1361.0
PERIOD_DAYS = 1461.0


def insolation(days, lat, lon):
    """W/m^2 at ``days`` since 2000-01-01 (broadcast from the left against
    ``lat``/``lon`` in radians)."""
    g = 2.0 * math.pi * torch.remainder(days, 365.25) / 365.25
    c1, s1, c2, s2, c3, s3 = (torch.cos(g), torch.sin(g), torch.cos(2 * g), torch.sin(2 * g),
                              torch.cos(3 * g), torch.sin(3 * g))
    decl = (0.006918 - 0.399912 * c1 + 0.070257 * s1 - 0.006758 * c2 + 0.000907 * s2
            - 0.002697 * c3 + 0.001480 * s3)
    eot = 0.000075 + 0.001868 * c1 - 0.032077 * s1 - 0.014615 * c2 - 0.040849 * s2
    dist = 1.000110 + 0.034221 * c1 + 0.001280 * s1 + 0.000719 * c2 + 0.000077 * s2
    hour = 2.0 * math.pi * (torch.remainder(days, 1.0) - 0.5) + lon + eot
    cz = torch.sin(lat) * torch.sin(decl) + torch.cos(lat) * torch.cos(decl) * torch.cos(hour)
    return S0 * dist * torch.clamp_min(cz, 0.0)


class Rollout:
    """``Rollout(kind, params, model, data, stats, constants, lat, lon)``;
    :meth:`run` rolls normalised windows out; every tensor on the device of
    ``params``."""

    def __init__(self, kind, params, model, data, stats, constants, lat, lon):
        self.kind, self.p, self.model, self.data = kind, params, model, data
        dev = next(iter(params.values())).device
        self.lat = torch.as_tensor(lat, dtype=torch.float32, device=dev)
        self.lon = torch.as_tensor(lon, dtype=torch.float32, device=dev)
        self.const = constants
        self.insol_mean, self.insol_std = stats["insol_mean"], stats["insol_std"]
        self.t_in, self.t_out = data["input_time_steps"], data["output_time_steps"]
        self.dt = data["step_hours"] / 24.0
        self.dev = dev

    def inputs(self, window, t):
        """Folded model input for ``window`` ``(B, T_in, 6, n, n, C)``
        ending at the float32 clock ``t`` (``(B,)``)."""
        b = window.shape[0]
        offs = (torch.arange(self.t_in, device=self.dev) - (self.t_in - 1)) * self.dt
        times = t[:, None] + offs[None, :]
        ins = (insolation(times[..., None, None, None], self.lat, self.lon)
               - self.insol_mean) / self.insol_std                      # (B, T_in, 6, n, n)
        parts = [window.permute(0, 2, 3, 4, 1, 5).reshape(b, 6, *window.shape[3:5], -1),
                 ins.permute(0, 2, 3, 4, 1)]
        if self.const is not None:
            parts.append(self.const[None].expand(b, *self.const.shape))
        return torch.cat(parts, dim=-1)

    @torch.no_grad()
    def run(self, window, t0_days, calls: int):
        """``(B, calls * T_out, 6, n, n, C)`` normalised fields from the
        normalised ``window`` and host init times ``t0_days`` ``(B,)``."""
        t = torch.as_tensor(np.mod(np.asarray(t0_days, np.float64), PERIOD_DAYS)
                            .astype(np.float32), device=self.dev)
        t = torch.remainder(t, PERIOD_DAYS)
        outs = []
        for _ in range(calls):
            y = forward(self.kind, self.p, self.model, self.data, self.inputs(window, t)).float()
            b, f, n, _, c = y.shape
            step = y.reshape(b, f, n, n, self.t_out, c // self.t_out).permute(0, 4, 1, 2, 3, 5)
            window = torch.cat([window, step], dim=1)[:, -self.t_in:]
            outs.append(step)
            t = t + self.t_out * self.dt
        return torch.cat(outs, dim=1)


def mean_spread(members):
    """Mean and ddof=1 standard deviation over axis 0 (the members)."""
    return members.mean(dim=0), members.std(dim=0, correction=1)
