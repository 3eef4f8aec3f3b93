"""Ensemble forecasting: perturbed-initial-condition, multi-model and lagged
ensembles, the members folded into the batch of one rollout.

The counterpart of ``dlwp_cs_tpu.rollout.ensemble``.  An M-member ensemble
of B windows is one rollout (:func:`~dlwp_cs_tpu_torch.rollout.estimator.
make_rollout_fn`) at batch B*M, so each model call runs the conv kernels
once at that batch; the mean and the spread (ddof=1) reduce on the device
before anything is copied back.  Perturbations are centred Gaussian noise
in normalized units, optionally in antithetic (+/-) pairs, and member 0 is
the unperturbed control.

Random numbers: the reference draws the perturbations from a JAX PRNG key
inside its jitted rollout.  Here :func:`ic_perturbations` draws them from
an explicit ``torch.Generator`` (on the generator's device, then moved to
the rollout's: a seeded CPU generator gives the same perturbations whatever
device runs the rollout), and the rollout of :func:`make_ensemble_rollout`
takes them as an argument.  The two generators give different numbers for
the same seed; a caller that needs the reference's members passes its
perturbations in (``perturbations=``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS
from dlwp_cs_tpu_torch.models.config import DataConfig
from dlwp_cs_tpu_torch.rollout.estimator import make_rollout_fn
from dlwp_cs_tpu_torch.utils.profiling import span

__all__ = [
    "EnsembleForecast",
    "EnsembleForecaster",
    "ic_perturbations",
    "make_ensemble_rollout",
    "make_lagged_rollout",
    "make_multimodel_rollout",
    "stack_params",
]


class EnsembleForecast(NamedTuple):
    """Ensemble rollout result.

    ``mean`` / ``spread``: ``(B, steps * T_out, 6, n, n, C_var)`` ensemble
    mean and standard deviation (ddof=1) in the rollout's (normalized)
    units.  ``members``: the whole ``(B, M, steps * T_out, 6, n, n, C_var)``
    stack when requested (``keep_members=True``), else ``None``.
    """

    mean: Any
    spread: Any
    lead_hours: Any
    members: Any = None
    init_times: Any = None
    variables: tuple[str, ...] | None = None


def ic_perturbations(generator, window_shape, members: int, *, antithetic: bool = True,
                     dtype=torch.float32, device=None):
    """Unit-amplitude IC perturbations ``(B, members, *window_shape[1:])``.

    Member 0 is zero (the control).  With ``antithetic=True`` the other
    members come in exact ``(+eps, -eps)`` pairs (the last unpaired when
    ``members - 1`` is odd), so for odd ``members`` the perturbations' mean
    over the members is zero.  ``generator``: the ``torch.Generator`` the
    noise is drawn from, on its own device; the result is on ``device``
    (default: the generator's).
    """
    if members < 1:
        raise ValueError(f"members must be >= 1, got {members}")
    gen_dev = generator.device
    device = gen_dev if device is None else torch.device(device)
    b, rest = window_shape[0], tuple(window_shape[1:])
    npert = members - 1
    zero = torch.zeros((b, 1) + rest, dtype=dtype, device=device)
    if npert == 0:
        return zero
    if antithetic:
        eps = torch.randn((b, (npert + 1) // 2) + rest, generator=generator, dtype=dtype,
                          device=gen_dev)
        pert = torch.cat([eps, -eps], dim=1)[:, :npert]
    else:
        pert = torch.randn((b, npert) + rest, generator=generator, dtype=dtype, device=gen_dev)
    return torch.cat([zero, pert.to(device)], dim=1)


def _mean_spread(fields):
    """Mean and ddof=1 standard deviation over the member axis 1 (zero
    spread for one member)."""
    mean = fields.mean(dim=1)
    if fields.shape[1] > 1:
        return mean, fields.std(dim=1, correction=1)
    return mean, torch.zeros_like(mean)


def make_ensemble_rollout(
    model,
    data_cfg: DataConfig,
    *,
    lat,
    lon,
    constants=None,
    insol_mean: float = 0.0,
    insol_std: float = 1.0,
    steps: int,
    members: int,
    keep_members: bool = False,
    device=None,
):
    """Build ``ensemble(window, t0_days, perturbations, amplitude)``.

    ``window``: ``(B, T_in, 6, n, n, C_var)`` normalized control analysis;
    ``perturbations``: ``(B, members, T_in, 6, n, n, C_var)`` unit
    perturbations (:func:`ic_perturbations`; member 0 the control's zeros);
    ``amplitude``: scalar or per-channel ``(C_var,)`` standard deviation in
    normalized units.  The members fold into the batch of one rollout of
    ``model`` (batch B * members, member fastest).  Returns
    :class:`EnsembleForecast` with device tensors.
    """
    dev = resolve_device(device)
    base = make_rollout_fn(model, data_cfg, lat=lat, lon=lon, constants=constants,
                           insol_mean=insol_mean, insol_std=insol_std, steps=steps,
                           device=dev)

    @torch.no_grad()
    def ensemble(window, t0_days, perturbations, amplitude) -> EnsembleForecast:
        window = torch.as_tensor(window, dtype=torch.float32, device=dev)
        if window.ndim != 6:
            raise ValueError(f"window must be (B, T_in, 6, n, n, C), got {tuple(window.shape)}")
        b = window.shape[0]
        pert = torch.as_tensor(perturbations, dtype=torch.float32, device=dev)
        if tuple(pert.shape) != (b, members) + tuple(window.shape[1:]):
            raise ValueError(
                f"perturbations must be {(b, members) + tuple(window.shape[1:])}, got "
                f"{tuple(pert.shape)}"
            )
        amp = torch.as_tensor(amplitude, dtype=torch.float32, device=dev)
        flat = (window[:, None] + amp * pert).reshape((b * members,) + window.shape[1:])
        t0 = torch.as_tensor(t0_days, dtype=torch.float32)
        if t0.ndim == 1:
            t0 = torch.repeat_interleave(t0, members)
        fc = base(flat, t0)
        fields = fc.fields.reshape((b, members) + fc.fields.shape[1:])
        mean, spread = _mean_spread(fields)
        return EnsembleForecast(mean=mean, spread=spread, lead_hours=fc.lead_hours,
                                members=fields if keep_members else None)

    return ensemble


def stack_params(params_list):
    """Stack K parameter dicts of one architecture (``{name: tensor}``, as
    ``dict(model.named_parameters())`` gives them) name by name for
    :func:`make_multimodel_rollout` (leading axis: the model index)."""
    if not params_list:
        raise ValueError("need at least one parameter dict")
    first = {k: tuple(v.shape) for k, v in params_list[0].items()}
    for p in params_list[1:]:
        if {k: tuple(v.shape) for k, v in p.items()} != first:
            raise ValueError(
                "parameter dicts differ in structure: multi-model ensembles need one "
                "architecture"
            )
    return {k: torch.stack([torch.as_tensor(p[k]).detach() for p in params_list])
            for k in first}


def make_multimodel_rollout(
    model,
    data_cfg: DataConfig,
    *,
    lat,
    lon,
    constants=None,
    insol_mean: float = 0.0,
    insol_std: float = 1.0,
    steps: int,
    keep_members: bool = False,
    device=None,
):
    """Build ``multi(params_stack, window, t0_days) -> EnsembleForecast``:
    K models of ``model``'s architecture (:func:`stack_params`; e.g.
    different training seeds) on the same windows, member axis = model
    index.

    The reference ``vmap``s one rollout over the stacked parameter tree.
    The port's kernels are ``ctypes`` launches that ``torch.func.vmap``
    cannot batch, so each model rolls out on its own
    (``torch.func.functional_call`` of ``model`` with the model's slice of
    the stack) and the K forecasts are stacked.  All models share the data
    config and its normalization statistics.
    """
    dev = resolve_device(device)
    current = {}

    def apply(inputs):
        return torch.func.functional_call(model, current["params"], (inputs,))

    base = make_rollout_fn(apply, data_cfg, lat=lat, lon=lon, constants=constants,
                           insol_mean=insol_mean, insol_std=insol_std, steps=steps,
                           device=dev)
    t_out = data_cfg.output_time_steps

    @torch.no_grad()
    def multi(params_stack, window, t0_days) -> EnsembleForecast:
        k = len(next(iter(params_stack.values())))
        fields = []
        try:
            for i in range(k):
                current["params"] = {name: v[i].to(dev) for name, v in params_stack.items()}
                fields.append(base(window, t0_days).fields)
        finally:
            current.clear()
        stack = torch.stack(fields, dim=1)  # (B, K, L, 6, n, n, C)
        mean, spread = _mean_spread(stack)
        lead = (torch.arange(steps * t_out, device=dev) + 1) * data_cfg.step_hours
        return EnsembleForecast(mean=mean, spread=spread, lead_hours=lead,
                                members=stack if keep_members else None)

    return multi


def make_lagged_rollout(
    model,
    data_cfg: DataConfig,
    *,
    lat,
    lon,
    constants=None,
    insol_mean: float = 0.0,
    insol_std: float = 1.0,
    steps: int,
    lags,
    keep_members: bool = False,
    device=None,
):
    """Build ``lagged(windows, t0_days) -> EnsembleForecast``: a
    lagged-average-forecast ensemble.

    Member ``m`` starts ``lags[m]`` model steps (of ``step_hours``) before
    the control time ``t0`` and rolls far enough that every member covers
    the control's lead times; the members are aligned by valid time, so the
    mean and the spread are taken at fixed valid times.  ``windows``: ``(B,
    M, T_in, 6, n, n, C)``, member ``m``'s window ending at ``t0 - lags[m]
    * dt``; ``t0_days``: the control's init (scalar or ``(B,)``).  ``lags``
    start at 0 (the control) and are non-negative.
    """
    lags = tuple(int(g) for g in lags)
    if not lags or lags[0] != 0 or any(g < 0 for g in lags):
        raise ValueError(
            f"lags must start at 0 (the control) and be non-negative, got {lags}"
        )
    dev = resolve_device(device)
    t_out = data_cfg.output_time_steps
    n_lead = steps * t_out
    extra_calls = -(-max(lags) // t_out)  # enough calls to cover the latest lag
    base = make_rollout_fn(model, data_cfg, lat=lat, lon=lon, constants=constants,
                           insol_mean=insol_mean, insol_std=insol_std,
                           steps=steps + extra_calls, device=dev)
    dt_days = data_cfg.step_hours / 24.0
    members = len(lags)

    @torch.no_grad()
    def lagged(windows, t0_days) -> EnsembleForecast:
        windows = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        if windows.ndim != 7 or windows.shape[1] != members:
            raise ValueError(
                f"windows must be (B, {members}, T_in, 6, n, n, C), got "
                f"{tuple(windows.shape)}"
            )
        b = windows.shape[0]
        flat = windows.reshape((b * members,) + windows.shape[2:])
        t0 = torch.as_tensor(t0_days, dtype=torch.float32)
        lag_days = torch.as_tensor(lags, dtype=torch.float32) * dt_days
        if t0.ndim == 0:
            t0_flat = (t0 - lag_days).repeat(b)
        else:
            t0_flat = (t0[:, None] - lag_days[None, :]).reshape(-1)
        fc = base(flat, t0_flat)
        fields = fc.fields.reshape((b, members) + fc.fields.shape[1:])
        # member m's lead j is valid at t0 - lags[m] dt + (j + 1) dt: its
        # leads lags[m] .. lags[m] + n_lead - 1 align with the control's
        aligned = torch.stack([fields[:, m, g : g + n_lead] for m, g in enumerate(lags)],
                              dim=1)
        mean, spread = _mean_spread(aligned)
        lead = (torch.arange(n_lead, device=dev) + 1) * data_cfg.step_hours
        return EnsembleForecast(mean=mean, spread=spread, lead_hours=lead,
                                members=aligned if keep_members else None)

    return lagged


@dataclass
class EnsembleForecaster:
    """The ensemble counterpart of :class:`~dlwp_cs_tpu_torch.rollout.
    estimator.TimeSeriesEstimator`: ``EnsembleForecaster(model, data_cfg,
    lat=..., lon=..., ...).predict(window, t0_days, steps=..., members=...)``.
    It keeps the rollout of the last ``(steps, members, keep_members)`` it
    served (one configuration at a time)."""

    model: Any
    data_cfg: DataConfig
    lat: Any
    lon: Any
    constants: Any = None
    insol_mean: float = 0.0
    insol_std: float = 1.0
    device: Any = None

    def predict(self, window, t0_days, *, steps: int, members: int, generator=None,
                amplitude=0.05, antithetic: bool = True, keep_members: bool = False,
                perturbations=None) -> EnsembleForecast:
        """An ensemble of ``members`` around each window of ``window`` ``(B,
        T_in, 6, n, n, C)`` (normalized).  The perturbations are drawn from
        ``generator`` (default: a CPU generator seeded with 0) by
        :func:`ic_perturbations`, or taken from ``perturbations`` (unit
        amplitude, ``(B, members, T_in, 6, n, n, C)``) when given."""
        cfg = (steps, members, keep_members)
        cached = self.__dict__.get("_cached")
        if cached is None or cached[0] != cfg:
            with span("rollout.build"):
                fn = make_ensemble_rollout(
                    self.model, self.data_cfg, lat=self.lat, lon=self.lon,
                    constants=self.constants, insol_mean=self.insol_mean,
                    insol_std=self.insol_std, steps=steps, members=members,
                    keep_members=keep_members, device=self.device)
            self.__dict__["_cached"] = cached = (cfg, fn)
        if perturbations is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            perturbations = ic_perturbations(generator, np.shape(window), members,
                                             antithetic=antithetic)
        # float64 periodic reduction before the float32 clock, as in
        # TimeSeriesEstimator.predict
        t0_red = np.mod(np.asarray(t0_days, np.float64),
                        INSOLATION_PERIOD_DAYS).astype(np.float32)
        with span("rollout.enqueue"):
            fc = cached[1](window, t0_red, perturbations, amplitude)
        return fc._replace(init_times=t0_days, variables=tuple(self.data_cfg.variables))
