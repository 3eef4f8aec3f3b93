"""Estimator facade: config, model, stats and parameters in one object.

The counterpart of ``dlwp_cs_tpu.estimator.DLWPEstimator``: ``fit`` trains
on a predictor store (``SeriesDataset`` -> ``prefetch_to_device`` ->
``Trainer``), ``forecast`` and ``forecast_lagged`` roll the model out from
a store's samples (a ``MemoryStore``), ``denormalize`` undoes the
normalization, ``save`` / ``load`` persist the training state with the
JSON config and stats, and serving reads ``config``, ``model``, ``cs``,
``state`` and ``stats``.  :meth:`DLWPEstimator.load_state` fills it for
serving from the reference's parameter tree (or the model's own seeded
initialisation) plus the normalization statistics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.data.prefetch import prefetch_to_device
from dlwp_cs_tpu_torch.data.series import SeriesDataset
from dlwp_cs_tpu_torch.data.store import select_constants
from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS
from dlwp_cs_tpu_torch.models import build_model
from dlwp_cs_tpu_torch.models.config import ExperimentConfig
from dlwp_cs_tpu_torch.models.weights import load_jax_params
from dlwp_cs_tpu_torch.rollout.ensemble import EnsembleForecast, make_lagged_rollout
from dlwp_cs_tpu_torch.rollout.estimator import Forecast, TimeSeriesEstimator
from dlwp_cs_tpu_torch.train.train_step import (
    TrainState,
    init_state,
    make_optimizer,
    params_of,
)
from dlwp_cs_tpu_torch.train.trainer import Trainer
from dlwp_cs_tpu_torch.utils.checkpoint import (
    load_json,
    restore_checkpoint,
    save_checkpoint,
    save_json,
)

__all__ = ["DLWPEstimator", "ServingState"]

_STATS_KEYS = ("mean", "std", "insol_mean", "insol_std")


@dataclass
class ServingState:
    """The estimator's parameters, by name (``scope.param``)."""

    params: dict


class DLWPEstimator:
    """Config-driven train/save/load and the model that serving reads.

    ``DLWPEstimator(config, device=None, seed=0)`` builds the configured
    model (a U-Net or a ConvLSTM, ``build_model``) on ``device`` (``None``:
    the GPU, which must exist) with parameters drawn from
    ``torch.Generator().manual_seed(seed)``.  :meth:`fit` trains it;
    :meth:`load_state` instead sets the normalization stats and, optionally,
    the reference's trained parameters.  ``state`` is a ``TrainState``
    after ``fit`` / ``load`` and a :class:`ServingState` after
    ``load_state``.
    """

    def __init__(self, config: ExperimentConfig, *, device=None, seed: int = 0):
        self.config = config
        self.model = build_model(
            config.resolved_model(),
            config.data.input_channels,
            device=device,
            generator=torch.Generator().manual_seed(int(seed)),
        ).eval()
        self.device = next(self.model.parameters()).device
        self.cs = CubedSphere(config.data.grid_n)
        self.state: TrainState | ServingState | None = None
        self.stats: dict | None = None

    # -- data wiring -------------------------------------------------------
    def _dataset(self, store, *, shuffle: bool) -> SeriesDataset:
        lat, lon = self.cs.cell_latlon
        self._check_store_spacing(store)
        return SeriesDataset(
            store,
            self.config.data,
            lat=lat,
            lon=lon,
            batch_size=self.config.train.batch_size,
            shuffle=shuffle,
            seed=self.config.train.seed,
            interval=self.config.data.interval,
        )

    def _check_store_spacing(self, store):
        """Store spacing x interval must equal ``DataConfig.step_hours``:
        the rollout advances its insolation clock by step_hours, and a
        mismatch would phase-shift the forcing and mislabel lead times."""
        dt = np.diff(np.asarray(store.times, np.float64))
        if len(dt) and not np.allclose(dt, dt[0], rtol=1e-6):
            raise ValueError("store times are not uniformly spaced")
        if len(dt):
            eff_hours = float(dt[0]) * self.config.data.interval * 24.0
            if abs(eff_hours - self.config.data.step_hours) > 1e-6:
                raise ValueError(
                    f"store spacing x interval = {eff_hours:g} h per model "
                    f"step, but DataConfig.step_hours = "
                    f"{self.config.data.step_hours:g}: set interval/"
                    "step_hours so they agree"
                )

    def _norm_fn(self, store):
        """Window normalizer: ``(x - mean) / std``, or the identity for a
        store normalized already (``attrs['normalized']``, the contract
        ``SeriesDataset`` honours at fit time: normalizing it again would
        feed the model doubly normalized inputs)."""
        if getattr(store, "attrs", {}).get("normalized"):
            return lambda x: np.asarray(x, np.float32)
        mean = np.asarray(self.stats["mean"], np.float32)
        std = np.asarray(self.stats["std"], np.float32)
        return lambda x: (np.asarray(x, np.float32) - mean) / std

    def _store_constants(self, store):
        names = self.config.data.constants
        if store.constants is None or not len(names):
            return None
        return select_constants(store, names)

    def _set_stats(self, stats: dict) -> None:
        missing = [k for k in _STATS_KEYS if k not in stats]
        if missing:
            raise KeyError(f"stats missing {missing}")
        self.stats = {
            "mean": np.asarray(stats["mean"], np.float32),
            "std": np.asarray(stats["std"], np.float32),
            "insol_mean": float(stats["insol_mean"]),
            "insol_std": float(stats["insol_std"]),
        }

    def _set_model_params(self, params: dict) -> None:
        """Copy trained parameters into the model that serving runs."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])

    # -- training ----------------------------------------------------------
    def fit(self, store, *, val_store=None, workdir=None, epochs=None,
            mesh=None, verbose: bool = True):
        """Train on a predictor store (a ``MemoryStore``); returns self.

        Starts from the seeded initialisation of ``config.train.seed`` (or
        from the parameters :meth:`load_state` set, or the state of an
        earlier ``fit`` / :meth:`load`).  ``mesh``: data-parallel training
        (``Trainer(mesh=...)``), a collective call: every rank of the mesh
        calls ``fit`` with the same store, the seeded shuffle gives every
        rank the same batches, and each rank's prefetcher copies only its
        block to the device; rank 0 alone writes under ``workdir``.
        """
        train_ds = self._dataset(store, shuffle=True)
        self._set_stats({
            "mean": store.mean, "std": store.std,
            "insol_mean": train_ds.insol_mean, "insol_std": train_ds.insol_std,
        })
        val_ds = self._dataset(val_store, shuffle=False) if val_store else None
        trainer = Trainer(
            self.model,
            self.config.train,
            area_weights=(
                self.cs.area_weights if self.config.train.area_weighted_loss else None
            ),
            workdir=workdir,
            mesh=mesh,
        )
        if self.state is None:
            x0, _ = train_ds.make_batch(train_ds._starts[:1])
            self.state = trainer.init(x0)
        elif isinstance(self.state, ServingState):
            self.state = init_state(params_of(self.model), trainer.optimizer)
        dev = self.device
        try:
            self.state = trainer.fit(
                self.state,
                lambda: prefetch_to_device(iter(train_ds), device=dev, sharding=mesh),
                val_data=(
                    (lambda: prefetch_to_device(iter(val_ds), device=dev, sharding=mesh))
                    if val_ds else None
                ),
                epochs=epochs,
                verbose=verbose,
            )
        finally:
            trainer.close()
        self._set_model_params(self.state.params)
        self._last_history = trainer.history
        return self

    def load_state(self, stats: dict, params=None) -> "DLWPEstimator":
        """Set the normalization ``stats`` (``mean``/``std`` per variable,
        ``insol_mean``/``insol_std``) and, when given, the flax parameter
        tree ``params`` (:func:`load_jax_params`)."""
        self._set_stats(stats)
        if params is not None:
            load_jax_params(self.model, params)
        self.state = ServingState(params=dict(self.model.named_parameters()))
        return self

    # -- inference ---------------------------------------------------------
    def forecast(self, store, *, init_indices, steps: int) -> Forecast:
        """Autoregressive forecast from store samples, normalized, on the
        estimator's device.

        ``init_indices``: the store sample index of each initialization's
        last input time; ``steps``: model calls (each emits
        ``output_time_steps``).  Each initialization's insolation runs from
        its own init time (float64, reduced modulo the insolation period
        before the float32 clock).
        """
        if self.state is None or self.stats is None:
            raise RuntimeError("fit or load the estimator first")
        dcfg = self.config.data
        t_in, iv = dcfg.input_time_steps, dcfg.interval
        self._check_store_spacing(store)
        norm = self._norm_fn(store)
        init_indices = np.asarray(init_indices)
        need = (t_in - 1) * iv
        if np.any(init_indices < need):
            bad = int(init_indices[init_indices < need][0])
            raise ValueError(
                f"init index {bad} needs {need} preceding store samples for a "
                f"{t_in}-step input window at interval {iv}"
            )
        windows = np.stack([norm(store.fields[i - need : i + 1 : iv]) for i in init_indices])
        lat, lon = self.cs.cell_latlon
        est = TimeSeriesEstimator(
            model=self.model, data_cfg=dcfg, lat=lat, lon=lon,
            constants=self._store_constants(store), insol_mean=self.stats["insol_mean"],
            insol_std=self.stats["insol_std"], device=self.device,
        )
        t0 = np.asarray(store.times, np.float64)[init_indices]
        return est.predict(windows, t0, steps=steps)

    def forecast_lagged(self, store, *, init_indices, steps: int, lags,
                        keep_members: bool = False) -> EnsembleForecast:
        """Lagged-average-forecast ensemble from store samples, normalized.

        Member ``m`` starts ``lags[m]`` model steps before each control index
        (``lags[0]`` is 0); every member rolls far enough to cover the
        control's leads and is aligned by valid time
        (:func:`~dlwp_cs_tpu_torch.rollout.ensemble.make_lagged_rollout`).
        """
        if self.state is None or self.stats is None:
            raise RuntimeError("fit or load the estimator first")
        dcfg = self.config.data
        t_in, iv = dcfg.input_time_steps, dcfg.interval
        lags = tuple(int(g) for g in lags)
        self._check_store_spacing(store)
        norm = self._norm_fn(store)
        init_indices = np.asarray(init_indices)
        need = (t_in - 1) * iv + max(lags) * iv
        if np.any(init_indices < need):
            bad = int(init_indices[init_indices < need][0])
            raise ValueError(
                f"init index {bad} needs {need} preceding store samples for a "
                f"{t_in}-step window at interval {iv} with max lag {max(lags)}"
            )
        win = (t_in - 1) * iv
        windows = np.stack([
            np.stack([norm(store.fields[i - g * iv - win : i - g * iv + 1 : iv]) for g in lags])
            for i in init_indices
        ])  # (B, M, T_in, 6, n, n, C)
        lat, lon = self.cs.cell_latlon
        fn = make_lagged_rollout(
            self.model, dcfg, lat=lat, lon=lon, constants=self._store_constants(store),
            insol_mean=self.stats["insol_mean"], insol_std=self.stats["insol_std"],
            steps=steps, lags=lags, keep_members=keep_members, device=self.device,
        )
        t0 = np.asarray(store.times, np.float64)[init_indices]
        t0_red = np.mod(t0, INSOLATION_PERIOD_DAYS).astype(np.float32)
        fc = fn(windows, t0_red)
        return fc._replace(init_times=t0, variables=tuple(dcfg.variables))

    def denormalize(self, fields):
        """Undo the store normalization on forecast fields (numpy, or a
        tensor on any device): a numpy array in physical units."""
        if isinstance(fields, torch.Tensor):
            fields = fields.detach().cpu().numpy()
        mean = np.asarray(self.stats["mean"], np.float32)
        std = np.asarray(self.stats["std"], np.float32)
        return np.asarray(fields) * std + mean

    def replace_config(self, **kwargs) -> "DLWPEstimator":
        """A new estimator on the same device with updated config fields
        (the state is not carried over)."""
        return DLWPEstimator(dataclasses.replace(self.config, **kwargs), device=self.device)

    # -- persistence -------------------------------------------------------
    def save(self, path) -> Path:
        """Write the state (``path/step_<step>``), ``experiment.json`` and
        ``stats.json``; returns ``path``."""
        if self.state is None or self.stats is None:
            raise RuntimeError("nothing to save: fit or load first")
        state = self.state
        if isinstance(state, ServingState):  # no optimizer state yet
            state = init_state(params_of(self.model), make_optimizer(self.config.train))
        path = Path(path)
        save_checkpoint(path, state, step=int(state.step))
        save_json(path / "experiment.json", self.config.to_json())
        save_json(path / "stats.json", {
            "mean": [float(v) for v in self.stats["mean"]],
            "std": [float(v) for v in self.stats["std"]],
            "insol_mean": self.stats["insol_mean"],
            "insol_std": self.stats["insol_std"],
        })
        return path

    @classmethod
    def load(cls, path, *, device=None) -> "DLWPEstimator":
        """An estimator rebuilt from :meth:`save`'s files, on ``device``."""
        path = Path(path)
        config = ExperimentConfig.from_json(load_json(path / "experiment.json"))
        self = cls(config, device=device)
        template = init_state(params_of(self.model), make_optimizer(config.train))
        self.state, _ = restore_checkpoint(path, template)
        self._set_model_params(self.state.params)
        self._set_stats(load_json(path / "stats.json"))
        return self
