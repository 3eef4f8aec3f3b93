"""Estimator facade: config, model, stats and parameters in one object.

The counterpart of ``dlwp_cs_tpu.estimator.DLWPEstimator``: ``fit`` trains
on a predictor store (``SeriesDataset`` -> ``prefetch_to_device`` ->
``Trainer``), ``save`` / ``load`` persist the training state with the
JSON config and stats, and serving reads ``config``, ``model``, ``cs``,
``state`` and ``stats``.  :meth:`DLWPEstimator.load_state` fills it for
serving from the reference's parameter tree (or the model's own seeded
initialisation) plus the normalization statistics.  The reference's
``forecast``, ``forecast_lagged``, ``denormalize`` and ``replace_config``
are not ported yet (ROADMAP.md queue 1, item 12): ``ForecastService``
serves a forecast from a window, not from a store and init indices, and
nothing rolls a lagged ensemble.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.data.prefetch import prefetch_to_device
from dlwp_cs_tpu_torch.data.series import SeriesDataset
from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.models import build_model
from dlwp_cs_tpu_torch.models.config import ExperimentConfig
from dlwp_cs_tpu_torch.models.weights import load_jax_params
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
        earlier ``fit`` / :meth:`load`).  ``mesh`` (data-parallel or
        sharded training) is the next slice of ``parallel/`` and raises in
        ``Trainer``; serving under a mesh is ``ForecastService(mesh=...)``.
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
                lambda: prefetch_to_device(iter(train_ds), device=dev),
                val_data=(
                    (lambda: prefetch_to_device(iter(val_ds), device=dev)) if val_ds else None
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
