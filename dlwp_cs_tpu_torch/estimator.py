"""Serving-side estimator facade.

The part of ``dlwp_cs_tpu.estimator.DLWPEstimator`` that serving reads:
``config``, ``model``, ``cs``, ``state.params`` and ``stats``.  It is filled
from the reference's parameter tree (or from the model's own seeded
initialisation) plus the normalization statistics.  ``fit``, ``save`` and
``load`` come with the training slice (``ROADMAP.md`` queue 1, item 10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.models.config import ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.models.unet import CubeSphereUNet
from dlwp_cs_tpu_torch.models.weights import load_jax_params

__all__ = ["DLWPEstimator", "ServingState"]

_STATS_KEYS = ("mean", "std", "insol_mean", "insol_std")


@dataclass
class ServingState:
    """The estimator's parameters, by name (``scope.param``)."""

    params: dict


class DLWPEstimator:
    """Config-driven forecast model for serving.

    ``DLWPEstimator(config, device=None, seed=0)`` builds the U-Net on
    ``device`` (``None``: the GPU, which must exist) with parameters drawn
    from ``torch.Generator().manual_seed(seed)``; :meth:`load_state` then
    sets the normalization stats and, optionally, the reference's trained
    parameters.
    """

    def __init__(self, config: ExperimentConfig, *, device=None, seed: int = 0):
        model_cfg = config.resolved_model()
        if not isinstance(model_cfg, UNetConfig):
            raise NotImplementedError(
                f"model kind {model_cfg.kind!r} is not ported yet: ROADMAP.md "
                "queue 1, item 15"
            )
        self.config = config
        self.model = CubeSphereUNet(
            model_cfg,
            config.data.input_channels,
            device=device,
            generator=torch.Generator().manual_seed(int(seed)),
        ).eval()
        self.device = next(self.model.parameters()).device
        self.cs = CubedSphere(config.data.grid_n)
        self.state: ServingState | None = None
        self.stats: dict | None = None

    def load_state(self, stats: dict, params=None) -> "DLWPEstimator":
        """Set the normalization ``stats`` (``mean``/``std`` per variable,
        ``insol_mean``/``insol_std``) and, when given, the flax parameter
        tree ``params`` (:func:`load_jax_params`)."""
        missing = [k for k in _STATS_KEYS if k not in stats]
        if missing:
            raise KeyError(f"stats missing {missing}")
        if params is not None:
            load_jax_params(self.model, params)
        self.stats = {
            "mean": np.asarray(stats["mean"], np.float32),
            "std": np.asarray(stats["std"], np.float32),
            "insol_mean": float(stats["insol_mean"]),
            "insol_std": float(stats["insol_std"]),
        }
        self.state = ServingState(params=dict(self.model.named_parameters()))
        return self
