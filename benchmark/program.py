"""What the benchmark takes from the program under test,
``dlwp_cs_tpu_torch``: its configuration classes, estimator and service,
built from a configuration file and handed the benchmark's weights.
Imported inside functions, so that the harness and its tests load
without it."""

from __future__ import annotations

import json


def experiment(cfg: dict):
    from dlwp_cs_tpu_torch.models.config import ExperimentConfig

    return ExperimentConfig.from_json(json.dumps(
        {"data": cfg["data"], "model": cfg["model"], "train": {}}))


def estimator(cfg: dict, weights: dict, device):
    """A serving estimator with the configuration's statistics and the
    benchmark's weights (by name, strict)."""
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator

    est = DLWPEstimator(experiment(cfg), device=device, seed=0)
    est.load_state(cfg["stats"])
    est.model.load_state_dict(weights, strict=True)
    return est


def service(cfg: dict, weights: dict, constants, device, **kwargs):
    from dlwp_cs_tpu_torch.serve.service import ForecastService

    return ForecastService(estimator(cfg, weights, device), constants=constants, **kwargs)
