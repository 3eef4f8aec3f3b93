from dlwp_cs_tpu_torch.rollout.ensemble import (
    EnsembleForecast,
    EnsembleForecaster,
    ic_perturbations,
    make_ensemble_rollout,
    make_lagged_rollout,
    make_multimodel_rollout,
    stack_params,
)
from dlwp_cs_tpu_torch.rollout.estimator import (
    Forecast,
    TimeSeriesEstimator,
    make_rollout_fn,
)

__all__ = [
    "EnsembleForecast",
    "EnsembleForecaster",
    "Forecast",
    "TimeSeriesEstimator",
    "ic_perturbations",
    "make_ensemble_rollout",
    "make_lagged_rollout",
    "make_multimodel_rollout",
    "make_rollout_fn",
    "stack_params",
]
