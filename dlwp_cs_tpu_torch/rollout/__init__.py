from dlwp_cs_tpu_torch.rollout.estimator import (
    Forecast,
    TimeSeriesEstimator,
    make_rollout_fn,
)

__all__ = ["Forecast", "TimeSeriesEstimator", "make_rollout_fn"]
