"""Serving: the batched rollout service, its exported artifacts and the HTTP
front end (the counterpart of ``dlwp_cs_tpu.serve``)."""

from dlwp_cs_tpu_torch.serve.export import (
    ExportedForecastService,
    ExportedForecaster,
    export_forecaster,
)
from dlwp_cs_tpu_torch.serve.http import (
    ForecastHTTPServer,
    ensemble_request,
    forecast_request,
    serve_forever,
)
from dlwp_cs_tpu_torch.serve.service import (
    ForecastService,
    MicroBatcher,
    RequestTimeout,
    ServiceOverloaded,
    ServiceStats,
)

__all__ = [
    "ExportedForecastService",
    "ExportedForecaster",
    "ForecastHTTPServer",
    "ForecastService",
    "MicroBatcher",
    "RequestTimeout",
    "ServiceOverloaded",
    "ServiceStats",
    "ensemble_request",
    "export_forecaster",
    "forecast_request",
    "serve_forever",
]
