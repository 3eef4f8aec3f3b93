from dlwp_cs_tpu_torch.serve.service import (
    ForecastService,
    MicroBatcher,
    RequestTimeout,
    ServiceOverloaded,
    ServiceStats,
)

__all__ = [
    "ForecastService",
    "MicroBatcher",
    "RequestTimeout",
    "ServiceOverloaded",
    "ServiceStats",
]
