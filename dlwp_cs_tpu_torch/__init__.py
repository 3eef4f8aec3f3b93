"""PyTorch/CUDA port of ``dlwp_cs_tpu`` for NVIDIA Hopper (H100).

Serving slice: cubed-sphere geometry and insolation, halo padding, the
fused 3x3 cubed-sphere conv (a hand-written CUDA kernel, ``csrc/``), the
U-Net, the autoregressive rollout and the micro-batching forecast service.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
This package imports neither JAX nor ``dlwp_cs_tpu``.
"""

from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models.config import DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.rollout.estimator import Forecast, TimeSeriesEstimator
from dlwp_cs_tpu_torch.serve.service import ForecastService

__all__ = [
    "DLWPEstimator",
    "DataConfig",
    "ExperimentConfig",
    "Forecast",
    "ForecastService",
    "TimeSeriesEstimator",
    "UNetConfig",
]
