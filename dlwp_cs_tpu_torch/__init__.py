"""PyTorch/CUDA port of ``dlwp_cs_tpu`` for NVIDIA Hopper (H100).

Serving and training slices: cubed-sphere geometry and insolation, halo
padding, the fused 3x3 cubed-sphere conv and its backward and the xring
conv's ring-fix kernels (hand-written CUDA kernels, ``csrc/``), the
ring-fix conv, the U-Net and the ConvLSTM, losses, the optimizer and
trainer, the data feed (``SeriesDataset``, prefetching), checkpoints, the
autoregressive rollout, ensembles, verification, spatially sharded serving
and training (data-parallel and spatial steps, sequence training) and the
kernel tools.  Serving is complete: the micro-batching forecast service
(also under a device mesh, with a rank-0 front end), exported artifacts
replayed as one CUDA graph per forecast, and the HTTP front end.  Beside
them: the barotropic baseline (``barotropic``), plots (``plot``) and
profiling helpers (``utils``).
Entry points run on the GPU unless the caller passes ``device="cpu"``.  This
package imports neither JAX nor ``dlwp_cs_tpu``.
"""

from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models.config import (
    ConvLSTMConfig,
    DataConfig,
    ExperimentConfig,
    TrainConfig,
    UNetConfig,
)
from dlwp_cs_tpu_torch.rollout.estimator import Forecast, TimeSeriesEstimator
from dlwp_cs_tpu_torch.serve.service import ForecastService
from dlwp_cs_tpu_torch.train.trainer import Trainer

__all__ = [
    "ConvLSTMConfig",
    "DLWPEstimator",
    "DataConfig",
    "ExperimentConfig",
    "Forecast",
    "ForecastService",
    "TimeSeriesEstimator",
    "TrainConfig",
    "Trainer",
    "UNetConfig",
]
