from dlwp_cs_tpu_torch.models.config import (
    DataConfig,
    ExperimentConfig,
    TrainConfig,
    UNetConfig,
)
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D
from dlwp_cs_tpu_torch.models.unet import CubeSphereUNet
from dlwp_cs_tpu_torch.models.weights import load_jax_params

__all__ = [
    "CubeSphereConv2D",
    "CubeSphereUNet",
    "DataConfig",
    "ExperimentConfig",
    "TrainConfig",
    "UNetConfig",
    "load_jax_params",
]
