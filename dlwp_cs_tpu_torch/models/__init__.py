import torch

from dlwp_cs_tpu_torch.models.config import (
    ConvLSTMConfig,
    DataConfig,
    ExperimentConfig,
    TrainConfig,
    UNetConfig,
)
from dlwp_cs_tpu_torch.models.convlstm import (
    CubeSphereConvLSTM,
    CubeSphereConvLSTMCell,
    CubeSphereConvLSTMNet,
    LatLonConvLSTMCell,
)
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D
from dlwp_cs_tpu_torch.models.unet import CubeSphereUNet
from dlwp_cs_tpu_torch.models.weights import load_jax_params


def build_model(model_config, in_channels: int, *, device=None,
                generator: torch.Generator | None = None):
    """Model-family dispatch: a resolved model config -> the port's module
    for ``in_channels`` input channels, on ``device`` (``None``: the GPU),
    parameters drawn from ``generator``."""
    if isinstance(model_config, ConvLSTMConfig):
        cls = CubeSphereConvLSTMNet
    elif isinstance(model_config, UNetConfig):
        cls = CubeSphereUNet
    else:
        raise TypeError(f"unknown model config {type(model_config).__name__}")
    return cls(model_config, in_channels, device=device, generator=generator)


__all__ = [
    "ConvLSTMConfig",
    "CubeSphereConv2D",
    "CubeSphereConvLSTM",
    "CubeSphereConvLSTMCell",
    "CubeSphereConvLSTMNet",
    "CubeSphereUNet",
    "DataConfig",
    "ExperimentConfig",
    "LatLonConvLSTMCell",
    "TrainConfig",
    "UNetConfig",
    "build_model",
    "load_jax_params",
]
