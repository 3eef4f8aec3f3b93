"""Declarative configuration tree for models and experiments.

A copy of ``dlwp_cs_tpu.models.config`` (dataclasses only), so that a
configuration serialized by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "UNetConfig",
    "ConvLSTMConfig",
    "DataConfig",
    "TrainConfig",
    "ExperimentConfig",
]


@dataclass(frozen=True)
class UNetConfig:
    """Cubed-sphere U-Net architecture.

    ``filters[i]`` is the channel width at level ``i`` (level 0 = full
    resolution).  Each level applies ``convs_per_block`` CS convolutions +
    activation; average pooling down, nearest upsampling up, skip
    connections concatenated channels-wise, then a 1x1 head.
    """

    kind: str = "unet"
    output_channels: int = 8
    filters: tuple[int, ...] = (32, 64, 128)
    convs_per_block: int = 2
    kernel_size: tuple[int, int] = (3, 3)
    activation: str = "leaky_relu"
    activation_slope: float = 0.1
    pooling: str = "avg"  # 'avg' | 'max'
    upsample: str = "nearest"  # 'nearest' | 'bilinear'
    separate_polar_weights: bool = True
    final_kernel_size: tuple[int, int] = (1, 1)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    conv_backend: str = "auto"

    def __post_init__(self):
        if len(self.filters) < 1:
            raise ValueError("filters must be non-empty")
        if self.pooling not in ("avg", "max"):
            raise ValueError(f"pooling must be avg|max, got {self.pooling!r}")


@dataclass(frozen=True)
class ConvLSTMConfig:
    """Recurrent (stacked ConvLSTM) forecast network on the cubed sphere."""

    kind: str = "convlstm"
    output_channels: int = 8
    filters: tuple[int, ...] = (32, 32)
    kernel_size: tuple[int, int] = (3, 3)
    head_kernel_size: tuple[int, int] = (1, 1)
    separate_polar_weights: bool = True
    compute_dtype: str = "float32"
    conv_backend: str = "auto"
    input_time_steps: int = 2
    variable_channels: int = 4
    add_insolation: bool = True

    def __post_init__(self):
        if len(self.filters) < 1:
            raise ValueError("filters must be non-empty")


@dataclass(frozen=True)
class DataConfig:
    """What the model consumes and predicts."""

    grid_n: int = 48
    variables: tuple[str, ...] = ("z500", "z1000", "tau300-700", "t2m")
    input_time_steps: int = 2
    output_time_steps: int = 2
    step_hours: float = 6.0
    # store samples per model time step: step_hours = store_spacing * interval
    interval: int = 1
    add_insolation: bool = True
    constants: tuple[str, ...] = ("topography", "land_sea_mask")

    @property
    def n_variables(self) -> int:
        return len(self.variables)

    @property
    def input_channels(self) -> int:
        c = self.input_time_steps * self.n_variables
        if self.add_insolation:
            c += self.input_time_steps
        c += len(self.constants)
        return c

    @property
    def output_channels(self) -> int:
        return self.output_time_steps * self.n_variables


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'warmup_cosine'
    lr_warmup_steps: int = 1000
    lr_decay_steps: int = 100_000
    optimizer: str = "adam"
    weight_decay: float = 0.0
    grad_accum_steps: int = 1
    max_epochs: int = 200
    min_epochs: int = 0
    early_stopping_patience: int = 50
    restore_best_weights: bool = True
    checkpoint_every_epochs: int = 1
    area_weighted_loss: bool = False
    loss: str = "mse"  # 'mse' | 'mae'
    grad_clip_norm: float | None = None
    metrics_every: int = 8
    fused_steps: int = 1
    seed: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: Any = field(default_factory=UNetConfig)  # UNetConfig | ConvLSTMConfig
    train: TrainConfig = field(default_factory=TrainConfig)

    def resolved_model(self):
        """Model config with data-derived fields filled in."""
        if isinstance(self.model, ConvLSTMConfig):
            return dataclasses.replace(
                self.model,
                output_channels=self.data.output_channels,
                input_time_steps=self.data.input_time_steps,
                variable_channels=self.data.n_variables,
                add_insolation=self.data.add_insolation,
            )
        return dataclasses.replace(
            self.model, output_channels=self.data.output_channels
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        model_raw = raw.get("model", {})
        model_cls = (
            ConvLSTMConfig if model_raw.get("kind") == "convlstm" else UNetConfig
        )
        return cls(
            data=_load(DataConfig, raw.get("data", {})),
            model=_load(model_cls, model_raw),
            train=_load(TrainConfig, raw.get("train", {})),
        )


def _load(cls, raw: dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in raw.items():
        if k not in fields:
            raise ValueError(f"unknown {cls.__name__} field {k!r}")
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)
