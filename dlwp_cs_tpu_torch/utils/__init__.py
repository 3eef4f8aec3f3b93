"""Utilities: checkpointing, JSON IO, time conversions, index splits, NaN
handling and profiling."""

from dlwp_cs_tpu_torch.utils.misc import (
    datetime_to_days,
    day_of_year,
    days_to_datetime,
    delete_nan_samples,
    train_test_split_ind,
)
from dlwp_cs_tpu_torch.utils.profiling import Timer, conv_roofline, trace
from dlwp_cs_tpu_torch.utils.checkpoint import (
    latest_step,
    load_json,
    restore_aux,
    restore_checkpoint,
    save_checkpoint,
    save_json,
    wait_for_checkpoints,
)

__all__ = [
    "datetime_to_days",
    "day_of_year",
    "days_to_datetime",
    "delete_nan_samples",
    "train_test_split_ind",
    "Timer",
    "conv_roofline",
    "trace",
    "latest_step",
    "load_json",
    "restore_aux",
    "restore_checkpoint",
    "save_checkpoint",
    "save_json",
    "wait_for_checkpoints",
]
