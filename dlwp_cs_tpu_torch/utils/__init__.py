from dlwp_cs_tpu_torch.utils.checkpoint import (
    latest_step,
    load_json,
    restore_aux,
    restore_checkpoint,
    save_checkpoint,
    save_json,
)
from dlwp_cs_tpu_torch.utils.misc import datetime_to_days, days_to_datetime

__all__ = [
    "datetime_to_days",
    "days_to_datetime",
    "latest_step",
    "load_json",
    "restore_aux",
    "restore_checkpoint",
    "save_checkpoint",
    "save_json",
]
