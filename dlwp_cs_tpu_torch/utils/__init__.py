from dlwp_cs_tpu_torch.utils.checkpoint import (
    latest_step,
    load_json,
    restore_aux,
    restore_checkpoint,
    save_checkpoint,
    save_json,
)

__all__ = [
    "latest_step",
    "load_json",
    "restore_aux",
    "restore_checkpoint",
    "save_checkpoint",
    "save_json",
]
