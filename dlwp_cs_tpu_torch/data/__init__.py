from dlwp_cs_tpu_torch.data.channels import (
    advance_window,
    fold_time,
    make_input_insolation,
    pack_inputs,
    unfold_time,
)

__all__ = [
    "advance_window",
    "fold_time",
    "make_input_insolation",
    "pack_inputs",
    "unfold_time",
]
