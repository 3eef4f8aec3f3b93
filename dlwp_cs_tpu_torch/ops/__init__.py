from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3,
    cs_conv3x3_dw,
    cs_conv3x3_dx,
    cs_conv3x3_fused,
    cs_conv3x3_plain,
)
from dlwp_cs_tpu_torch.ops.padding import cs_pad

__all__ = [
    "cs_conv",
    "cs_conv3x3",
    "cs_conv3x3_dw",
    "cs_conv3x3_dx",
    "cs_conv3x3_fused",
    "cs_conv3x3_plain",
    "cs_pad",
    "ext_strips",
]
