"""The cubed-sphere convolution layer.

The counterpart of ``dlwp_cs_tpu.models.layers.CubeSphereConv2D``: HWIO
parameters ``kernel_eq``/``kernel_pole`` and ``bias_eq``/``bias_pole``
(one shared group when ``separate_polar_weights`` is off), kept in float32
and cast to the compute dtype before the conv.  The reference's batch->lane
packing (``lane_pack``) is a TPU matrix-unit layout for the same linear map
and has no counterpart here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dlwp_cs_tpu_torch.ops.conv import cs_conv

__all__ = ["CubeSphereConv2D", "lecun_normal_"]

# flax's lecun_normal draws a normal truncated at +-2 std, rescaled by this
# (the std of the standard normal truncated to [-2, 2]) to keep variance
# 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: torch.Generator | None = None):
    """In place: flax's ``lecun_normal`` for an HWIO kernel
    (fan_in = kh * kw * Cin), drawn from ``generator``."""
    fan_in = math.prod(t.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(
        t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


class CubeSphereConv2D(nn.Module):
    """Cubed-sphere convolution with separate equatorial/polar kernels.

    Input/output ``(B, 6, n, n, C)`` channels-last.  ``dtype`` is the
    compute dtype (parameters stay float32); ``backend`` is the
    :func:`~dlwp_cs_tpu_torch.ops.conv.cs_conv` dispatch.  Parameters are
    made on the CPU from ``generator``; move the module afterwards.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: tuple[int, int] = (3, 3),
        *,
        stride: int = 1,
        dilation: int = 1,
        use_bias: bool = True,
        separate_polar_weights: bool = True,
        backend: str = "auto",
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.separate_polar_weights = separate_polar_weights
        self.backend = backend
        self.dtype = dtype
        kshape = (*kernel_size, in_channels, features)
        self.kernel_eq = nn.Parameter(lecun_normal_(torch.empty(kshape), generator))
        if separate_polar_weights:
            self.kernel_pole = nn.Parameter(
                lecun_normal_(torch.empty(kshape), generator)
            )
        self.use_bias = use_bias
        if use_bias:
            self.bias_eq = nn.Parameter(torch.zeros(features))
            if separate_polar_weights:
                self.bias_pole = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        sep = self.separate_polar_weights
        k_eq = self.kernel_eq
        k_pole = self.kernel_pole if sep else k_eq
        b_eq = b_pole = None
        if self.use_bias:
            b_eq = self.bias_eq
            b_pole = self.bias_pole if sep else b_eq
        if self.dtype is not None:
            x = x.to(self.dtype)
            k_eq, k_pole = k_eq.to(self.dtype), k_pole.to(self.dtype)
            if b_eq is not None:
                b_eq, b_pole = b_eq.to(self.dtype), b_pole.to(self.dtype)
        return cs_conv(
            x,
            k_eq,
            k_pole,
            bias_eq=b_eq,
            bias_pole=b_pole,
            stride=self.stride,
            dilation=self.dilation,
            backend=self.backend,
        )
