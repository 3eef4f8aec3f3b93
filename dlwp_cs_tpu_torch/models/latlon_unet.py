"""The lat-lon U-Net (the 2019 paper's model family).

The counterpart of ``dlwp_cs_tpu.models.latlon_unet``: the cubed-sphere
U-Net's architecture on a periodic lat-lon grid, its convolutions wrapping in
longitude and reflecting at the latitude boundaries
(:mod:`~dlwp_cs_tpu_torch.ops.latlon`).  Scope names (``enc{l}_conv{i}``,
``dec{l}_conv{i}``, ``head``; parameters ``kernel`` and ``bias``) are the
reference's, so its parameter tree loads by name
(:func:`~dlwp_cs_tpu_torch.models.weights.load_jax_params`).

Layout: ``(B, H=lat, W=lon, C)`` channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.models.config import UNetConfig
from dlwp_cs_tpu_torch.models.layers import lecun_normal_
from dlwp_cs_tpu_torch.models.unet import _activation
from dlwp_cs_tpu_torch.ops.latlon import latlon_conv
from dlwp_cs_tpu_torch.ops.pooling import pool2d, upsample2d

__all__ = ["LatLonConv2D", "LatLonUNet"]


class LatLonConv2D(nn.Module):
    """Conv2D with periodic-longitude padding and ``lat_mode`` latitude
    padding: HWIO ``kernel`` and ``bias`` kept in float32 and cast to the
    compute ``dtype`` (``None``: the input's) before the conv.  Parameters
    are made on the CPU from ``generator``; move the module afterwards."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3), *, stride: int = 1,
                 use_bias: bool = True, lat_mode: str = "reflect",
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.lat_mode = lat_mode
        self.dtype = dtype
        kshape = (*kernel_size, in_channels, features)
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(kshape), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        k, b = self.kernel, self.bias
        if self.dtype is not None:
            x, k = x.to(self.dtype), k.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return latlon_conv(x, k, bias=b, stride=self.stride, lat_mode=self.lat_mode)


class LatLonUNet(nn.Module):
    """Encoder/decoder CNN on a periodic lat-lon grid.

    ``(B, H, W, in_channels) -> (B, H, W, output_channels)`` float32; H and
    W must divide by ``2**(len(filters) - 1)``.  Parameters are drawn from
    ``generator`` on the CPU in call order, then moved to ``device``
    (``None``: the GPU, which must exist).
    """

    def __init__(self, config: UNetConfig, in_channels: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.in_channels = in_channels
        self.act = _activation(config)
        self.dtype = getattr(torch, config.compute_dtype)
        self.convs = nn.ModuleDict()

        def add(name, cin, feats, ksize):
            self.convs[name] = LatLonConv2D(cin, feats, tuple(ksize), dtype=self.dtype,
                                            generator=generator)

        def block(name, cin, feats):
            for i in range(config.convs_per_block):
                add(f"{name}_conv{i}", cin if i == 0 else feats, feats, config.kernel_size)

        filters = config.filters
        depth = len(filters)
        cin = in_channels
        for level, feats in enumerate(filters[:-1]):
            block(f"enc{level}", cin, feats)
            cin = feats
        block(f"enc{depth - 1}", cin, filters[-1])
        for level in range(depth - 2, -1, -1):
            block(f"dec{level}", filters[level + 1] + filters[level], filters[level])
        add("head", filters[0], config.output_channels, config.final_kernel_size)
        self.to(dev)

    def jax_scopes(self) -> dict:
        """The reference's flax scope of each conv layer."""
        return dict(self.convs.items())

    def _block(self, x, name):
        for i in range(self.config.convs_per_block):
            x = self.act(self.convs[f"{name}_conv{i}"](x))
        return x

    def forward(self, x):
        cfg = self.config
        depth = len(cfg.filters)
        h, w = x.shape[-3], x.shape[-2]
        div = 2 ** (depth - 1)
        if h % div or w % div:
            raise ValueError(f"grid {(h, w)} not divisible by 2**{depth - 1}")
        x = x.to(self.dtype)
        skips = []
        for level in range(depth - 1):
            x = self._block(x, f"enc{level}")
            skips.append(x)
            x = pool2d(x, 2, cfg.pooling)
        x = self._block(x, f"enc{depth - 1}")
        for level in range(depth - 2, -1, -1):
            x = upsample2d(x, 2, cfg.upsample)
            x = torch.cat([x, skips[level]], dim=-1)
            x = self._block(x, f"dec{level}")
        return self.convs["head"](x).float()
