"""Cubed-sphere U-Net.

The counterpart of ``dlwp_cs_tpu.models.unet.CubeSphereUNet``: encoder
blocks of ``convs_per_block`` CS convs + activation with pooling between
levels, a bottleneck, decoder blocks fed by upsampling and skip
concatenation, and a linear head.  The input is cast to the compute dtype
and the head's output to float32.  Scope names (``enc{l}_conv{i}``,
``dec{l}_conv{i}``, ``head``) are the reference's, so its parameter tree
loads by name (:func:`~dlwp_cs_tpu_torch.models.weights.load_jax_params`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.models.config import UNetConfig
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D
from dlwp_cs_tpu_torch.ops.pooling import cs_avg_pool, cs_max_pool, cs_upsample

__all__ = ["CubeSphereUNet"]


def _activation(cfg: UNetConfig):
    if cfg.activation == "leaky_relu":
        return lambda x: F.leaky_relu(x, cfg.activation_slope)
    if cfg.activation == "relu":
        return F.relu
    if cfg.activation == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # flax's default gelu
    if cfg.activation == "tanh":
        return torch.tanh
    raise ValueError(f"unknown activation {cfg.activation!r}")


class CubeSphereUNet(nn.Module):
    """Encoder/decoder CNN on the cubed sphere with skip connections.

    ``(B, 6, n, n, in_channels) -> (B, 6, n, n, output_channels)`` float32;
    ``n`` must be divisible by ``2**(len(filters) - 1)``.  Parameters are
    drawn from ``generator`` on the CPU in call order, then moved to
    ``device`` (``None``: the GPU, which must exist).
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
            self.convs[name] = CubeSphereConv2D(
                cin,
                feats,
                tuple(ksize),
                separate_polar_weights=config.separate_polar_weights,
                backend=config.conv_backend,
                dtype=self.dtype,
                generator=generator,
            )

        def block(name, cin, feats):
            for i in range(config.convs_per_block):
                add(f"{name}_conv{i}", cin if i == 0 else feats, feats,
                    config.kernel_size)

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
        n = x.shape[-2]
        if n % (2 ** (depth - 1)) != 0:
            raise ValueError(
                f"face size {n} not divisible by 2**{depth - 1} for {depth} levels"
            )
        pool = cs_avg_pool if cfg.pooling == "avg" else cs_max_pool
        x = x.to(self.dtype)
        skips = []
        for level in range(depth - 1):
            x = self._block(x, f"enc{level}")
            skips.append(x)
            x = pool(x, 2)
        x = self._block(x, f"enc{depth - 1}")
        for level in range(depth - 2, -1, -1):
            x = cs_upsample(x, 2, method=cfg.upsample)
            x = torch.cat([x, skips[level]], dim=-1)
            x = self._block(x, f"dec{level}")
        return self.convs["head"](x).float()
