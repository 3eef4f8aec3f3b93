"""Lat-lon grid padding and convolution.

The counterpart of ``dlwp_cs_tpu.ops.latlon`` (the legacy lat-lon models of
the 2019 paper): periodic (wrap) padding in longitude, a configurable
treatment in latitude, and the 'same' conv built on it.

Layout: ``(..., H=lat, W=lon, C)`` channels-last.

The conv is one VALID ``F.conv2d`` on the padded grid (cuDNN on the card,
as the reference's is ``lax.conv``); like the cubed-sphere SAME convs
(:mod:`~dlwp_cs_tpu_torch.ops.ringfix`) it runs in full float32 for float32
inputs whatever ``torch.backends.cudnn.allow_tf32`` says, forward and
backward, and its backward with deterministic algorithms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dlwp_cs_tpu_torch.ops.ringfix import _cudnn_flags

__all__ = ["latlon_conv", "periodic_pad"]

_LAT_MODES = ("symmetric", "reflect", "polar", "zero")


def periodic_pad(x, width, lat_mode: str = "symmetric"):
    """Pad longitude periodically and latitude by ``lat_mode``.

    ``width``: int (both axes) or ``(w_lat, w_lon)``.  ``lat_mode``:

    * ``'symmetric'`` (alias ``'reflect'``): the boundary rows mirrored
      outward (``np.pad`` "symmetric");
    * ``'zero'``: zero rows;
    * ``'polar'``: the row beyond a pole is the boundary-adjacent row rolled
      by half the longitudes (what lies across the pole); needs an even W.

    Latitude is padded first, on the original W columns (the polar roll is
    defined on them), then longitude wraps, ghost rows included.  ``x``
    ``(..., H, W, C)`` -> ``(..., H + 2 w_lat, W + 2 w_lon, C)``.
    """
    w_lat, w_lon = (width, width) if isinstance(width, int) else width
    if w_lat < 0 or w_lon < 0 or (w_lat == 0 and w_lon == 0):
        raise ValueError(f"invalid pad widths {(w_lat, w_lon)}")
    if lat_mode not in _LAT_MODES:
        raise ValueError(f"unknown lat_mode {lat_mode!r}")
    if w_lat:
        top = torch.flip(x[..., :w_lat, :, :], dims=(-3,))
        bot = torch.flip(x[..., -w_lat:, :, :], dims=(-3,))
        if lat_mode == "polar":
            n_lon = x.shape[-2]
            if n_lon % 2:
                raise ValueError("lat_mode='polar' requires an even lon count")
            top = torch.roll(top, n_lon // 2, dims=-2)
            bot = torch.roll(bot, n_lon // 2, dims=-2)
        elif lat_mode == "zero":
            top, bot = torch.zeros_like(top), torch.zeros_like(bot)
        x = torch.cat([top, x, bot], dim=-3)
    if w_lon:
        x = torch.cat([x[..., :, -w_lon:, :], x, x[..., :, :w_lon, :]], dim=-2)
    return x


class _ValidConv(torch.autograd.Function):
    """VALID conv of NHWC ``x`` with the HWIO ``kernel`` at ``stride``,
    output in ``x``'s dtype, under :func:`_cudnn_flags`."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.save_for_backward(x, kernel)
        ctx.stride = stride
        with _cudnn_flags(x):
            out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=stride)
        return out.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        need = ctx.needs_input_grad
        with _cudnn_flags(x, deterministic=True):
            dx, dk, _ = torch.ops.aten.convolution_backward(
                g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                kernel.permute(3, 2, 0, 1), None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], 1, [need[0], need[1], False],
            )
        return (None if dx is None else dx.permute(0, 2, 3, 1),
                None if dk is None else dk.permute(2, 3, 1, 0), None)


def latlon_conv(x, kernel, *, bias=None, stride: int = 1, lat_mode: str = "symmetric"):
    """'Same' conv on a periodic-longitude lat-lon grid: ``x`` ``(B, H, W,
    Cin)``, HWIO ``kernel`` ``(kh, kw, Cin, Cout)`` of ``x``'s dtype (odd
    sizes), optional ``(Cout,)`` bias.  The pad is per axis ((kh-1)/2 rows,
    (kw-1)/2 columns), so non-square kernels keep the 'same' shape at stride
    1; ``stride`` applies to both axes of the VALID conv."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"odd kernels required, got {(kh, kw)}")
    w_lat, w_lon = (kh - 1) // 2, (kw - 1) // 2
    xp = periodic_pad(x, (w_lat, w_lon), lat_mode=lat_mode) if (w_lat or w_lon) else x
    out = _ValidConv.apply(xp, kernel, stride)
    if bias is not None:
        out = out + bias
    return out
