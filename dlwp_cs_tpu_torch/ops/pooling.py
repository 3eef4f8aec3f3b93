"""Per-face pooling and upsampling on the cubed sphere.

The counterpart of ``dlwp_cs_tpu.ops.pooling``: plain per-face ops on
``(..., 6, H, W, C)`` that never cross a face boundary.  :func:`pool2d` and
:func:`upsample2d` are the same ops on any ``(..., H, W, C)`` grid (the
lat-lon U-Net's).
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["cs_avg_pool", "cs_max_pool", "cs_upsample", "pool2d", "upsample2d"]


def _check(x):
    if x.ndim < 5 or x.shape[-4] != 6:
        raise ValueError(f"expected (..., 6, H, W, C), got {tuple(x.shape)}")


def pool2d(x, window: int, mode: str = "avg"):
    """Average (``'avg'``) or max (``'max'``) pool ``(..., H, W, C)`` by
    ``window``; H and W must divide evenly (``ValueError``)."""
    h, w = x.shape[-3], x.shape[-2]
    if h % window or w % window:
        raise ValueError(f"grid {(h, w)} not divisible by pool window {window}")
    r = x.reshape(x.shape[:-3] + (h // window, window, w // window, window, x.shape[-1]))
    return r.amax(dim=(-4, -2)) if mode == "max" else r.mean(dim=(-4, -2))


def upsample2d(x, factor: int, method: str = "nearest"):
    """Upsample ``(..., H, W, C)`` by ``factor``: ``'nearest'`` repeats
    cells, ``'bilinear'`` interpolates with half-pixel centers and edge
    clamping (what ``jax.image.resize`` does when it upsamples)."""
    h, w, c = x.shape[-3], x.shape[-2], x.shape[-1]
    lead = x.shape[:-3]
    if method == "nearest":
        out = x[..., :, None, :, None, :].expand(lead + (h, factor, w, factor, c))
        return out.reshape(lead + (h * factor, w * factor, c))
    if method == "bilinear":
        flat = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
        out = F.interpolate(
            flat, scale_factor=factor, mode="bilinear", align_corners=False
        )
        return out.permute(0, 2, 3, 1).reshape(lead + (h * factor, w * factor, c))
    raise ValueError(f"unknown upsample method {method!r}")


def cs_avg_pool(x, window: int = 2):
    """Average-pool each face by ``window`` (H and W must divide evenly)."""
    _check(x)
    return pool2d(x, window, "avg")


def cs_max_pool(x, window: int = 2):
    """Max-pool each face by ``window``."""
    _check(x)
    return pool2d(x, window, "max")


def cs_upsample(x, factor: int = 2, method: str = "nearest"):
    """Upsample each face by ``factor`` (see :func:`upsample2d`)."""
    _check(x)
    return upsample2d(x, factor, method)
