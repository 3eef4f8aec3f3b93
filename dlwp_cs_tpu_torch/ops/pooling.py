"""Per-face pooling and upsampling on the cubed sphere.

The counterpart of ``dlwp_cs_tpu.ops.pooling``: plain per-face ops on
``(..., 6, H, W, C)`` that never cross a face boundary.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["cs_avg_pool", "cs_max_pool", "cs_upsample"]


def _check(x):
    if x.ndim < 5 or x.shape[-4] != 6:
        raise ValueError(f"expected (..., 6, H, W, C), got {tuple(x.shape)}")


def _windows(x, window: int):
    _check(x)
    h, w = x.shape[-3], x.shape[-2]
    if h % window or w % window:
        raise ValueError(f"face size {(h, w)} not divisible by window {window}")
    return x.reshape(
        x.shape[:-3] + (h // window, window, w // window, window, x.shape[-1])
    )


def cs_avg_pool(x, window: int = 2):
    """Average-pool each face by ``window`` (H and W must divide evenly)."""
    return _windows(x, window).mean(dim=(-4, -2))


def cs_max_pool(x, window: int = 2):
    """Max-pool each face by ``window``."""
    return _windows(x, window).amax(dim=(-4, -2))


def cs_upsample(x, factor: int = 2, method: str = "nearest"):
    """Upsample each face by ``factor``: ``'nearest'`` repeats cells,
    ``'bilinear'`` interpolates with half-pixel centers and edge clamping
    (what ``jax.image.resize`` does when it upsamples)."""
    _check(x)
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
