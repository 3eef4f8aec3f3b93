"""Cubed-sphere convolution: dispatch between the fused kernel and the
pad-then-VALID path.

The counterpart of ``dlwp_cs_tpu.ops.conv.cs_conv``: full conv semantics
(stride, dilation, bias) per face on the halo-padded field, with separate
kernels for the 4 equatorial and the 2 polar faces and no south-pole flip
(every face chart is right-handed with respect to its outward normal).

Backends:

* ``'auto'`` (and the reference's ``'pallas'`` / ``'pallas_interpret'``
  names): a 3x3 stride-1 conv runs the fused kernel
  :data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3` on a CUDA tensor
  and its plain version on a CPU tensor.  Other kernel sizes (the 1x1 head)
  take the generic path with the dual-base face select.
* ``'xla'``: the reference-style path, ``cs_pad`` then one VALID conv per
  weight group (the name the configurations use).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
from dlwp_cs_tpu_torch.ops.padding import cs_pad
from dlwp_cs_tpu_torch.ops.ringfix import add_group_bias, face_select

__all__ = ["cs_conv", "conv_halo_width"]

_KERNEL_BACKENDS = ("auto", "pallas", "pallas_interpret")
# Formulations of the reference that the port has not taken over yet.
_NOT_PORTED = {
    "ringfix": "queue 1, item 4 (ring-fix formulation)",
    "same": "queue 1, item 4 (ring-fix formulation)",
    "int8": "queue 1, item 15 (ops/quant.py)",
    "xring": "queue 1, item 15 (xring backend)",
    "xring_interpret": "queue 1, item 15 (xring backend)",
}


def conv_halo_width(kernel_size: tuple[int, int], dilation: int = 1) -> int:
    """Halo width needed for 'same'-size output with a centered odd kernel."""
    kh, kw = kernel_size
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"cubed-sphere conv requires odd kernels, got {kernel_size}")
    return max((kh - 1) // 2, (kw - 1) // 2) * dilation


def _group_conv(xp, kernel, stride, dilation):
    """Conv one face group: ``xp`` (B, F, Hp, Wp, Cin) already padded, HWIO
    ``kernel``; VALID, output in ``xp``'s dtype."""
    if kernel.shape[:2] == (1, 1) and stride == 1:
        # a 1x1 conv is a matrix product over channels (full f32 on the
        # card by default, where cuDNN's f32 convolutions default to TF32)
        return xp @ kernel[0, 0]
    b, f = xp.shape[:2]
    merged = xp.reshape((b * f,) + tuple(xp.shape[2:])).permute(0, 3, 1, 2)
    out = F.conv2d(
        merged, kernel.permute(3, 2, 0, 1), stride=stride, dilation=dilation
    )
    out = out.permute(0, 2, 3, 1)
    return out.reshape((b, f) + tuple(out.shape[1:]))


def cs_conv(
    x,
    kernel_eq,
    kernel_pole,
    *,
    bias_eq=None,
    bias_pole=None,
    stride: int = 1,
    dilation: int = 1,
    backend: str = "auto",
):
    """Cubed-sphere convolution with equatorial/polar weight groups.

    ``x`` ``(B, 6, n, n, Cin)``; ``kernel_eq`` / ``kernel_pole`` HWIO
    ``(kh, kw, Cin, Cout)`` of ``x``'s dtype; optional ``(Cout,)`` biases.
    Returns ``(B, 6, n // stride, n // stride, Cout)``.
    """
    if x.ndim != 5 or x.shape[1] != 6:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    if kernel_eq.shape != kernel_pole.shape:
        raise ValueError(
            f"kernel group shapes differ: {tuple(kernel_eq.shape)} vs "
            f"{tuple(kernel_pole.shape)}"
        )
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"conv backend {backend!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[backend]}"
        )
    if backend not in _KERNEL_BACKENDS + ("xla",):
        raise ValueError(f"unknown conv backend {backend!r}")
    kh, kw = kernel_eq.shape[0], kernel_eq.shape[1]
    is_3x3s1 = (kh, kw) == (3, 3) and stride == 1 and dilation == 1
    if backend in _KERNEL_BACKENDS and is_3x3s1:
        zb = x.new_zeros(kernel_eq.shape[-1])
        return cs_conv3x3(
            x.contiguous(),
            ext_strips(x),
            kernel_eq.to(x.dtype).contiguous(),
            kernel_pole.to(x.dtype).contiguous(),
            (zb if bias_eq is None else bias_eq).to(x.dtype).contiguous(),
            (zb if bias_pole is None else bias_pole).to(x.dtype).contiguous(),
        )
    w = conv_halo_width((kh, kw), dilation)
    if w == 0:
        xp = x  # 1x1 conv: no halo needed
    else:
        xp = cs_pad(x, w)
        # non-square kernels (e.g. 3x1): crop the surplus halo per axis so
        # the VALID conv keeps the 'same' output shape
        wy = (kh - 1) // 2 * dilation
        wx = (kw - 1) // 2 * dilation
        if wy < w:
            xp = xp[:, :, w - wy : xp.shape[2] - (w - wy)]
        if wx < w:
            xp = xp[:, :, :, w - wx : xp.shape[3] - (w - wx)]
    if backend != "xla":
        # the 1x1 head under 'auto': two full 6-face convs + face select
        out = face_select(
            _group_conv(xp, kernel_eq, stride, dilation),
            _group_conv(xp, kernel_pole, stride, dilation),
        )
        return add_group_bias(out, bias_eq, bias_pole)
    eq = _group_conv(xp[:, :4], kernel_eq, stride, dilation)
    pole = _group_conv(xp[:, 4:], kernel_pole, stride, dilation)
    return add_group_bias(torch.cat([eq, pole], dim=1), bias_eq, bias_pole)
