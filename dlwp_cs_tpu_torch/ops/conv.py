"""Cubed-sphere convolution: dispatch between the conv formulations.

The counterpart of ``dlwp_cs_tpu.ops.conv.cs_conv``: full conv semantics
(stride, dilation, bias) per face on the halo-padded field, with separate
kernels for the 4 equatorial and the 2 polar faces and no south-pole flip
(every face chart is right-handed with respect to its outward normal).

Backends:

* ``'auto'`` (and the reference's ``'pallas'`` / ``'pallas_interpret'``
  names): a 3x3 stride-1 conv runs
  :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_fused`, forward and
  backward on the hand-written kernels on a CUDA tensor and on their plain
  versions on a CPU tensor (the reference's ``"fused"`` backward; its other
  backward modes are TPU ablations of the same map: under
  :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.use_pallas_backward` every
  mode runs this backward).
* ``'xring'`` (and the reference's ``'xring_interpret'``): a 3x3 stride-1
  conv runs :func:`~dlwp_cs_tpu_torch.ops.ring_kernel.cs_conv3x3_xring`,
  two cuDNN SAME convs and the hand-written ring-fix kernel (zero biases
  when none are given).
* ``'ringfix'``: a 3x3 stride-1 conv runs
  :func:`~dlwp_cs_tpu_torch.ops.ringfix.cs_conv3x3_ringfix` (plain torch).
* ``'same'``: per-face zero-padded SAME convs with no halo at all, wrong at
  the face edges; the reference's lower bound for the halo's cost.
* ``'xla'``: the reference-style path, ``cs_pad`` then one VALID conv per
  weight group (the name the configurations use).
* ``'int8'``: a 3x3 stride-1 conv runs
  :func:`~dlwp_cs_tpu_torch.ops.quant.cs_conv3x3_int8`, the quantized
  inference path (int8 base convs on the hand-written s8 kernel, the ring
  term and the bias unquantized).

Under ``'auto'`` and ``'xring'``, a CUDA tensor whose shape a plan of
the kernels its wrapper would launch refuses
(:func:`~dlwp_cs_tpu_torch.ops.hopper_conv.fused_fits`: the forward plan,
the dx and dw plans where the backward will launch them;
:func:`~dlwp_cs_tpu_torch.ops.ring_kernel.xring_fits` under ``'xring'``)
takes :func:`~dlwp_cs_tpu_torch.ops.ringfix.cs_conv3x3_ringfix`, the
reference's last resort, as the reference's ``'auto'`` does past its
kernels' gates.  Under ``'pallas'`` / ``'pallas_interpret'`` such a conv
raises ``ValueError``, as the reference's does.  The choice is made from
the plans before anything launches; a launch that fails still raises.  CPU
tensors keep their path: the plain versions fit every shape.

Under every backend but ``'xla'``, other kernel sizes (the 1x1 head) take
the generic path with the dual-base face select.

The spatially decomposed path (:mod:`dlwp_cs_tpu_torch.parallel`) installs
two hooks around the model: a halo-exchange pad
(:func:`~dlwp_cs_tpu_torch.ops.padding.use_pad_impl`) and, optionally, a
shard-local 3x3 conv (:func:`use_conv3x3_impl`), which then runs every 3x3
stride-1 conv before any backend is consulted.  Under an installed pad with
no installed 3x3 conv, every 3x3 conv goes pad-then-VALID through the
installed pad: the single-device formulations (the fused kernel, ``xring``,
``ringfix``) read neighbour faces directly, which a shard's block does not
hold.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_fused, fused_fits
from dlwp_cs_tpu_torch.ops.library import (
    cs_conv3x3_op,
    library_ops_enabled,
    xring_fused_apply_op,
)
from dlwp_cs_tpu_torch.ops import padding as _padding
from dlwp_cs_tpu_torch.ops.padding import cs_pad, use_pad_impl
from dlwp_cs_tpu_torch.ops.quant import cs_conv3x3_int8
from dlwp_cs_tpu_torch.ops.ring_kernel import _xring_forward, cs_conv3x3_xring, xring_fits
from dlwp_cs_tpu_torch.ops.ringfix import (
    _same_conv,
    add_group_bias,
    cs_conv3x3_ringfix,
    face_select,
)

__all__ = [
    "conv_halo_width",
    "cs_conv",
    "shard_local_region",
    "use_conv3x3_impl",
]

_KERNEL_BACKENDS = ("auto", "pallas", "pallas_interpret")
_XRING_BACKENDS = ("xring", "xring_interpret")
_BACKENDS = _KERNEL_BACKENDS + _XRING_BACKENDS + ("ringfix", "int8", "same", "xla")
# the backends that take ring-fix where a kernel's plan refuses (the
# reference's 'auto'; its 'xring' has no fallback: ROADMAP.md's recorded
# divergences); 'pallas' raises there, as the reference's does
_RINGFIX_PAST_PLANS = ("auto",) + _XRING_BACKENDS

_CONV3_IMPL: contextvars.ContextVar = contextvars.ContextVar("cs_conv3x3_impl", default=None)


@contextlib.contextmanager
def use_conv3x3_impl(fn):
    """Within this context, 3x3 stride-1 ``cs_conv`` calls delegate to
    ``fn(x, kernel_eq, kernel_pole, bias_eq, bias_pole)`` whatever their
    backend (``None`` clears it); other convs keep their dispatch."""
    token = _CONV3_IMPL.set(fn)
    try:
        yield
    finally:
        _CONV3_IMPL.reset(token)


def _pad_impl_installed() -> bool:
    """True under an installed pad (a shard's local block): the
    single-device 3x3 formulations would read neighbour faces that the block
    does not hold."""
    return _padding._PAD_IMPL.get() is not None


@contextlib.contextmanager
def shard_local_region():
    """The enclosed code holds complete faces on every shard (data
    parallelism only): any installed pad and 3x3 conv are cleared, so the
    single-device dispatch, the fused kernel included, applies again."""
    with use_pad_impl(None), use_conv3x3_impl(None):
        yield


def conv_halo_width(kernel_size: tuple[int, int], dilation: int = 1) -> int:
    """Halo width needed for 'same'-size output with a centered odd kernel."""
    kh, kw = kernel_size
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"cubed-sphere conv requires odd kernels, got {kernel_size}")
    return max((kh - 1) // 2, (kw - 1) // 2) * dilation


def _sm_count(x):
    """The SM count the kernel wrappers plan with on ``x``'s card; None for
    a CPU tensor, whose wrappers run the plain versions (they fit every
    shape)."""
    return cs_conv3x3._sm_count[cs_conv3x3._device(x)] if x.is_cuda else None


def _kernels_fit(x, kernel_eq, kernel_pole, bias_eq, bias_pole, backend: str) -> bool:
    """Whether the kernels that ``backend``'s wrapper would launch for this
    whole-face 3x3 conv plan it (true on the CPU): :func:`xring_fits` under
    ``'xring'``, else :func:`fused_fits`, asked for the dx kernel where
    ``x`` will get a gradient and for the dw kernel where a weight or a
    bias will."""
    sm_count = _sm_count(x)
    if sm_count is None:
        return True
    b, _, n, _, cin = x.shape
    cout = kernel_eq.shape[-1]
    if backend in _XRING_BACKENDS:
        return xring_fits(x.dtype, b, n, cin, cout, sm_count)
    grad = torch.is_grad_enabled()
    dx = grad and x.requires_grad
    dw = grad and any(t is not None and t.requires_grad
                      for t in (kernel_eq, kernel_pole, bias_eq, bias_pole))
    return fused_fits(x.dtype, b, n, cin, cout, sm_count, dx, dw)


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

    ``x`` ``(B, 6, n, n, Cin)``, whole faces; under an installed pad
    (:func:`~dlwp_cs_tpu_torch.ops.padding.use_pad_impl`) a shard's local
    block ``(B, 6, H, W, Cin)`` of every face.  ``kernel_eq`` /
    ``kernel_pole`` HWIO ``(kh, kw, Cin, Cout)`` of ``x``'s dtype; optional
    ``(Cout,)`` biases.  Returns ``(B, 6, H // stride, W // stride, Cout)``.
    """
    if x.ndim != 5 or x.shape[1] != 6:
        raise ValueError(f"expected (B, 6, H, W, C), got {tuple(x.shape)}")
    if kernel_eq.shape != kernel_pole.shape:
        raise ValueError(
            f"kernel group shapes differ: {tuple(kernel_eq.shape)} vs "
            f"{tuple(kernel_pole.shape)}"
        )
    if backend not in _BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}")
    kh, kw = kernel_eq.shape[0], kernel_eq.shape[1]
    is_3x3s1 = (kh, kw) == (3, 3) and stride == 1 and dilation == 1
    impl = _CONV3_IMPL.get()
    if impl is not None and is_3x3s1:
        return impl(x, kernel_eq, kernel_pole, bias_eq, bias_pole)
    whole_faces = not _pad_impl_installed()
    if (is_3x3s1 and whole_faces and backend in _KERNEL_BACKENDS + _XRING_BACKENDS
            and not _kernels_fit(x, kernel_eq, kernel_pole, bias_eq, bias_pole, backend)):
        if backend not in _RINGFIX_PAST_PLANS:
            raise ValueError(
                f"{backend} backend requested but configuration unsupported: a plan of "
                f"its kernels refuses {x.dtype} {tuple(x.shape)} -> {kernel_eq.shape[-1]}")
        backend = "ringfix"  # past a kernel's plan: the reference's last resort
    if is_3x3s1 and whole_faces and backend in _KERNEL_BACKENDS + _XRING_BACKENDS:
        kernels = (kernel_eq.to(x.dtype).contiguous(), kernel_pole.to(x.dtype).contiguous())
        biases = tuple(
            (x.new_zeros(kernel_eq.shape[-1]) if b is None else b).to(x.dtype).contiguous()
            for b in (bias_eq, bias_pole)
        )
        if library_ops_enabled(x, kernel_eq, kernel_pole, bias_eq, bias_pole):
            # inference through the registered operators (torch.export)
            if backend in _XRING_BACKENDS:
                return _xring_forward(x.contiguous(), *kernels, *biases,
                                      apply=xring_fused_apply_op)
            return cs_conv3x3_op(x.contiguous(), ext_strips(x), *kernels, *biases)
        if backend in _XRING_BACKENDS:
            return cs_conv3x3_xring(x, *kernels, *biases)
        return cs_conv3x3_fused(x.contiguous(), ext_strips(x), *kernels, *biases)
    if is_3x3s1 and whole_faces and backend == "ringfix":
        return cs_conv3x3_ringfix(x, kernel_eq, kernel_pole, bias_eq=bias_eq,
                                  bias_pole=bias_pole)
    if is_3x3s1 and whole_faces and backend == "int8":
        # the quantized inference path; other layers (the 1x1 head) and 3x3
        # convs under an installed pad take the generic path below
        return cs_conv3x3_int8(x, kernel_eq, kernel_pole, bias_eq=bias_eq,
                               bias_pole=bias_pole)
    if is_3x3s1 and backend == "same":
        out = torch.cat(
            [_same_conv(x[:, :4], kernel_eq), _same_conv(x[:, 4:], kernel_pole)], dim=1
        )
        return add_group_bias(out, bias_eq, bias_pole)
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
        # the 1x1 head, and 3x3 convs under an installed pad, under every
        # backend but 'xla': two full 6-face convs + face select
        out = face_select(
            _group_conv(xp, kernel_eq, stride, dilation),
            _group_conv(xp, kernel_pole, stride, dilation),
        )
        return add_group_bias(out, bias_eq, bias_pole)
    eq = _group_conv(xp[:, :4], kernel_eq, stride, dilation)
    pole = _group_conv(xp[:, 4:], kernel_pole, stride, dilation)
    return add_group_bias(torch.cat([eq, pole], dim=1), bias_eq, bias_pole)
