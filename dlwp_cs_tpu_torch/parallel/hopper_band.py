"""The fused 3x3 conv on a shard's row band: kernel #8.

The counterpart of ``dlwp_cs_tpu.parallel.pallas_band``.  The band's ghost
strips come from the seam-routed collectives of
:func:`~dlwp_cs_tpu_torch.parallel.halo.halo_pieces`, run before the
kernel, so all topology stays in ``parallel/halo.py``; the hand-written
kernel (:data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_band`, the
fused conv of ``csrc/cs_conv3x3.cu`` launched on an ``h x n`` block)
stages the padded band in shared memory and runs the 9 taps, so no padded
band exists in device memory.  On a CPU tensor the wrapper runs its plain
version.

The backward is the reference's (``custom_vjp``): autograd through the band
ring-fix composition (:func:`~dlwp_cs_tpu_torch.parallel.overlap.
sharded_ringfix_conv3x3`) recomputed on the saved inputs, its exchanges
differentiated (:mod:`~dlwp_cs_tpu_torch.parallel.collectives`); the kernel
is a ``ctypes`` launch, whose output carries no ``grad_fn`` of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_band
from dlwp_cs_tpu_torch.parallel import collectives
from dlwp_cs_tpu_torch.parallel.collectives import axis_size
from dlwp_cs_tpu_torch.parallel.halo import halo_pieces, use_band_exchange
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS
from dlwp_cs_tpu_torch.parallel.overlap import sharded_ringfix_conv3x3

__all__ = [
    "band_conv3x3",
    "band_ext",
    "band_supported",
    "make_sharded_pallas_conv3x3",
    "ringfix_backward",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def band_supported(x_shape, n_shards: int, dtype) -> bool:
    """Does the band kernel take local bands of this shape and dtype?"""
    _, nf, h, n, _ = x_shape
    return dtype in _KERNEL_DTYPES and nf == 6 and h >= 1 and h * n_shards == n


def band_ext(bottom, top, west, east):
    """The kernel's ghost strips ``(B, 6, 4, n+2, C)`` [S, N, W, E] from the
    width-1 halo pieces: the S/N rows corner-extended, the W/E columns of
    the ``h`` band rows at positions 1..h and zero elsewhere (a pad, no
    scatter)."""
    np2, h = bottom.shape[3], west.shape[2]

    def we(col):  # (B, 6, h, 1, C) -> (B, 6, n+2, C)
        return F.pad(col[:, :, :, 0], (0, 0, 1, np2 - 1 - h))

    return torch.stack([bottom[:, :, 0], top[:, :, 0], we(west), we(east)], dim=2)


def ringfix_backward(ctx, g, reference):
    """The backward of a block conv kernel's autograd function: the
    gradients of ``reference(x, k_eq, k_pole, b_eq, b_pole)`` (a sharded
    composition of differentiable collectives) at the inputs saved in
    ``ctx``, for cotangent ``g``.  The band rows move by the ``ppermute``
    pair, as in the reference, whose backward runs outside the model's
    context.  A collective call of every rank of the block's dimensions."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad(), use_band_exchange("ppermute"), collectives.recording() as rec:
        args = [t.detach().requires_grad_(nd) for t, nd in zip(saved, need)]
        out = reference(*args)
    wanted = [a for a, nd in zip(args, need) if nd]
    got = iter(collectives.grad(rec, [out], wanted, [g]) if wanted else [])
    return tuple(next(got) if nd else None for nd in need)


class _BandConv(torch.autograd.Function):
    """Forward: kernel #8 on the exchanged strips; backward: the band
    ring-fix composition's."""

    @staticmethod
    def forward(ctx, x, k_eq, k_pole, b_eq, b_pole, mesh, axis_name):
        ctx.save_for_backward(x, k_eq, k_pole, b_eq, b_pole)
        ctx.mesh, ctx.axis_name = mesh, axis_name
        ext = band_ext(*halo_pieces(x, 1, mesh=mesh, axis_name=axis_name))
        ks = (k.to(x.dtype).contiguous() for k in (k_eq, k_pole))
        bs = (bias.to(x.dtype).contiguous() for bias in (b_eq, b_pole))
        return cs_conv3x3_band(x.contiguous(), ext.contiguous(), *ks, *bs)

    @staticmethod
    def backward(ctx, g):
        def reference(x, *weights):
            return sharded_ringfix_conv3x3(x, *(w.to(x.dtype) for w in weights),
                                           mesh=ctx.mesh, axis_name=ctx.axis_name)

        return ringfix_backward(ctx, g, reference) + (None, None)


def band_conv3x3(x, k_eq, k_pole, b_eq, b_pole, *, mesh, axis_name: str = SPATIAL_AXIS):
    """Fused CS band conv, 3x3/stride-1: this rank's band ``(B, 6, h, n,
    Cin)`` -> ``(B, 6, h, n, Cout)``, the same rows of the single-device
    ``cs_conv``.  Kernels and biases are cast to ``x``'s dtype.
    Differentiable: the backward is the band ring-fix composition's (a
    collective call, as the forward)."""
    b, nf, h, n, _ = x.shape
    S = axis_size(mesh, axis_name)
    if nf != 6 or h * S != n:
        raise ValueError(f"expected a local band (B, 6, n/{S}, n, C), got {tuple(x.shape)}")
    return _BandConv.apply(x, k_eq, k_pole, b_eq, b_pole, mesh, axis_name)


def make_sharded_pallas_conv3x3(mesh, axis_name: str = SPATIAL_AXIS):
    """Conv for :func:`~dlwp_cs_tpu_torch.ops.conv.use_conv3x3_impl`: every
    3x3 conv of a band through kernel #8; dtypes the kernel does not take
    (float64) through the band ring-fix conv."""
    n_shards = axis_size(mesh, axis_name)

    def conv(x, k_eq, k_pole, bias_eq, bias_pole):
        if not band_supported(x.shape, n_shards, x.dtype):
            return sharded_ringfix_conv3x3(x, k_eq, k_pole, bias_eq, bias_pole,
                                           mesh=mesh, axis_name=axis_name)
        zb = x.new_zeros(k_eq.shape[-1])
        return band_conv3x3(x, k_eq, k_pole, zb if bias_eq is None else bias_eq,
                            zb if bias_pole is None else bias_pole,
                            mesh=mesh, axis_name=axis_name)

    return conv
