"""The fused 3x3 conv on a shard's 2-D tile: kernel #9.

The counterpart of ``dlwp_cs_tpu.parallel.pallas_tile``: the tile's ghost
strips come from the 2-D exchange of
:func:`~dlwp_cs_tpu_torch.parallel.halo2d.halo_pieces_2d`, run before the
kernel, and the hand-written kernel
(:data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_tile`, the fused conv
of ``csrc/cs_conv3x3.cu`` on an ``h x wl`` block) assembles each padded
tile in shared memory.  The ghost strips share the ``wl + 2`` layout of the
S/N rows, so the kernel takes tiles with ``h <= wl``; other tiles, and
dtypes the kernel does not take, go pad-then-VALID through the 2-D pad.

The backward is the reference's: autograd through the pad-then-VALID conv
on the 2-D pad (:func:`_reference`) recomputed on the saved inputs, as
:mod:`~dlwp_cs_tpu_torch.parallel.hopper_band` does on bands.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.ops.conv import cs_conv, use_conv3x3_impl
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_tile
from dlwp_cs_tpu_torch.ops.padding import use_pad_impl
from dlwp_cs_tpu_torch.parallel.collectives import axis_size
from dlwp_cs_tpu_torch.parallel.halo2d import halo_pieces_2d, make_sharded_pad_2d
from dlwp_cs_tpu_torch.parallel.hopper_band import band_ext, ringfix_backward
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, SPATIAL_X_AXIS

__all__ = ["make_tile_pallas_conv3x3", "tile_conv3x3", "tile_supported"]


def tile_supported(x_shape, sy: int, sx: int, dtype) -> bool:
    """Does the tile kernel take local tiles of this shape and dtype?"""
    _, nf, h, wl, _ = x_shape
    return (dtype in (torch.float32, torch.bfloat16) and nf == 6 and h >= 1
            and h * sy == wl * sx and h <= wl)


def tile_conv3x3(x, k_eq, k_pole, b_eq, b_pole, *, mesh, axis_y: str = SPATIAL_AXIS,
                 axis_x: str = SPATIAL_X_AXIS):
    """Fused CS tile conv, 3x3/stride-1: this rank's tile ``(B, 6, h, wl,
    Cin)``, ``h <= wl``, -> ``(B, 6, h, wl, Cout)``, the same cells of the
    single-device ``cs_conv``.  Kernels and biases are cast to ``x``'s
    dtype.  Differentiable: the backward is the pad-then-VALID conv's (a
    collective call, as the forward)."""
    _, nf, h, wl, _ = x.shape
    sy, sx = axis_size(mesh, axis_y), axis_size(mesh, axis_x)
    if nf != 6 or h * sy != wl * sx:
        raise ValueError(f"expected a local tile (B, 6, n/{sy}, n/{sx}, C), got {tuple(x.shape)}")
    if h > wl:
        raise ValueError(
            f"the tile kernel needs h <= wl (got h={h}, wl={wl}): the W/E ghost "
            "strips ride in the (wl+2) ext strips"
        )
    return _TileConv.apply(x, k_eq, k_pole, b_eq, b_pole, mesh, axis_y, axis_x)


class _TileConv(torch.autograd.Function):
    """Forward: kernel #9 on the exchanged strips; backward: the
    pad-then-VALID conv's on the 2-D pad."""

    @staticmethod
    def forward(ctx, x, k_eq, k_pole, b_eq, b_pole, mesh, axis_y, axis_x):
        ctx.save_for_backward(x, k_eq, k_pole, b_eq, b_pole)
        ctx.mesh, ctx.axes = mesh, (axis_y, axis_x)
        ext = band_ext(*halo_pieces_2d(x, 1, mesh=mesh, axis_y=axis_y, axis_x=axis_x))
        ks = (k.to(x.dtype).contiguous() for k in (k_eq, k_pole))
        bs = (bias.to(x.dtype).contiguous() for bias in (b_eq, b_pole))
        return cs_conv3x3_tile(x.contiguous(), ext.contiguous(), *ks, *bs)

    @staticmethod
    def backward(ctx, g):
        def reference(x, *weights):
            return _reference(x, *(w.to(x.dtype) for w in weights), ctx.mesh, *ctx.axes)

        return ringfix_backward(ctx, g, reference) + (None, None, None)


def _reference(x, k_eq, k_pole, b_eq, b_pole, mesh, axis_y, axis_x):
    # pad-then-VALID through the 2-D pad, the 2-D path's conv without the
    # kernel.  The installed 3x3 conv is cleared: it is the closure that
    # calls this, and would recurse.
    with use_conv3x3_impl(None), use_pad_impl(make_sharded_pad_2d(mesh, axis_y, axis_x)):
        return cs_conv(x, k_eq, k_pole, bias_eq=b_eq, bias_pole=b_pole, backend="xla")


def make_tile_pallas_conv3x3(mesh, axis_y: str = SPATIAL_AXIS, axis_x: str = SPATIAL_X_AXIS):
    """Conv for :func:`~dlwp_cs_tpu_torch.ops.conv.use_conv3x3_impl`: every
    3x3 conv of a tile through kernel #9; tiles with ``h > wl`` and dtypes
    the kernel does not take (float64) pad-then-VALID."""
    sy, sx = axis_size(mesh, axis_y), axis_size(mesh, axis_x)

    def conv(x, k_eq, k_pole, bias_eq, bias_pole):
        if not tile_supported(x.shape, sy, sx, x.dtype):
            return _reference(x, k_eq, k_pole, bias_eq, bias_pole, mesh, axis_y, axis_x)
        zb = x.new_zeros(k_eq.shape[-1])
        return tile_conv3x3(x, k_eq, k_pole, zb if bias_eq is None else bias_eq,
                            zb if bias_pole is None else bias_pole,
                            mesh=mesh, axis_y=axis_y, axis_x=axis_x)

    return conv
