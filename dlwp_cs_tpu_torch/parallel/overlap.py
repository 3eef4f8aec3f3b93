"""The band ring-fix conv: the sharded 3x3 conv of the default sharded path.

The counterpart of ``dlwp_cs_tpu.parallel.overlap``: a 3x3 stride-1
cubed-sphere conv of a shard's row band as

1. zero-padded SAME convs of the local band (cuDNN, full float32 for
   float32; independent of every collective), and
2. boundary-row and boundary-column fixes contracted from the exchanged
   ghost strips of :func:`~dlwp_cs_tpu_torch.parallel.halo.halo_pieces`,
   applied in one masked add: the single-device ring fix's
   ``ring_contract`` and ``ring_apply`` on the band's (h, n) block.

The result is the same rows of the single-device conv.  The reference
chose this structure so that XLA's scheduler could run the seam traffic
under the interior conv; here the collectives are blocking calls issued
before the SAME convs.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.ops.ringfix import (
    _same_conv,
    add_group_bias,
    face_select,
    ring_apply,
    ring_contract,
)
from dlwp_cs_tpu_torch.parallel.halo import halo_pieces
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS

__all__ = ["make_sharded_conv3x3", "sharded_ringfix_conv3x3"]


def sharded_ringfix_conv3x3(x, k_eq, k_pole, bias_eq=None, bias_pole=None, *,
                            mesh, axis_name: str = SPATIAL_AXIS):
    """Sharded CS conv, 3x3/stride-1, of this rank's row band ``(B, 6, h, n,
    Cin)``: the same rows of the single-device ``cs_conv``, in ``x``'s
    dtype."""
    nf, n = x.shape[1], x.shape[3]
    if nf != 6:
        raise ValueError(f"expected (B, 6, h, n, C), got {tuple(x.shape)}")
    bottom, top, west, east = halo_pieces(x, 1, mesh=mesh, axis_name=axis_name)

    # 1. the interior: two full 6-face SAME convs and the face select
    out = face_select(_same_conv(x, k_eq), _same_conv(x, k_pole))

    # 2. the fixes of the band's ghost strips: S/N with n+2 cells, W/E with
    # h+2, their ends the band corners of the S/N strips
    s_strip, n_strip = bottom[:, :, 0], top[:, :, 0]  # (B, 6, n+2, C)
    w_strip = torch.cat([s_strip[:, :, 0:1], west[:, :, :, 0], n_strip[:, :, 0:1]], dim=2)
    e_strip = torch.cat(
        [s_strip[:, :, n + 1 : n + 2], east[:, :, :, 0], n_strip[:, :, n + 1 : n + 2]], dim=2
    )
    fixes = ring_contract(torch.stack([s_strip, n_strip], dim=2),
                          torch.stack([w_strip, e_strip], dim=2), k_eq, k_pole)

    # 3. one masked add over the (h, n) band
    return add_group_bias(ring_apply(out, *fixes), bias_eq, bias_pole)


def make_sharded_conv3x3(mesh, axis_name: str = SPATIAL_AXIS):
    """Conv for :func:`~dlwp_cs_tpu_torch.ops.conv.use_conv3x3_impl`."""

    def conv(x, k_eq, k_pole, bias_eq, bias_pole):
        return sharded_ringfix_conv3x3(x, k_eq, k_pole, bias_eq, bias_pole,
                                       mesh=mesh, axis_name=axis_name)

    return conv
