"""Cubed-sphere halo exchange for a 2-D (row x column) tiling.

The counterpart of ``dlwp_cs_tpu.parallel.halo2d``: activations ``(B, 6,
H, W, C)`` are split over both the face rows (mesh dimension ``spatial``)
and the face columns (``spatial_x``).  Per halo width ``w``:

1. **row ppermute** along ``spatial``: the ``w`` rows flanking the tile;
2. **column ppermute** along ``spatial_x`` on the row-extended block, so
   that the interior tile corners need no diagonal hop;
3. **boundary-strip psum**: the 24 global face-edge strips ``(B, 6, 4, w,
   n, C)``, each element from one shard, summed over both spatial
   dimensions and read through the edge table;
4. **corner fill**: the cube corners averaged from their two flanking edge
   ghosts on the owning shard, as ``cs_pad`` does.

A dimension of size 1 (or absent from the mesh) issues no collective.  The
reference selects with masks on the shard indices; here the rank branches
in Python, and every rank issues every collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_N, EDGE_S, EDGE_W
from dlwp_cs_tpu_torch.ops.padding import padding_plan
from dlwp_cs_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute, psum
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, SPATIAL_X_AXIS

__all__ = ["halo_pieces_2d", "make_sharded_pad_2d", "sharded_cs_pad_2d"]


def sharded_cs_pad_2d(x, width: int, *, mesh, axis_y: str = SPATIAL_AXIS,
                      axis_x: str = SPATIAL_X_AXIS):
    """Halo-pad a 2-D-tiled field (this rank's tile).

    ``x`` ``(B, 6, h, wl, C)`` holds rows ``[iy*h, (iy+1)*h)`` and columns
    ``[jx*wl, (jx+1)*wl)`` of every face, ``iy``/``jx`` this rank's
    coordinates along ``axis_y``/``axis_x``; ``1 <= width <= min(h, wl)``.
    Returns ``(B, 6, h + 2w, wl + 2w, C)``, the same rows and columns of
    ``cs_pad`` of the gathered field.
    """
    bottom_full, top_full, west_mid, east_mid = halo_pieces_2d(
        x, width, mesh=mesh, axis_y=axis_y, axis_x=axis_x
    )
    mid = torch.cat([west_mid, x, east_mid], dim=3)
    return torch.cat([bottom_full, mid, top_full], dim=2)


def _ghost_tables(n: int, w: int):
    """(face, edge, reverse) of the seam partner of each (face, edge)."""
    table = padding_plan(n, w).table
    fidx = np.empty((6, 4), np.int64)
    eidx = np.empty((6, 4), np.int64)
    rev = np.zeros((6, 4), bool)
    for f in range(6):
        for e in range(4):
            link = table[f][e]
            fidx[f, e], eidx[f, e], rev[f, e] = link.face, link.edge, link.reverse
    return fidx, eidx, rev


def halo_pieces_2d(x, width: int, *, mesh, axis_y: str = SPATIAL_AXIS,
                   axis_x: str = SPATIAL_X_AXIS):
    """The halo of a 2-D-tiled field as four strips, not assembled:
    ``(bottom, top, west, east)``, ``bottom``/``top`` ``(B, 6, w, wl+2w,
    C)`` ghost rows with the corner columns, ``west``/``east`` ``(B, 6, h,
    w, C)`` ghost columns of the tile's rows; the contract of
    :func:`~dlwp_cs_tpu_torch.parallel.halo.halo_pieces`."""
    b, nf, h, wl, c = x.shape
    if nf != 6:
        raise ValueError(f"expected (B, 6, h, wl, C), got {tuple(x.shape)}")
    sy, sx = axis_size(mesh, axis_y), axis_size(mesh, axis_x)
    n = h * sy
    if wl * sx != n:
        raise ValueError(f"tiling inconsistent: rows {h}x{sy} != cols {wl}x{sx}")
    w = int(width)
    if not (1 <= w <= min(h, wl)):
        raise ValueError(f"halo width {w} must be in [1, min(h={h}, wl={wl})]")
    iy, jx = axis_index(mesh, axis_y), axis_index(mesh, axis_x)
    is_bot, is_top = iy == 0, iy == sy - 1
    is_left, is_right = jx == 0, jx == sx - 1

    # ---- the global boundary strips: bnd[:, f, e] = (B, w, n, C) [d, t], the
    # w outermost cell layers of face f beside its edge e; each shard writes
    # its own part of the strips it owns, one psum over both dimensions
    bnd = x.new_zeros((b, 6, 4, w, n, c))
    if is_bot:
        bnd[:, :, EDGE_S, :, jx * wl : (jx + 1) * wl] = x[:, :, :w]
    if is_top:
        bnd[:, :, EDGE_N, :, jx * wl : (jx + 1) * wl] = torch.flip(x[:, :, h - w :], dims=(2,))
    if is_left:
        bnd[:, :, EDGE_W, :, iy * h : (iy + 1) * h] = x[:, :, :, :w].transpose(2, 3)
    if is_right:
        bnd[:, :, EDGE_E, :, iy * h : (iy + 1) * h] = torch.flip(
            x[:, :, :, wl - w :], dims=(3,)).transpose(2, 3)
    bnd = psum(bnd, mesh, (axis_y, axis_x))

    # the ghost strips beyond each (face, edge), full length, [d, t]
    fidx, eidx, rev = _ghost_tables(n, w)
    g = bnd[:, torch.from_numpy(fidx), torch.from_numpy(eidx)]  # (B, 6, 4, w, n, C)
    flip = torch.from_numpy(rev).to(x.device)[None, :, :, None, None, None]
    ghost = torch.where(flip, torch.flip(g, dims=(4,)), g)
    # zero-extended along t, so that a window [t0 - w, t0 + len + w) never
    # leaves it; the zero ends land only in cube corners, which the corner
    # fill replaces
    gpad = F.pad(ghost, (0, 0, w, w))

    def ghost_block(e: int, t0: int, length: int):
        """(B, 6, w, length + 2w, C) window of the edge-e ghosts at t0."""
        return gpad[:, :, e, :, t0 : t0 + length + 2 * w]

    # ---- step 1: row exchange, the global S/N ghosts on the end rows
    if is_bot:
        bottom = torch.flip(ghost_block(EDGE_S, jx * wl, wl)[:, :, :, w : w + wl], dims=(2,))
    if is_top:
        top = ghost_block(EDGE_N, jx * wl, wl)[:, :, :, w : w + wl]
    if sy > 1:
        below = ppermute(x[:, :, h - w :], mesh, axis_y, [(i, (i + 1) % sy) for i in range(sy)])
        above = ppermute(x[:, :, :w], mesh, axis_y, [(i, (i - 1) % sy) for i in range(sy)])
        if not is_bot:
            bottom = below
        if not is_top:
            top = above
    core = torch.cat([bottom, x, top], dim=2)  # (B, 6, h+2w, wl, C)

    # ---- step 2: column exchange of the row-extended block, the global W/E
    # ghosts (cs_pad's W block [row t, column w-1-d], E block [row t, d]) on
    # the end columns
    if is_left:
        left = torch.flip(ghost_block(EDGE_W, iy * h, h), dims=(2,)).transpose(2, 3)
    if is_right:
        right = ghost_block(EDGE_E, iy * h, h).transpose(2, 3)  # (B, 6, h+2w, w, C)
    if sx > 1:
        left_x = ppermute(core[:, :, :, wl - w :], mesh, axis_x,
                          [(j, (j + 1) % sx) for j in range(sx)])
        right_x = ppermute(core[:, :, :, :w], mesh, axis_x,
                           [(j, (j - 1) % sx) for j in range(sx)])
        if not is_left:
            left = left_x
        if not is_right:
            right = right_x

    # ---- step 3: the global cube corners, cs_pad's averages
    hw = h + w
    bl, br = left[:, :, :w], right[:, :, :w]
    tl, tr = left[:, :, hw:], right[:, :, hw:]
    if is_bot and is_left:
        bl = 0.5 * (bottom[:, :, :, 0:1] + left[:, :, w : w + 1, :])
    if is_bot and is_right:
        br = 0.5 * (bottom[:, :, :, wl - 1 : wl] + right[:, :, w : w + 1, :])
    if is_top and is_left:
        tl = 0.5 * (top[:, :, :, 0:1] + left[:, :, hw - 1 : hw, :])
    if is_top and is_right:
        tr = 0.5 * (top[:, :, :, wl - 1 : wl] + right[:, :, hw - 1 : hw, :])
    bottom_full = torch.cat([bl, bottom, br], dim=3)
    top_full = torch.cat([tl, top, tr], dim=3)
    return bottom_full, top_full, left[:, :, w:hw], right[:, :, w:hw]


def make_sharded_pad_2d(mesh, axis_y: str = SPATIAL_AXIS, axis_x: str = SPATIAL_X_AXIS):
    """Pad for :func:`~dlwp_cs_tpu_torch.ops.padding.use_pad_impl` on a
    rank of a ``('data', 'spatial', 'spatial_x')`` mesh."""

    def pad(x, width):
        return sharded_cs_pad_2d(x, width, mesh=mesh, axis_y=axis_y, axis_x=axis_x)

    return pad
