"""Cross-face halo padding on the cubed sphere (the pad-then-VALID path).

The counterpart of ``dlwp_cs_tpu.ops.padding``: each face's edges are padded
with the adjacent faces' edge rows/columns under the per-edge index
transform of the cube topology, and the corner blocks are the mean of the
two flanking edge ghosts.  Layout ``(B, 6, n, n, C)`` channels-last.

:func:`use_pad_impl` installs another pad for a block of code: the spatially
decomposed path (:mod:`dlwp_cs_tpu_torch.parallel`) installs its halo
exchange, so model code, which only calls :func:`cs_pad`, runs unchanged on
one device or on a shard's local block.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

from dlwp_cs_tpu_torch.geometry.cubed_sphere import (
    EDGE_E,
    EDGE_N,
    EDGE_S,
    EDGE_W,
    EdgeLink,
    edge_table,
    verify_edge_table,
)

__all__ = ["cs_pad", "padding_plan", "PaddingPlan", "use_pad_impl"]

_PAD_IMPL: contextvars.ContextVar = contextvars.ContextVar("cs_pad_impl", default=None)


@contextlib.contextmanager
def use_pad_impl(fn):
    """Within this context, ``cs_pad(x, w)`` delegates to ``fn(x, w)``
    (``None`` restores the single-device pad)."""
    token = _PAD_IMPL.set(fn)
    try:
        yield
    finally:
        _PAD_IMPL.reset(token)


class PaddingPlan:
    """Frozen description of one halo exchange: resolution ``n``, width ``w``."""

    def __init__(self, n: int, width: int):
        if width < 1:
            raise ValueError(f"pad width must be >= 1, got {width}")
        if width > n:
            raise ValueError(f"pad width {width} exceeds face size {n}")
        verify_edge_table(n)
        self.n = int(n)
        self.width = int(width)
        self.table: tuple[tuple[EdgeLink, ...], ...] = edge_table()

    def __repr__(self) -> str:  # pragma: no cover
        return f"PaddingPlan(n={self.n}, width={self.width})"


@functools.lru_cache(maxsize=32)
def padding_plan(n: int, width: int) -> PaddingPlan:
    return PaddingPlan(n, width)


def _edge_strip(xf, edge: int, w: int):
    """Strip of ``w`` cell layers beside ``edge`` of faces ``xf`` ``(B, n, n,
    C)``: ``(B, w, n, C)`` indexed [depth from the edge, position along it]
    (t runs in +xi for S/N edges, +eta for W/E)."""
    if edge == EDGE_S:
        return xf[:, :w, :, :]
    if edge == EDGE_N:
        return torch.flip(xf[:, -w:, :, :], dims=(1,))
    if edge == EDGE_W:
        return xf[:, :, :w, :].transpose(1, 2)
    if edge == EDGE_E:
        return torch.flip(xf[:, :, -w:, :], dims=(2,)).transpose(1, 2)
    raise ValueError(f"bad edge {edge}")


def cs_pad(x, width: int):
    """Halo-pad ``x`` ``(B, 6, n, n, C)`` across faces to
    ``(B, 6, n + 2w, n + 2w, C)``.

    Edge ghosts are copies of the neighbor faces' cells; each ``w x w``
    corner block is the mean of the two flanking edge-ghost cells, computed
    in ``x``'s dtype.  Under :func:`use_pad_impl` the installed pad runs
    instead.
    """
    impl = _PAD_IMPL.get()
    if impl is not None:
        return impl(x, width)
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    b, _, n, _, c = x.shape
    plan = padding_plan(n, width)
    w = plan.width
    faces = []
    for f in range(6):
        pf = x.new_zeros((b, n + 2 * w, n + 2 * w, c))
        pf[:, w : w + n, w : w + n, :] = x[:, f]
        for e in range(4):
            link = plan.table[f][e]
            strip = _edge_strip(x[:, link.face], link.edge, w)
            if link.reverse:
                strip = torch.flip(strip, dims=(2,))
            if e == EDGE_S:
                pf[:, :w, w : w + n, :] = torch.flip(strip, dims=(1,))
            elif e == EDGE_N:
                pf[:, w + n :, w : w + n, :] = strip
            elif e == EDGE_W:
                pf[:, w : w + n, :w, :] = torch.flip(strip, dims=(1,)).transpose(1, 2)
            else:  # EDGE_E
                pf[:, w : w + n, w + n :, :] = strip.transpose(1, 2)
        pf[:, :w, :w, :] = 0.5 * (pf[:, :w, w : w + 1, :] + pf[:, w : w + 1, :w, :])
        pf[:, :w, w + n :, :] = 0.5 * (
            pf[:, :w, w + n - 1 : w + n, :] + pf[:, w : w + 1, w + n :, :]
        )
        pf[:, w + n :, :w, :] = 0.5 * (
            pf[:, w + n :, w : w + 1, :] + pf[:, w + n - 1 : w + n, :w, :]
        )
        pf[:, w + n :, w + n :, :] = 0.5 * (
            pf[:, w + n :, w + n - 1 : w + n, :]
            + pf[:, w + n - 1 : w + n, w + n :, :]
        )
        faces.append(pf)
    return torch.stack(faces, dim=1)
