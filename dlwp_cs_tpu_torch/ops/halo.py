"""The halo-extension map E: corner-extended ghost strips.

The counterpart of the forward of ``dlwp_cs_tpu.ops.halo.ext_strips``:

    E : (B, 6, n, n, C)  ->  (B, 6, 4, n+2, C)

``[b, f, e]`` is the ghost line beyond edge ``e`` (S, N, W, E) of face
``f``: ``n`` ghosts copied from the seam partner plus the two corner ghosts
at positions 0 and n+1, each the mean of the two flanking edge ghosts.  Two
gathers and an add, in the input's dtype (so in bf16 ``0.5 * (ga + gb)``
rounds as the reference's does).

The backward is the transpose Eᵀ, evaluated as gathers from the cotangent
(``_ext_transpose``), as the reference's ``custom_vjp`` does: autograd's
own backward of ``index_select`` is an ``index_add``, which sums with float
atomics on CUDA and so differs from run to run.  Eᵀ uses no scatter and no
atomics, so two identical backward passes give bitwise-equal gradients.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_N, EDGE_S, EDGE_W
from dlwp_cs_tpu_torch.ops.padding import padding_plan

__all__ = ["ext_strips", "ring_add"]

# Max ext positions feeding one perimeter cell: a face-corner cell is read by
# its 2 seams x (1 interior + 2 corner) entries.
_FAN_IN = 6


@functools.lru_cache(maxsize=32)
def _strip_sources(n: int) -> np.ndarray:
    """Flat cell indices (into 6*n*n) of the 24 oriented interior ghost
    strips: ``[f, e, t]`` is the cell whose value is the ghost beyond edge
    ``e`` of face ``f`` at along-edge position ``t``."""
    table = padding_plan(n, 1).table
    idx = np.empty((6, 4, n), np.int64)
    t = np.arange(n)
    for f in range(6):
        for e in range(4):
            link = table[f][e]
            g = link.face
            tt = t[::-1] if link.reverse else t
            if link.edge == EDGE_S:
                i, j = np.zeros(n, np.int64), tt
            elif link.edge == EDGE_N:
                i, j = np.full(n, n - 1), tt
            elif link.edge == EDGE_W:
                i, j = tt, np.zeros(n, np.int64)
            else:
                i, j = tt, np.full(n, n - 1)
            idx[f, e] = g * n * n + i * n + j
    return idx


@functools.lru_cache(maxsize=32)
def _ext_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(idxA, idxB), each (6, 4, n+2): ext[p] = 0.5*(x[idxA[p]] + x[idxB[p]]).

    Interior positions use idxA == idxB; the end positions are the corner
    ghosts, the mean of the end ghosts of the two edges meeting there.
    """
    s = _strip_sources(n)
    idxA = np.empty((6, 4, n + 2), np.int64)
    idxB = np.empty((6, 4, n + 2), np.int64)
    for f in range(6):
        idxA[f, :, 1 : n + 1] = s[f]
        idxB[f, :, 1 : n + 1] = s[f]
        sw = (s[f, EDGE_S, 0], s[f, EDGE_W, 0])
        se = (s[f, EDGE_S, n - 1], s[f, EDGE_E, 0])
        nw = (s[f, EDGE_N, 0], s[f, EDGE_W, n - 1])
        ne = (s[f, EDGE_N, n - 1], s[f, EDGE_E, n - 1])
        for e, (lo, hi) in (
            (EDGE_S, (sw, se)),
            (EDGE_N, (nw, ne)),
            (EDGE_W, (sw, nw)),
            (EDGE_E, (se, ne)),
        ):
            idxA[f, e, 0], idxB[f, e, 0] = lo
            idxA[f, e, n + 1], idxB[f, e, n + 1] = hi
    return idxA, idxB


@functools.lru_cache(maxsize=32)
def _transpose_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-edge-view incoming tables for Eᵀ.

    Returns ``(idx, w)`` of shapes (6, 4, n, _FAN_IN): for the ``t``-th cell
    along edge ``e`` of face ``g`` (S:(0,t), N:(n-1,t), W:(t,0), E:(t,n-1)),
    ``dx_cell += sum_k w[g,e,t,k] * d_ext_flat[idx[g,e,t,k]]``.

    A face-corner cell belongs to two views; all its entries go to the first
    view met (fixed scan order) and the other view carries zero weights
    there, so :func:`ring_add`, which applies both views at a corner cell,
    sums each entry exactly once.
    """
    idxA, idxB = _ext_tables(n)
    # cell -> {flat ext position: weight}; an interior position lists the
    # same cell as both sources, which merges to one weight-1 entry
    incoming: dict[int, dict[int, float]] = {}
    for f in range(6):
        for e in range(4):
            for t in range(n + 2):
                p = (f * 4 + e) * (n + 2) + t
                for cell in (int(idxA[f, e, t]), int(idxB[f, e, t])):
                    d = incoming.setdefault(cell, {})
                    d[p] = d.get(p, 0.0) + 0.5

    def cell_of(g: int, e: int, t: int) -> int:
        if e == EDGE_S:
            i, j = 0, t
        elif e == EDGE_N:
            i, j = n - 1, t
        elif e == EDGE_W:
            i, j = t, 0
        else:
            i, j = t, n - 1
        return g * n * n + i * n + j

    idx = np.zeros((6, 4, n, _FAN_IN), np.int64)
    w = np.zeros((6, 4, n, _FAN_IN), np.float32)
    claimed: set[int] = set()
    for g in range(6):
        for e in range(4):
            for t in range(n):
                cell = cell_of(g, e, t)
                if cell in claimed:
                    continue  # a corner cell already taken by its first view
                claimed.add(cell)
                entries = sorted(incoming.get(cell, {}).items())
                if len(entries) > _FAN_IN:
                    raise AssertionError(f"cell {(g, e, t)} has {len(entries)} sources")
                for k, (p, wk) in enumerate(entries):
                    idx[g, e, t, k] = p
                    w[g, e, t, k] = wk
    return idx, w


# Index tensors live on the device beside the activations; keyed by
# (n, device) so the rollout loop copies nothing from the host.
@functools.lru_cache(maxsize=32)
def _device_tables(n: int, device: torch.device):
    idxA, idxB = _ext_tables(n)
    return (
        torch.from_numpy(idxA.reshape(-1)).to(device),
        torch.from_numpy(idxB.reshape(-1)).to(device),
    )


@functools.lru_cache(maxsize=32)
def _device_transpose_tables(n: int, device: torch.device):
    idx, w = _transpose_tables(n)
    return torch.from_numpy(idx.reshape(-1)).to(device), torch.from_numpy(w).to(device)


def _ext_forward(x):
    b, _, n, _, c = x.shape
    ia, ib = _device_tables(n, x.device)
    flat = x.reshape(b, 6 * n * n, c)
    ga = flat.index_select(1, ia)
    gb = flat.index_select(1, ib)
    return (0.5 * (ga + gb)).reshape(b, 6, 4, n + 2, c)


def ring_add(base, inc_s, inc_n, inc_w, inc_e):
    """Add per-edge vectors onto each face's perimeter ring.

    ``base``: (B, 6, n, n, D); ``inc_*``: (B, 6, n, D) along-edge vectors
    (S/N indexed by column, W/E by row).  Face-corner cells receive both of
    their edges' entries.  Elementwise only, in ``base``'s dtype.
    """
    n = base.shape[2]
    ar = torch.arange(n, device=base.device)
    row = ar[None, None, :, None, None]
    col = ar[None, None, None, :, None]
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    return (
        base
        + torch.where(row == 0, inc_s[:, :, None, :, :], zero)
        + torch.where(row == n - 1, inc_n[:, :, None, :, :], zero)
        + torch.where(col == 0, inc_w[:, :, :, None, :], zero)
        + torch.where(col == n - 1, inc_e[:, :, :, None, :], zero)
    )


def _ext_transpose(g):
    """Eᵀ: cotangent (B, 6, 4, n+2, C) -> dx (B, 6, n, n, C), gathers only."""
    b, _, _, np2, c = g.shape
    n = np2 - 2
    idx, w = _device_transpose_tables(n, g.device)
    flat = g.reshape(b, 6 * 4 * (n + 2), c)
    # one gather covering all _FAN_IN incoming positions, then a weighted sum
    gk = flat.index_select(1, idx).reshape(b, 6, 4, n, _FAN_IN, c)
    inc = (gk * w.to(g.dtype)[None, :, :, :, :, None]).sum(dim=4)
    dx = torch.zeros((b, 6, n, n, c), dtype=g.dtype, device=g.device)
    return ring_add(dx, inc[:, :, EDGE_S], inc[:, :, EDGE_N],
                    inc[:, :, EDGE_W], inc[:, :, EDGE_E])


class _ExtStrips(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _ext_forward(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _ext_transpose(g.contiguous())


def ext_strips(x):
    """Corner-extended ghost strips: ``(B, 6, n, n, C) -> (B, 6, 4, n+2, C)``.

    Differentiable; the backward is the scatter-free Eᵀ (module docstring).
    """
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    return _ExtStrips.apply(x)
