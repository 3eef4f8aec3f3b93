"""The halo-extension map E: corner-extended ghost strips.

The counterpart of the forward of ``dlwp_cs_tpu.ops.halo.ext_strips``:

    E : (B, 6, n, n, C)  ->  (B, 6, 4, n+2, C)

``[b, f, e]`` is the ghost line beyond edge ``e`` (S, N, W, E) of face
``f``: ``n`` ghosts copied from the seam partner plus the two corner ghosts
at positions 0 and n+1, each the mean of the two flanking edge ghosts.  Two
gathers and an add, in the input's dtype (so in bf16 ``0.5 * (ga + gb)``
rounds as the reference's does).  The transpose (Eᵀ) belongs to the
training backward and is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_N, EDGE_S, EDGE_W
from dlwp_cs_tpu_torch.ops.padding import padding_plan

__all__ = ["ext_strips"]


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


# Index tensors live on the device beside the activations; keyed by
# (n, device) so the rollout loop copies nothing from the host.
@functools.lru_cache(maxsize=32)
def _device_tables(n: int, device: torch.device):
    idxA, idxB = _ext_tables(n)
    return (
        torch.from_numpy(idxA.reshape(-1)).to(device),
        torch.from_numpy(idxB.reshape(-1)).to(device),
    )


def ext_strips(x):
    """Corner-extended ghost strips: ``(B, 6, n, n, C) -> (B, 6, 4, n+2, C)``."""
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    b, _, n, _, c = x.shape
    ia, ib = _device_tables(n, x.device)
    flat = x.reshape(b, 6 * n * n, c)
    ga = flat.index_select(1, ia)
    gb = flat.index_select(1, ib)
    return (0.5 * (ga + gb)).reshape(b, 6, 4, n + 2, c)
