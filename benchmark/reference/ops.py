"""The cubed-sphere layers in plain PyTorch: the one-cell halo, the 3x3
conv with its equatorial and polar weight groups, the 1x1 head, pooling and
upsampling.  Layout ``(B, 6, n, n, C)``, channels last.

The halo: a ghost cell beside an edge is the neighbour face's cell across
that edge, in the neighbour's order along it (reversed where the table says
so); each corner ghost is the mean of the two ghosts beside it.  The pad is
two gathers from a flat index table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.geometry import EDGE_E, EDGE_N, EDGE_S, EDGE_W, edge_table


def _across(n: int, g: int, e2: int, t: int, rev: bool) -> int:
    """Flat index of face ``g``'s cell beside its edge ``e2`` at position
    ``t`` along it (reversed where ``rev``)."""
    t = n - 1 - t if rev else t
    i, j = {EDGE_S: (0, t), EDGE_N: (n - 1, t), EDGE_W: (t, 0), EDGE_E: (t, n - 1)}[e2]
    return (g * n + i) * n + j


@functools.lru_cache(maxsize=16)
def halo_index(n: int):
    """Two ``(6 * (n + 2)**2,)`` int64 tables into the flat ``6 * n * n``
    cells: a padded cell is the mean of the two cells they name (the same
    cell twice, but at the corners)."""
    m = n + 2
    a = np.full((6, m, m), -1, np.int64)
    table = edge_table()
    for f in range(6):
        a[f, 1:-1, 1:-1] = (f * n + np.arange(n)[:, None]) * n + np.arange(n)[None, :]
        for e, (g, e2, rev) in enumerate(table[f]):
            for t in range(n):
                src = _across(n, g, e2, t, rev)
                if e == EDGE_S:
                    a[f, 0, t + 1] = src
                elif e == EDGE_N:
                    a[f, m - 1, t + 1] = src
                elif e == EDGE_W:
                    a[f, t + 1, 0] = src
                else:
                    a[f, t + 1, m - 1] = src
    b = a.copy()
    for f in range(6):
        # each corner: the ghost beside it along the row and along the column
        for r, c, rr, cc in ((0, 0, 1, 0), (0, m - 1, 1, m - 1),
                             (m - 1, 0, m - 2, 0), (m - 1, m - 1, m - 2, m - 1)):
            a[f, r, c] = a[f, r, 1 if c == 0 else m - 2]
            b[f, r, c] = a[f, rr, cc]
    if (a < 0).any() or (b < 0).any():
        raise AssertionError("halo table has holes")
    return torch.from_numpy(a.reshape(-1)), torch.from_numpy(b.reshape(-1))


def cs_pad1(x: torch.Tensor) -> torch.Tensor:
    """``(B, 6, n, n, C) -> (B, 6, n + 2, n + 2, C)``."""
    b, _, n, _, c = x.shape
    ia, ib = (t.to(x.device) for t in halo_index(n))
    flat = x.reshape(b, 6 * n * n, c)
    out = 0.5 * (flat[:, ia] + flat[:, ib])
    return out.reshape(b, 6, n + 2, n + 2, c)


def _group(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    b, f, hp, wp, c = xp.shape
    y = F.conv2d(xp.reshape(b * f, hp, wp, c).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).reshape(b, f, y.shape[2], y.shape[3], k.shape[-1])


def cs_conv3x3(x, k_eq, k_pole, b_eq, b_pole):
    """The 3x3 cubed-sphere conv: faces 0-3 with the equatorial kernel and
    bias, 4-5 with the polar ones; HWIO kernels."""
    xp = cs_pad1(x)
    return torch.cat([_group(xp[:, :4], k_eq) + b_eq, _group(xp[:, 4:], k_pole) + b_pole], 1)


def cs_conv1x1(x, k_eq, k_pole, b_eq, b_pole):
    return torch.cat([x[:, :4] @ k_eq[0, 0] + b_eq, x[:, 4:] @ k_pole[0, 0] + b_pole], 1)


def conv(x, p: dict, name: str):
    """The conv layer ``name`` of the parameter dict ``p`` on ``x``."""
    k_eq, k_pole = p[name + ".kernel_eq"], p[name + ".kernel_pole"]
    args = (k_eq, k_pole, p[name + ".bias_eq"], p[name + ".bias_pole"])
    return cs_conv3x3(x, *args) if k_eq.shape[0] == 3 else cs_conv1x1(x, *args)


def avg_pool2(x):
    b, f, n, _, c = x.shape
    return x.reshape(b, f, n // 2, 2, n // 2, 2, c).mean(dim=(3, 5))


def upsample2(x):
    b, f, n, _, c = x.shape
    return x[:, :, :, None, :, None, :].expand(b, f, n, 2, n, 2, c).reshape(b, f, 2 * n, 2 * n, c)
