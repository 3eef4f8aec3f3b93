"""Equiangular cubed-sphere geometry in numpy: the face neighbour table and
the cell centres' latitude and longitude.

Faces 0-3 are equatorial at lon 0/90/180/270, face 4 the north pole, face 5
the south pole; arrays are ``[face, i, j]`` with row ``i`` along eta and
column ``j`` along xi.  The neighbour table is derived by matching the 3D
midpoints of the edge segments, so nothing in it is typed in by hand.
"""

from __future__ import annotations

import functools

import numpy as np

EDGE_S, EDGE_N, EDGE_W, EDGE_E = 0, 1, 2, 3


def _centers(n: int) -> np.ndarray:
    return -np.pi / 4 + (np.arange(n) + 0.5) * (np.pi / 2) / n


def face_xyz(face: int, xi, eta) -> np.ndarray:
    xi, eta = np.asarray(xi, np.float64), np.asarray(eta, np.float64)
    one = np.ones(np.broadcast(xi, eta).shape)
    v = {0: (one, xi, eta), 1: (-xi, one, eta), 2: (-one, -xi, eta),
         3: (xi, -one, eta), 4: (-eta, xi, one), 5: (eta, xi, -one)}[face]
    return np.stack(np.broadcast_arrays(*v), axis=-1)


def _edge_midpoints(face: int, edge: int, n: int) -> np.ndarray:
    t = np.tan(_centers(n))
    xi, eta = {EDGE_S: (t, -1.0), EDGE_N: (t, 1.0), EDGE_W: (-1.0, t),
               EDGE_E: (1.0, t)}[edge]
    p = face_xyz(face, xi, eta)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=1)
def edge_table():
    """``table[face][edge] = (other_face, other_edge, reverse)``."""
    n = 8
    mids = {(f, e): _edge_midpoints(f, e, n) for f in range(6) for e in range(4)}
    table = []
    for f in range(6):
        row = []
        for e in range(4):
            found = [(g, e2, rev) for g in range(6) if g != f for e2 in range(4)
                     for rev in (False, True)
                     if np.allclose(mids[f, e], mids[g, e2][::-1] if rev else mids[g, e2],
                                    atol=1e-12)]
            if len(found) != 1:
                raise AssertionError(f"face {f} edge {e}: {found}")
            row.append(found[0])
        table.append(tuple(row))
    return tuple(table)


def cell_latlon(n: int):
    """``(lat, lon)`` radians of the cell centres, each ``(6, n, n)``."""
    t = np.tan(_centers(n))
    eta, xi = np.meshgrid(t, t, indexing="ij")
    p = np.stack([face_xyz(f, xi, eta) for f in range(6)])
    p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    lat = np.arcsin(np.clip(p[..., 2], -1.0, 1.0))
    lon = np.mod(np.arctan2(p[..., 1], p[..., 0]), 2 * np.pi)
    return lat, lon
