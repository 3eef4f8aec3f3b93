"""Equiangular cubed-sphere geometry (numpy): the topology contract.

A copy of the numpy-only part of ``dlwp_cs_tpu.geometry.cubed_sphere``
that the port needs: the edge identifiers, the numerically derived
neighbor table, the :class:`CubedSphere` cell centers, areas and area
weights, and the chart inverses (:func:`xyz_to_face_angles`) that the
remap weights use.  The port keeps
its own copy because importing anything of ``dlwp_cs_tpu`` pulls in JAX;
``tests/test_torch_geometry.py`` holds the two copies equal.

Conventions (same as the reference package): faces 0-3 are equatorial at
lon 0/90/180/270, face 4 the north pole, face 5 the south pole.  Arrays are
``[face, i, j]`` with row ``i`` <-> eta (south->north on equatorial faces)
and column ``j`` <-> xi (west->east).  Every chart is right-handed with
respect to its outward normal, so the polar weight group needs no flip.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = [
    "EDGE_S",
    "EDGE_N",
    "EDGE_W",
    "EDGE_E",
    "EQUATORIAL_FACES",
    "POLAR_FACES",
    "EdgeLink",
    "edge_table",
    "verify_edge_table",
    "CubedSphere",
    "face_xyz",
    "xyz_to_face",
    "xyz_to_face_angles",
]

# S/N are constant-row edges (i = 0 / i = n-1); W/E constant-column edges.
EDGE_S, EDGE_N, EDGE_W, EDGE_E = 0, 1, 2, 3
_EDGE_NAMES = ("S", "N", "W", "E")

EQUATORIAL_FACES = (0, 1, 2, 3)
POLAR_FACES = (4, 5)

_QUARTER_PI = np.pi / 4.0


def _cell_center_angles(n: int) -> np.ndarray:
    """Equiangular cell-center angles a_k = -pi/4 + (k+1/2) * (pi/2)/n."""
    step = (np.pi / 2.0) / n
    return -_QUARTER_PI + (np.arange(n) + 0.5) * step


def face_xyz(face: int, xi, eta):
    """Map gnomonic coords on ``face`` to unnormalized 3D points (trailing 3)."""
    xi = np.asarray(xi, dtype=np.float64)
    eta = np.asarray(eta, dtype=np.float64)
    one = np.ones(np.broadcast(xi, eta).shape)
    if face == 0:
        v = (one, xi, eta)
    elif face == 1:
        v = (-xi, one, eta)
    elif face == 2:
        v = (-one, -xi, eta)
    elif face == 3:
        v = (xi, -one, eta)
    elif face == 4:
        v = (-eta, xi, one)
    elif face == 5:
        v = (eta, xi, -one)
    else:
        raise ValueError(f"face must be in 0..5, got {face}")
    return np.stack(np.broadcast_arrays(*v), axis=-1)


# Outward unit normals of the 6 face centers, in face order.
_FACE_NORMALS = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ]
)


def xyz_to_face(p: np.ndarray) -> np.ndarray:
    """Containing face index for 3D point(s) ``p`` (trailing axis 3); a point
    on an edge or a corner goes to the lowest face index (``argmax``)."""
    p = np.asarray(p, dtype=np.float64)
    return np.argmax(p @ _FACE_NORMALS.T, axis=-1)


def _face_local_exact(face: int, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact chart inverses ``(xi, eta)``, read off the :func:`face_xyz` table."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if face == 0:  # P = r*(1, xi, eta)
        return y / x, z / x
    if face == 1:  # P = r*(-xi, 1, eta)
        return -x / y, z / y
    if face == 2:  # P = r*(-1, -xi, eta)
        return y / x, -z / x
    if face == 3:  # P = r*(xi, -1, eta)
        return -x / y, -z / y
    if face == 4:  # P = r*(-eta, xi, 1)
        return y / z, -x / z
    if face == 5:  # P = r*(eta, xi, -1)
        return -y / z, -x / z
    raise ValueError(f"face must be in 0..5, got {face}")


def xyz_to_face_angles(p: np.ndarray):
    """``(face, a, b)`` equiangular coordinates of 3D point(s) ``p``;
    vectorized, with :func:`xyz_to_face`'s lowest-face tie-break."""
    p = np.asarray(p, dtype=np.float64)
    face = xyz_to_face(p)
    xi = np.empty(face.shape)
    eta = np.empty(face.shape)
    for f in range(6):
        m = face == f
        if not np.any(m):
            continue
        xi[m], eta[m] = _face_local_exact(f, p[m])
    return face, np.arctan(xi), np.arctan(eta)


@dataclass(frozen=True)
class EdgeLink:
    """Across edge ``e`` of a face lies ``face``'s edge ``edge``; ``reverse``
    says whether the shared-edge coordinate runs in opposite order."""

    face: int
    edge: int
    reverse: bool


def _edge_segment_midpoints(face: int, edge: int, n: int) -> np.ndarray:
    """Unit 3D midpoints of the n boundary segments of (face, edge); they lie
    exactly on the cube-edge arc, so matching them across faces is exact."""
    t = np.tan(_cell_center_angles(n))
    if edge == EDGE_S:
        xi, eta = t, np.full(n, -1.0)
    elif edge == EDGE_N:
        xi, eta = t, np.full(n, 1.0)
    elif edge == EDGE_W:
        xi, eta = np.full(n, -1.0), t
    elif edge == EDGE_E:
        xi, eta = np.full(n, 1.0), t
    else:
        raise ValueError(f"edge must be in 0..3, got {edge}")
    p = face_xyz(face, xi, eta)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=1)
def edge_table() -> tuple[tuple[EdgeLink, ...], ...]:
    """Neighbor table ``table[face][edge] -> EdgeLink``, derived by exact 3D
    matching of edge-segment midpoints (each edge matches exactly one)."""
    n = 8
    mids = {
        (f, e): _edge_segment_midpoints(f, e, n) for f in range(6) for e in range(4)
    }
    table: list[list[EdgeLink | None]] = [[None] * 4 for _ in range(6)]
    for f in range(6):
        for e in range(4):
            matches = []
            for g in range(6):
                if g == f:
                    continue
                for e2 in range(4):
                    if np.allclose(mids[f, e], mids[g, e2], atol=1e-12):
                        matches.append(EdgeLink(g, e2, reverse=False))
                    elif np.allclose(mids[f, e], mids[g, e2][::-1], atol=1e-12):
                        matches.append(EdgeLink(g, e2, reverse=True))
            if len(matches) != 1:
                raise AssertionError(
                    f"face {f} edge {_EDGE_NAMES[e]}: expected exactly one "
                    f"neighbor, found {matches}"
                )
            table[f][e] = matches[0]
    # the link must be mutual with an identical reverse flag (explicit raise
    # so the check also holds under ``python -O``)
    for f in range(6):
        for e in range(4):
            link = table[f][e]
            back = table[link.face][link.edge]
            if not (back.face == f and back.edge == e
                    and back.reverse == link.reverse):
                raise AssertionError(
                    f"edge table asymmetry: face {f} edge {e} links to "
                    f"{link}, which links back to {back}"
                )
    return tuple(tuple(row) for row in table)  # type: ignore[arg-type]


def verify_edge_table(n: int) -> None:
    """Re-assert edge-midpoint matching for a concrete resolution ``n``."""
    table = edge_table()
    for f in range(6):
        for e in range(4):
            link = table[f][e]
            a = _edge_segment_midpoints(f, e, n)
            b = _edge_segment_midpoints(link.face, link.edge, n)
            if link.reverse:
                b = b[::-1]
            if not np.allclose(a, b, atol=1e-12):
                raise AssertionError(
                    f"edge table mismatch at n={n}: face {f} edge "
                    f"{_EDGE_NAMES[e]} vs {link}"
                )


def _solid_angle_antiderivative(xi: np.ndarray, eta: np.ndarray) -> np.ndarray:
    """F with  integral dxi deta / (1+xi^2+eta^2)^(3/2) = F(xi2,eta2)-F(xi1,eta2)-F(xi2,eta1)+F(xi1,eta1)."""
    return np.arctan(xi * eta / np.sqrt(1.0 + xi * xi + eta * eta))


class CubedSphere:
    """Concrete C{n} equiangular cubed-sphere grid (cell-centered); numpy
    float64 arrays laid out ``(6, n, n[, ...])``."""

    def __init__(self, n: int):
        if n < 2:
            raise ValueError("cubed sphere resolution must be >= 2")
        self.n = int(n)
        self.table = edge_table()
        verify_edge_table(self.n)

    @functools.cached_property
    def center_angles(self) -> np.ndarray:
        """(n,) equiangular cell-center angles."""
        return _cell_center_angles(self.n)

    @functools.cached_property
    def cell_xyz(self) -> np.ndarray:
        """(6, n, n, 3) unit cell-center positions."""
        t = np.tan(self.center_angles)
        eta, xi = np.meshgrid(t, t, indexing="ij")  # i<->eta rows, j<->xi cols
        out = np.stack([face_xyz(f, xi, eta) for f in range(6)], axis=0)
        return out / np.linalg.norm(out, axis=-1, keepdims=True)

    @functools.cached_property
    def cell_latlon(self) -> tuple[np.ndarray, np.ndarray]:
        """(lat, lon) in radians, each (6, n, n); lon in [0, 2pi)."""
        p = self.cell_xyz
        lat = np.arcsin(np.clip(p[..., 2], -1.0, 1.0))
        lon = np.mod(np.arctan2(p[..., 1], p[..., 0]), 2.0 * np.pi)
        return lat, lon

    @functools.cached_property
    def cell_areas(self) -> np.ndarray:
        """(6, n, n) exact spherical cell solid angles; sums to 4*pi.

        Closed form for the solid angle of a gnomonic rectangle; identical on
        all faces, so computed once and broadcast.
        """
        edges = np.tan(
            -_QUARTER_PI + np.arange(self.n + 1) * (np.pi / 2.0) / self.n
        )
        xi1, eta1 = np.meshgrid(edges[:-1], edges[:-1], indexing="xy")
        xi2, eta2 = np.meshgrid(edges[1:], edges[1:], indexing="xy")
        area = (
            _solid_angle_antiderivative(xi2, eta2)
            - _solid_angle_antiderivative(xi1, eta2)
            - _solid_angle_antiderivative(xi2, eta1)
            + _solid_angle_antiderivative(xi1, eta1)
        )
        return np.broadcast_to(area, (6, self.n, self.n)).copy()

    @functools.cached_property
    def area_weights(self) -> np.ndarray:
        """(6, n, n) cell areas normalized to mean 1 (for weighted losses)."""
        a = self.cell_areas
        return a / a.mean()

    def __repr__(self) -> str:  # pragma: no cover
        return f"CubedSphere(n={self.n})"
