"""Lat-lon <-> cubed-sphere remap weights (host-side, numpy).

A copy of ``dlwp_cs_tpu.remap.weights`` (numpy only; the port keeps its own
copy because importing anything of ``dlwp_cs_tpu`` pulls in JAX).  Weights
are a COO sparse matrix ``(n_target, n_source)`` whose rows sum to 1:
bilinear ones generated here, exact conservative ones by the C++ generator
(:mod:`dlwp_cs_tpu_torch.remap.native`).  :meth:`RemapWeights.apply_numpy`
is the plain version of :func:`dlwp_cs_tpu_torch.remap.apply.apply_remap`,
which applies them on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere, xyz_to_face_angles

__all__ = ["RemapWeights", "ll_to_cs_weights", "cs_to_ll_weights", "latlon_grid"]


@dataclass
class RemapWeights:
    """COO sparse remap operator ``target = W @ source`` (rows sum to 1)."""

    rows: np.ndarray  # (nnz,) int32 target indices
    cols: np.ndarray  # (nnz,) int32 source indices
    vals: np.ndarray  # (nnz,) float32
    shape: tuple[int, int]  # (n_target, n_source)

    def row_sums(self) -> np.ndarray:
        out = np.zeros(self.shape[0])
        np.add.at(out, self.rows, self.vals)
        return out

    def apply_numpy(self, x: np.ndarray) -> np.ndarray:
        """Apply along the last axis: ``(..., n_source) -> (..., n_target)``."""
        if x.shape[-1] != self.shape[1]:
            raise ValueError(f"source dim {x.shape[-1]} != {self.shape[1]}")
        # accumulate in the PRODUCT dtype: an integer out array would
        # truncate every weighted term (int fields would remap to zeros)
        out = np.zeros(x.shape[:-1] + (self.shape[0],),
                       dtype=np.result_type(x.dtype, self.vals.dtype))
        np.add.at(
            out.reshape(-1, self.shape[0]),
            (slice(None), self.rows),
            (x[..., self.cols] * self.vals).reshape(-1, len(self.rows)),
        )
        return out

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, rows=self.rows, cols=self.cols, vals=self.vals,
            shape=np.asarray(self.shape),
        )
        return path

    @classmethod
    def load(cls, path) -> "RemapWeights":
        z = np.load(path)
        return cls(
            rows=z["rows"], cols=z["cols"], vals=z["vals"],
            shape=tuple(int(v) for v in z["shape"]),
        )


def latlon_grid(n_lat: int, n_lon: int, *, cell_centered: bool = True):
    """Uniform global lat-lon grid in radians: (lats (H,), lons (W,)).

    Cell-centered avoids duplicated poles/seam (ERA5-style grids that include
    the poles also work — generation only needs the coordinate vectors).
    """
    if cell_centered:
        lats = -np.pi / 2 + (np.arange(n_lat) + 0.5) * np.pi / n_lat
        lons = (np.arange(n_lon) + 0.5) * 2 * np.pi / n_lon
    else:
        lats = np.linspace(-np.pi / 2, np.pi / 2, n_lat)
        lons = np.arange(n_lon) * 2 * np.pi / n_lon
    return lats, lons


def _bilinear_1d(grid: np.ndarray, x: np.ndarray, *, periodic: bool, period=2 * np.pi):
    """Indices (i0, i1) and weight w1 for linear interpolation of x onto grid.

    ``grid`` must be ascending.  Periodic wraps; otherwise clamps at the ends
    (constant extrapolation), appropriate for latitudes near the poles.
    """
    n = len(grid)
    if np.any(np.diff(grid) <= 0):
        raise ValueError(
            "interpolation grid must be strictly ascending (got a "
            "descending or non-monotone axis — ERA5 ships latitudes "
            "north->south; flip them first).  A descending axis would "
            "produce plausible-looking but WRONG weights (row sums still 1)."
        )
    if periodic:
        step0 = grid[0]
        # mod maps x into [grid[0], grid[0]+period), so i0 >= 0 always and
        # only the seam segment [grid[-1], grid[0]+period) needs the wrap
        xs = np.mod(x - step0, period) + step0
        i0 = np.searchsorted(grid, xs, side="right") - 1
        i1 = (i0 + 1) % n
        g0 = grid[i0]
        g1 = np.where(i1 == 0, grid[0] + period, grid[i1])
        w1 = (xs - g0) / (g1 - g0)
    else:
        i0 = np.clip(np.searchsorted(grid, x, side="right") - 1, 0, n - 2)
        g0, g1 = grid[i0], grid[i0 + 1]
        w1 = np.clip((x - g0) / (g1 - g0), 0.0, 1.0)
        i1 = i0 + 1
    return i0.astype(np.int64), i1.astype(np.int64), w1


def ll_to_cs_weights(lats: np.ndarray, lons: np.ndarray, cs: CubedSphere) -> RemapWeights:
    """Bilinear weights sampling a lat-lon grid at cubed-sphere cell centers.

    Source layout: row-major ``(H=lat, W=lon)`` flattened; target layout:
    ``(6, n, n)`` flattened (the canonical face order).
    """
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    h, w = len(lats), len(lons)
    tlat, tlon = cs.cell_latlon
    tlat, tlon = tlat.reshape(-1), tlon.reshape(-1)
    la0, la1, wa = _bilinear_1d(lats, tlat, periodic=False)
    lo0, lo1, wo = _bilinear_1d(lons, tlon, periodic=True)
    n_t = tlat.size
    rows = np.repeat(np.arange(n_t, dtype=np.int64), 4)
    cols = np.stack(
        [la0 * w + lo0, la0 * w + lo1, la1 * w + lo0, la1 * w + lo1], axis=1
    ).reshape(-1)
    vals = np.stack(
        [(1 - wa) * (1 - wo), (1 - wa) * wo, wa * (1 - wo), wa * wo], axis=1
    ).reshape(-1)
    return RemapWeights(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals.astype(np.float32),
        shape=(n_t, h * w),
    )


def cs_to_ll_weights(cs: CubedSphere, lats: np.ndarray, lons: np.ndarray) -> RemapWeights:
    """Bilinear weights sampling cubed-sphere fields at lat-lon grid points.

    For each lat-lon point: containing face via gnomonic projection, then
    bilinear interpolation in the face's equiangular coordinates, clamped at
    face boundaries (constant extrapolation over the outer half-cell — O(h)
    on an O(h)-wide strip; the conservative C++ generator removes even that).
    """
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    glat, glon = np.meshgrid(lats, lons, indexing="ij")
    p = np.stack(
        [
            np.cos(glat) * np.cos(glon),
            np.cos(glat) * np.sin(glon),
            np.sin(glat),
        ],
        axis=-1,
    ).reshape(-1, 3)
    face, a, b = xyz_to_face_angles(p)
    centers = cs.center_angles
    ia0, ia1, wa = _bilinear_1d(centers, a, periodic=False)
    ib0, ib1, wb = _bilinear_1d(centers, b, periodic=False)
    n = cs.n
    base = face * n * n
    # cell index = face*n*n + i(b/eta row)*n + j(a/xi col)
    rows = np.repeat(np.arange(p.shape[0], dtype=np.int64), 4)
    cols = np.stack(
        [
            base + ib0 * n + ia0,
            base + ib0 * n + ia1,
            base + ib1 * n + ia0,
            base + ib1 * n + ia1,
        ],
        axis=1,
    ).reshape(-1)
    vals = np.stack(
        [(1 - wb) * (1 - wa), (1 - wb) * wa, wb * (1 - wa), wb * wa], axis=1
    ).reshape(-1)
    return RemapWeights(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals.astype(np.float32),
        shape=(p.shape[0], 6 * n * n),
    )
