"""Example 1: build a cubed-sphere predictor store.

The counterpart of the reference's ``examples/01_build_dataset.py``: with
ERA5 netCDF files present (``dlwp_cs_tpu_torch.data.ERA5Reanalysis``),
point ``--era5-dir`` at them; otherwise an analytic lat-lon "reanalysis"
(travelling waves and a seasonal cycle) is generated, so the whole chain
runs offline.  The ``Preprocessor`` remaps it on ``--device`` and writes
``predictors_cs.h5`` (HDF5: needs h5py).

Usage:
  python -m dlwp_cs_tpu_torch.examples.01_build_dataset --workdir /tmp/dlwp \\
      --grid 24 [--nlat 46 --nlon 90 --days 120] [--era5-dir DIR] \\
      [--remap conservative|bilinear] [--device cpu]

The conservative weights come from the C++ generator (built into
``dlwp_cs_tpu_torch/_build/``, needs g++) and are cached in the workdir.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data import Preprocessor
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.remap import latlon_grid

__all__ = ["build_store", "main", "read_sources", "synthetic_sources"]


def synthetic_sources(n_lat: int, n_lon: int, days: float, step_hours: float, *,
                      cell_centered: bool = True):
    """Analytic lat-lon 'reanalysis': travelling waves and a seasonal cycle.

    Returns ``(sources, constants, lats, lons, times)``: z500, z1000,
    tau300-700 and t2m as float64 ``(T, H, W)``, two ``(H, W)`` constants,
    the grid in radians (``latlon_grid(n_lat, n_lon, cell_centered=...)``;
    ``cell_centered=False`` puts points on the poles, as ERA5's grid) and
    the times in days since 2000-01-01."""
    lats, lons = latlon_grid(n_lat, n_lon, cell_centered=cell_centered)
    glat, glon = np.meshgrid(lats, lons, indexing="ij")
    times = np.arange(0.0, days, step_hours / 24.0)
    t = times[:, None, None]
    x = np.cos(glat) * np.cos(glon)
    y = np.cos(glat) * np.sin(glon)
    z = np.sin(glat)
    season = np.cos(2 * np.pi * t / 365.25)

    def wave(k, c, amp):
        return amp * np.cos(k * glon - c * 2 * np.pi * t) * np.cos(glat) ** 2

    sources = {
        "z500": 5500.0 + 100.0 * z[None] * season + wave(4, 0.35, 80.0),
        "z1000": 100.0 + 40.0 * z[None] * season + wave(3, 0.30, 40.0),
        "tau300-700": 7500.0 - 300.0 * np.abs(z)[None] + wave(5, 0.4, 60.0),
        "t2m": 288.0 - 30.0 * z[None] ** 2 + 10.0 * z[None] * season + wave(6, 0.5, 2.0),
    }
    constants = {
        "topography": np.maximum(0.0, 2000.0 * (x * y + 0.3 * z * z)),
        "land_sea_mask": (x * y + 0.3 * z > 0).astype(np.float64),
    }
    return sources, constants, lats, lons, times


def read_sources(era5_dir=None, *, n_lat: int = 46, n_lon: int = 90, days: float = 120.0,
                 step_hours: float = 6.0):
    """``(sources, constants, lats, lons, times)``: z and t2m at 500 and 1000
    hPa from the ERA5 files under ``era5_dir`` (no constants), else
    :func:`synthetic_sources`."""
    if era5_dir:
        from dlwp_cs_tpu_torch.data import ERA5Reanalysis

        sources, lats, lons, times = ERA5Reanalysis(root_directory=era5_dir).open(
            ["z", "t2m"], [500, 1000])
        return sources, {}, lats, lons, times
    return synthetic_sources(n_lat, n_lon, days, step_hours)


def build_store(sources, constants, lats, lons, times, *, grid: int,
                remap: str = "conservative", path=None, cache_dir=None, device=None):
    """Remap ``sources`` (and ``constants``) to a C``grid`` store on
    ``device`` (``None``: the GPU): exact conservative weights from the C++
    generator (cached under ``cache_dir``) or bilinear ones.  Writes HDF5 to
    ``path`` when given; returns the ``MemoryStore``.

    The conservative weights take the grid's kind from ``lats``: cells
    centred between the poles, or points on them (ERA5's grid, and
    ``synthetic_sources(cell_centered=False)``)."""
    if remap not in ("conservative", "bilinear"):
        raise ValueError(f"remap must be conservative|bilinear, got {remap!r}")
    weights = None
    if remap == "conservative":
        from dlwp_cs_tpu_torch.remap import conservative_weights

        on_poles = bool(np.isclose(np.abs(np.asarray(lats)).max(), np.pi / 2))
        weights = conservative_weights("ll2cs", n_lat=len(lats), n_lon=len(lons), n_cs=grid,
                                       lat_centered=not on_poles, cache_dir=cache_dir)
    pre = Preprocessor(sources, lats, lons, times)
    return pre.data_to_series(grid, weights=weights, constant_sources=constants or None,
                              path=path, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--grid", type=int, default=24, help="cubed-sphere C{n}")
    ap.add_argument("--nlat", type=int, default=46)
    ap.add_argument("--nlon", type=int, default=90)
    ap.add_argument("--days", type=float, default=120.0)
    ap.add_argument("--step-hours", type=float, default=6.0)
    ap.add_argument("--era5-dir", default=None, help="dir of downloaded ERA5 files")
    ap.add_argument(
        "--remap",
        default="conservative",
        choices=("conservative", "bilinear"),
        help="ll->cs regridding: exact conservative weights (C++ generator, "
        "the default — requires a C++ toolchain) or bilinear",
    )
    ap.add_argument("--device", default=None, help="device of the remap (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises before any work without a GPU
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    sources, constants, lats, lons, times = read_sources(
        args.era5_dir, n_lat=args.nlat, n_lon=args.nlon, days=args.days,
        step_hours=args.step_hours)
    path = workdir / "predictors_cs.h5"
    store = build_store(sources, constants, lats, lons, times, grid=args.grid,
                        remap=args.remap, path=path, cache_dir=workdir, device=device)
    print(
        f"wrote {path}: fields {store.fields.shape}, "
        f"vars {store.variables}, constants {store.constant_names}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
