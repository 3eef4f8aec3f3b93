"""ERA5 acquisition via the Copernicus CDS API, and its netCDF readers.

A copy of ``dlwp_cs_tpu.data.era5``: variable tables mapping short names
to CDS product names, parallel per-variable/level retrieval through
``cdsapi``, and an ``open()`` that exposes downloaded files as arrays for
the :class:`~dlwp_cs_tpu_torch.data.preprocessing.Preprocessor`.
``retrieve`` needs ``cdsapi`` and network access and raises a clear error
without ``cdsapi``; ``open`` reads downloaded netCDF4 files with h5py
(netCDF4 files are HDF5), imported lazily: without h5py (the GPU machine
has none) the readers raise an ``ImportError`` that says so.
"""

from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data.store import import_h5py

__all__ = [
    "ERA5Reanalysis",
    "read_era5_file",
    "read_netcdf_var",
    "cf_time_to_epoch_days",
    "parse_cf_time_units",
    "netcdf_time_to_epoch_days",
]

# Short name -> (CDS dataset, CDS variable name, pressure-level product?)
VARIABLE_TABLE = {
    "z": ("reanalysis-era5-pressure-levels", "geopotential", True),
    "t": ("reanalysis-era5-pressure-levels", "temperature", True),
    "u": ("reanalysis-era5-pressure-levels", "u_component_of_wind", True),
    "v": ("reanalysis-era5-pressure-levels", "v_component_of_wind", True),
    "q": ("reanalysis-era5-pressure-levels", "specific_humidity", True),
    "r": ("reanalysis-era5-pressure-levels", "relative_humidity", True),
    "t2m": ("reanalysis-era5-single-levels", "2m_temperature", False),
    "tcwv": ("reanalysis-era5-single-levels", "total_column_water_vapour", False),
    "msl": ("reanalysis-era5-single-levels", "mean_sea_level_pressure", False),
    "sst": ("reanalysis-era5-single-levels", "sea_surface_temperature", False),
    "u10": ("reanalysis-era5-single-levels", "10m_u_component_of_wind", False),
    "v10": ("reanalysis-era5-single-levels", "10m_v_component_of_wind", False),
}

# Hours between 1900-01-01 (ERA5 time epoch) and 2000-01-01 (ours).
_ERA5_EPOCH_OFFSET_HOURS = 876_576.0

_CF_UNIT_DAYS = {
    "day": 1.0,
    "days": 1.0,
    "d": 1.0,
    "hour": 1.0 / 24.0,
    "hours": 1.0 / 24.0,
    "hr": 1.0 / 24.0,
    "hrs": 1.0 / 24.0,
    "h": 1.0 / 24.0,
    "minute": 1.0 / 1440.0,
    "minutes": 1.0 / 1440.0,
    "min": 1.0 / 1440.0,
    "mins": 1.0 / 1440.0,
    "second": 1.0 / 86400.0,
    "seconds": 1.0 / 86400.0,
    "sec": 1.0 / 86400.0,
    "secs": 1.0 / 86400.0,
    "s": 1.0 / 86400.0,
}


def parse_cf_time_units(units: str) -> tuple[float, float]:
    """Parse a CF time ``units`` string like ``'hours since 1900-01-01'``.

    Returns ``(scale_days, ref_offset_days)`` such that
    ``epoch_days = values * scale_days + ref_offset_days`` gives days since
    2000-01-01 00 UTC.  Handles the legacy CDS epoch (hours since 1900), the
    current one (``seconds since 1970-01-01``), and any other
    ``<unit> since <ISO datetime>`` combination.
    """
    import datetime
    import re

    if isinstance(units, bytes):
        units = units.decode()
    m = re.match(r"\s*([A-Za-z]+)\s+since\s+(.+?)\s*$", str(units))
    if not m:
        raise ValueError(f"unparseable CF time units {units!r}")
    unit, ref = m.group(1).lower(), m.group(2).strip()
    if unit not in _CF_UNIT_DAYS:
        raise ValueError(f"unknown CF time unit {unit!r} in {units!r}")
    ref = ref.replace("T", " ").removesuffix("Z").strip()
    # tolerate fractional-second and UTC-offset suffixes fromisoformat chokes on
    ref = re.sub(r"(\.\d+)?(\s*[+-]\d{2}:?\d{2})?$", "", ref).strip()
    # CF allows non-zero-padded dates ('hours since 1900-1-1', 'days since
    # 1-1-1 0:0:0' from older Unidata/CDO writers) that fromisoformat
    # rejects — parse the components directly.
    dm = re.match(
        r"^(\d{1,4})-(\d{1,2})-(\d{1,2})"
        r"(?:\s+(\d{1,2}):(\d{1,2})(?::(\d{1,2}))?)?$",
        ref,
    )
    if not dm:
        raise ValueError(f"unparseable reference date in CF units {units!r}")
    try:
        parts = [int(g) if g is not None else 0 for g in dm.groups()]
        ref_dt = datetime.datetime(*parts[:3], *parts[3:])
    except ValueError as e:
        raise ValueError(f"unparseable reference date in CF units {units!r}") from e
    offset = (ref_dt - datetime.datetime(2000, 1, 1)).total_seconds() / 86400.0
    return _CF_UNIT_DAYS[unit], offset


def cf_time_to_epoch_days(values, units: str) -> np.ndarray:
    """CF-encoded time values + units -> float64 days since 2000-01-01 00 UTC."""
    scale, offset = parse_cf_time_units(units)
    return np.asarray(values, np.float64) * scale + offset


def netcdf_time_to_epoch_days(hours_since_1900) -> np.ndarray:
    """ERA5 'hours since 1900-01-01' -> days since 2000-01-01 00 UTC.

    Legacy fixed-epoch helper; prefer :func:`cf_time_to_epoch_days`, which
    parses the file's actual ``units`` attribute.
    """
    return (np.asarray(hours_since_1900, np.float64) - _ERA5_EPOCH_OFFSET_HOURS) / 24.0


def read_netcdf_var(path, name: str) -> np.ndarray:
    """Read one variable from a netCDF4 file via h5py, applying the CF
    ``scale_factor``/``add_offset`` packing attributes if present."""
    h5py = import_h5py("the netCDF4 readers")

    with h5py.File(path, "r") as f:
        if name not in f:
            raise KeyError(f"{name!r} not in {path}; has {sorted(f.keys())}")
        ds = f[name]
        raw = np.asarray(ds)  # one disk read; reused for the fill-value mask
        scale = ds.attrs.get("scale_factor", None)
        offset = ds.attrs.get("add_offset", None)
        data = raw.astype(np.float64)
        # mask BOTH CF gap markers: files converted via wgrib2/CDO (and
        # older CDS products) often carry `missing_value` with no
        # `_FillValue`, and an unmasked packed fill integer would pass
        # through scale/offset as a plausible-looking extreme value
        for attr in ("_FillValue", "missing_value"):
            fill = ds.attrs.get(attr, None)
            if fill is not None:
                data[raw == np.asarray(fill)] = np.nan
        if scale is not None:
            data = data * float(np.asarray(scale))
        if offset is not None:
            data = data + float(np.asarray(offset))
        return data


@dataclass
class ERA5Reanalysis:
    """ERA5 download manager (API parity with the reference's class).

    ``retrieve`` downloads one netCDF file per (variable, level) in parallel;
    ``open`` returns ``{key: (T, H, W) array}`` plus coordinate vectors,
    ready for :class:`dlwp_cs_tpu_torch.data.preprocessing.Preprocessor`.
    """

    root_directory: str | Path = "era5"
    file_format: str = "{var}_{level}.nc"
    _files: dict = field(default_factory=dict)

    def _target(self, var: str, level: int | str) -> Path:
        return Path(self.root_directory) / self.file_format.format(
            var=var, level=level
        )

    def retrieve(
        self,
        variables: list[str],
        levels: list[int | str],
        *,
        years: list[int],
        months: list[int] | None = None,
        hours: list[int] | None = None,
        grid: tuple[float, float] = (1.0, 1.0),
        n_jobs: int = 4,
        overwrite: bool = False,
    ) -> list[Path]:
        """Download each (variable, level) product; returns file paths."""
        try:
            import cdsapi  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "cdsapi is not installed; ERA5 retrieval requires a machine "
                "with it and network access to the CDS. "
                "Previously downloaded files can still be opened with .open()."
            ) from e
        months = months or list(range(1, 13))
        hours = hours or [0, 6, 12, 18]
        jobs = []
        for var in variables:
            if var not in VARIABLE_TABLE:
                raise KeyError(f"unknown variable {var!r}; known {sorted(VARIABLE_TABLE)}")
            dataset, cds_name, has_levels = VARIABLE_TABLE[var]
            for level in levels if has_levels else ["single"]:
                target = self._target(var, level)
                if target.exists() and not overwrite:
                    continue
                req = {
                    "product_type": "reanalysis",
                    "variable": cds_name,
                    "year": [str(y) for y in years],
                    "month": [f"{m:02d}" for m in months],
                    "day": [f"{d:02d}" for d in range(1, 32)],
                    "time": [f"{h:02d}:00" for h in hours],
                    "grid": list(grid),
                    "format": "netcdf",
                }
                if has_levels:
                    req["pressure_level"] = str(level)
                jobs.append((dataset, req, target))
        Path(self.root_directory).mkdir(parents=True, exist_ok=True)

        def _one(job):
            import cdsapi

            dataset, req, target = job
            cdsapi.Client().retrieve(dataset, req, str(target))
            return target

        with concurrent.futures.ThreadPoolExecutor(max_workers=n_jobs) as pool:
            return list(pool.map(_one, jobs))

    def open(
        self,
        variables: list[str],
        levels: list[int | str],
        *,
        var_key_format: str = "{var}{level}",
    ):
        """Open downloaded files: returns (sources, lats_rad, lons_rad, times_days).

        ``sources`` maps e.g. ``z500`` -> (T, H, W) float array.  Latitudes
        are flipped to ascending and longitudes converted to [0, 2pi), the
        Preprocessor's convention.
        """
        sources = {}
        lats = lons = times = None
        ref_path = None
        for var in variables:
            _, _, has_levels = VARIABLE_TABLE[var]
            for level in levels if has_levels else ["single"]:
                path = self._target(var, level)
                if not path.exists():
                    raise FileNotFoundError(path)
                data, la, lo, tm = read_era5_file(path)
                key = (
                    var_key_format.format(var=var, level=level)
                    if has_levels
                    else var
                )
                sources[key] = data
                if lats is None:
                    lats, lons, times, ref_path = la, lo, tm, path
                else:
                    # grids/time axes MUST match across files — a silent
                    # misalignment here corrupts every downstream sample.
                    for name, a, b in (
                        ("latitude", lats, la),
                        ("longitude", lons, lo),
                        ("time", times, tm),
                    ):
                        if a.shape != b.shape or not np.allclose(a, b):
                            raise ValueError(
                                f"{name} axis of {path} does not match "
                                f"{ref_path}; refusing to merge misaligned files"
                            )
        return sources, lats, lons, times


# Coordinate / bookkeeping variable names across CDS product generations:
# legacy ('time', 'level') and current ('valid_time', 'pressure_level',
# 'expver' as a per-time label, 'number' ensemble dim).
_COORD_NAMES = {
    "latitude",
    "longitude",
    "lat",
    "lon",
    "time",
    "valid_time",
    "level",
    "pressure_level",
    "isobaricInhPa",
    "expver",
    "number",
}


def read_era5_file(path):
    """Read one ERA5 netCDF file -> ``(data (T,H,W), lats_rad, lons_rad,
    times_days)``.

    Handles both CDS schemas: legacy (``time`` in hours since 1900, optional
    ``(T, expver, H, W)`` ERA5/ERA5T split) and current (``valid_time`` in
    seconds since 1970, ``expver`` as a per-time string label).  The time
    axis is decoded from the variable's own CF ``units`` attribute — never a
    hardcoded epoch.  Latitudes are flipped ascending; longitudes left in
    [0, 360) degrees -> radians.
    """
    h5py = import_h5py("the netCDF4 readers")

    with h5py.File(path, "r") as f:
        time_name = next((n for n in ("time", "valid_time") if n in f), None)
        if time_name is None:
            raise KeyError(f"no time coordinate (time/valid_time) in {path}")
        units = f[time_name].attrs.get("units", None)
        lat_name = "latitude" if "latitude" in f else "lat"
        lon_name = "longitude" if "longitude" in f else "lon"
        expver_len = f["expver"].shape[0] if "expver" in f else None
    if units is None:
        raise ValueError(
            f"time variable {time_name!r} in {path} has no CF 'units' "
            "attribute; cannot decode the epoch safely"
        )
    tm = cf_time_to_epoch_days(read_netcdf_var(path, time_name), units)
    la = np.deg2rad(read_netcdf_var(path, lat_name))
    lo = np.deg2rad(read_netcdf_var(path, lon_name))
    data = read_netcdf_var(path, _guess_payload_name(path))
    # squeeze singleton ensemble/level axes: (T, 1, H, W) -> (T, H, W)
    while data.ndim > 3 and 1 in data.shape[1:-2]:
        ax = 1 + data.shape[1:-2].index(1)
        data = np.squeeze(data, axis=ax)
    if data.ndim == 4 and expver_len is not None and data.shape[1] == expver_len:
        # legacy ERA5/ERA5T split: each time exists in exactly one expver
        # slice (NaN in the other) — collapse by first-finite.
        out = data[:, 0]
        for i in range(1, data.shape[1]):
            out = np.where(np.isnan(out), data[:, i], out)
        data = out
    if data.ndim != 3:
        raise ValueError(
            f"payload in {path} has shape {data.shape}; expected (T, H, W) "
            "after squeezing — is this a multi-level file?"
        )
    if la[0] > la[-1]:  # ERA5 ships north->south; flip ascending
        la = la[::-1]
        data = data[:, ::-1]
    # normalize longitudes to [0, 2pi) ascending (the Preprocessor's
    # documented convention): a [-180, 180) CDS subset grid wraps under the
    # mod, so re-sort and roll the data columns with it
    lo = np.asarray(lo) % (2 * np.pi)
    if np.any(np.diff(lo) < 0):
        order = np.argsort(lo)
        lo = lo[order]
        data = data[..., order]
    return data, la, lo, tm


def _guess_payload_name(path) -> str:
    """Pick the payload variable in a netCDF file (not a coordinate)."""
    h5py = import_h5py("the netCDF4 readers")

    with h5py.File(path, "r") as f:
        names = [k for k in f.keys() if k not in _COORD_NAMES]
    if len(names) != 1:
        raise ValueError(f"ambiguous payload variables {names} in {path}")
    return names[0]
