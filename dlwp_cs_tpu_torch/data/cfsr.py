"""NOAA CFS reanalysis/reforecast acquisition (legacy parity).

A copy of ``dlwp_cs_tpu.data.cfsr``: download managers for the NOAA CFS
products of the 2019 lat-lon paper.  Retrieval fetches NCEI/NOMADS URLs
and raises a clear error without network access; ``open_grib`` decodes raw
``.grb2`` files with the first-party :mod:`dlwp_cs_tpu_torch.data.grib2`;
``open`` reads netCDF conversions through h5py (imported lazily, see
:mod:`dlwp_cs_tpu_torch.data.era5`).
"""

from __future__ import annotations

import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data.era5 import cf_time_to_epoch_days, read_netcdf_var
from dlwp_cs_tpu_torch.data.store import import_h5py

__all__ = ["CFSReanalysis", "CFSReforecast"]

# Alternative mirror for recent data — pass as ``base_url=NOMADS`` (the
# NCEI archive below is the default; it carries the full record).
NOMADS = "https://nomads.ncep.noaa.gov/pub/data/nccf/cfsr"
_NCDC = "https://www.ncei.noaa.gov/data/climate-forecast-system"


@dataclass
class CFSReanalysis:
    """CFS reanalysis download manager (monthly grib2 product files)."""

    root_directory: str | Path = "cfsr"
    file_format: str = "{var}.l.gdas.{yyyymm}.grb2"
    base_url: str = _NCDC
    # URL path segment between base_url and the per-year directory —
    # overridden by the reforecast subclass (different product layout)
    product_path: str = "reanalysis/monthly"

    def _target(self, var: str, year: int, month: int) -> Path:
        return Path(self.root_directory) / self.file_format.format(
            var=var, yyyymm=f"{year}{month:02d}"
        )

    def retrieve(self, variables, years, months=None, *, overwrite=False):
        """Download monthly grib2 files; returns the local paths."""
        months = months or list(range(1, 13))
        Path(self.root_directory).mkdir(parents=True, exist_ok=True)
        paths = []
        for var in variables:
            for year in years:
                for month in months:
                    target = self._target(var, year, month)
                    if target.exists() and not overwrite:
                        paths.append(target)
                        continue
                    url = (
                        f"{self.base_url}/{self.product_path}/{year}"
                        f"/{target.name}"
                    )
                    # download to a tmp name and rename: a dropped connection
                    # must not leave a partial file that the next retrieve()
                    # mistakes for a complete cached download
                    tmp = target.with_name(target.name + ".part")
                    try:
                        urllib.request.urlretrieve(url, tmp)
                        tmp.replace(target)
                    except (urllib.error.URLError, OSError) as e:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(
                            f"CFS retrieval needs network access (failed on "
                            f"{url}); run on a connected machine"
                        ) from e
                    paths.append(target)
        return paths

    def open_grib(self, path, *, param=None):
        """Decode a raw .grb2 file with the first-party GRIB2 reader.

        Returns the list of :class:`dlwp_cs_tpu_torch.data.grib2.Grib2Record`
        (``param=(discipline, category, number)`` filters).
        """
        from dlwp_cs_tpu_torch.data.grib2 import read_grib2

        return read_grib2(path, param=param)

    def open(self, path, variable: str):
        """Open a converted netCDF file: returns (data, lats, lons, times).

        The time axis is decoded from the file's own CF ``units`` attribute
        (wgrib2 conversions commonly use 'seconds since 1970-01-01', not the
        ERA5 'hours since 1900' epoch a fixed helper would assume).
        """
        h5py = import_h5py("the netCDF4 readers")

        data = read_netcdf_var(path, variable)
        lats = np.deg2rad(read_netcdf_var(path, "latitude"))
        lons = np.deg2rad(read_netcdf_var(path, "longitude"))
        with h5py.File(path, "r") as f:
            units = f["time"].attrs.get("units", None)
        if units is None:
            raise ValueError(
                f"time variable in {path} has no CF 'units' attribute; "
                "cannot decode the epoch safely"
            )
        times = cf_time_to_epoch_days(read_netcdf_var(path, "time"), units)
        if lats[0] > lats[-1]:
            lats = lats[::-1]
            data = data[:, ::-1]
        return data, lats, lons, times


@dataclass
class CFSReforecast(CFSReanalysis):
    """CFS reforecast product manager (same mechanics, different layout)."""

    file_format: str = "{var}.{yyyymm}.time.grb2"
    product_path: str = "reforecast/monthly"
