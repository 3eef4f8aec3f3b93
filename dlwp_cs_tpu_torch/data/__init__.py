"""Data pipeline: stores, series windowing, prefetch, preprocessing, and the
ERA5 / CFSR / GRIB2 readers."""

from dlwp_cs_tpu_torch.data.cfsr import CFSReanalysis, CFSReforecast
from dlwp_cs_tpu_torch.data.channels import (
    advance_window,
    fold_time,
    make_input_insolation,
    pack_inputs,
    unfold_time,
)
from dlwp_cs_tpu_torch.data.era5 import ERA5Reanalysis, read_era5_file, read_netcdf_var
from dlwp_cs_tpu_torch.data.grib2 import Grib2Record, read_grib2
from dlwp_cs_tpu_torch.data.prefetch import PrefetchIterator, prefetch_to_device
from dlwp_cs_tpu_torch.data.preprocessing import Preprocessor
from dlwp_cs_tpu_torch.data.series import SeriesDataset, insolation_stats
from dlwp_cs_tpu_torch.data.store import (
    H5Store,
    MemoryStore,
    normalize_store,
    open_store,
    select_constants,
    write_store,
)
from dlwp_cs_tpu_torch.data.tscache import TSStore, open_ts_cache, write_ts_cache

__all__ = [
    "CFSReanalysis",
    "CFSReforecast",
    "ERA5Reanalysis",
    "Grib2Record",
    "H5Store",
    "MemoryStore",
    "PrefetchIterator",
    "Preprocessor",
    "SeriesDataset",
    "TSStore",
    "advance_window",
    "fold_time",
    "insolation_stats",
    "make_input_insolation",
    "normalize_store",
    "open_store",
    "open_ts_cache",
    "pack_inputs",
    "prefetch_to_device",
    "read_era5_file",
    "read_grib2",
    "read_netcdf_var",
    "select_constants",
    "unfold_time",
    "write_store",
    "write_ts_cache",
]
