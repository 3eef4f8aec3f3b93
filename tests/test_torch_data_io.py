"""The port's data file I/O against the JAX package's: HDF5 stores, the
ERA5 / CFSR netCDF readers, the GRIB2 decoder and the tensorstore cache.

Every file is written by the test itself: HDF5 with h5py (the reference
test's ERA5 writer, ``tests/test_era5.py::_write_era5_like``), GRIB2 with
the reference test's encoder (``tests/test_grib2.py::encode_grib2``), the
stores by either package's writer.  The readers are the same numpy code in
both packages, so everything read must be bitwise equal, and either
package must read the other's stores.  No test retrieves anything: ERA5
retrieval is only called where ``cdsapi`` is missing, which raises before
any connection, and CFS retrieval is not called.
"""

import builtins
import importlib.util

import numpy as np
import pytest

import dlwp_cs_tpu.data as jdata
from dlwp_cs_tpu.data import era5 as jera5
from dlwp_cs_tpu.data import grib2 as jgrib2
from dlwp_cs_tpu.geometry import CubedSphere as JCubedSphere
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu_torch import data as tdata
from dlwp_cs_tpu_torch.data import era5 as tera5
from dlwp_cs_tpu_torch.data import grib2 as tgrib2
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.models import DataConfig
from tests.test_era5 import _write_era5_like
from tests.test_grib2 import _field, encode_grib2

h5py = pytest.importorskip("h5py")

N, T = 6, 24


def _store(pkg, *, constants=True, normalized=False):
    rng = np.random.default_rng(0)
    store = pkg.MemoryStore.from_raw(
        (rng.normal(size=(T, 6, N, N, 2)) * 5 + 3).astype(np.float32),
        np.arange(T) * 0.25, ("z500", "t2m"),
        constants=rng.normal(size=(6, N, N, 2)).astype(np.float32) if constants else None,
        constant_names=("topo", "lsm") if constants else (),
        attrs={"grid_n": N, "source_grid": [19, 36]})
    return pkg.normalize_store(store) if normalized else store


def _assert_same_store(a, b):
    np.testing.assert_array_equal(np.asarray(a.fields), np.asarray(b.fields))
    for k in ("times", "mean", "std"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.variables == b.variables and a.constant_names == b.constant_names
    assert a.attrs == b.attrs
    if a.constants is None:
        assert b.constants is None
    else:
        np.testing.assert_array_equal(a.constants, b.constants)


@pytest.mark.parametrize("constants", [True, False])
def test_h5_store_round_trip_and_cross_package(tmp_path, constants):
    ours = _store(tdata, constants=constants)
    path = tdata.write_store(tmp_path / "sub" / "ours.h5", ours)
    back = tdata.open_store(path)
    assert isinstance(back, tdata.H5Store) and back.grid_n == N
    assert back.fields.chunks == (1, 6, N, N, 2)
    _assert_same_store(back, ours)
    loaded = back.load()
    assert isinstance(loaded, tdata.MemoryStore)
    _assert_same_store(loaded, ours)
    back.close()
    # the reference reads the port's file, and the port the reference's
    _assert_same_store(jdata.open_store(path).load(), ours)
    ref_path = jdata.write_store(tmp_path / "ref.h5", _store(jdata, constants=constants))
    _assert_same_store(tdata.open_store(ref_path).load(), ours)


@pytest.mark.parametrize("normalized", [False, True])
def test_series_dataset_from_h5_store_matches_reference(tmp_path, normalized):
    ours = tdata.open_store(tdata.write_store(tmp_path / "o.h5", _store(tdata,
                                                                        normalized=normalized)))
    ref = jdata.open_store(jdata.write_store(tmp_path / "r.h5", _store(jdata,
                                                                       normalized=normalized)))
    kw = dict(grid_n=N, variables=("z500", "t2m"), constants=("lsm",))
    lat, lon = CubedSphere(N).cell_latlon
    common = dict(lat=lat, lon=lon, batch_size=4, shuffle=True, seed=3)
    ds = tdata.SeriesDataset(ours, DataConfig(**kw), **common)
    jlat, jlon = JCubedSphere(N).cell_latlon
    jds = jdata.SeriesDataset(ref, JDataConfig(**kw), **dict(common, lat=jlat, lon=jlon))
    assert ds.prenormalized == jds.prenormalized == normalized
    assert len(ds) == len(jds) > 2
    for (x, y), (jx, jy) in zip(ds, jds):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    ours.close()
    ref.close()


def test_estimator_trains_from_an_h5_store(tmp_path):
    """``DLWPEstimator.fit`` from an ``H5Store`` (its fields read one unique
    time at a time) ends at the parameters of the same fit from the
    ``MemoryStore``: the same batches."""
    import torch

    from dlwp_cs_tpu_torch import DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch.models import UNetConfig
    from dlwp_cs_tpu_torch.models.config import TrainConfig

    store = _store(tdata)
    h5 = tdata.open_store(tdata.write_store(tmp_path / "s.h5", store))
    cfg = ExperimentConfig(
        data=DataConfig(grid_n=N, variables=store.variables, constants=("lsm",)),
        model=UNetConfig(filters=(4,)), train=TrainConfig(batch_size=4, max_epochs=1))
    ours = DLWPEstimator(cfg, device="cpu").fit(h5, verbose=False)
    ref = DLWPEstimator(cfg, device="cpu").fit(store, verbose=False)
    assert len(ours._last_history.steps) == 5
    for (k, a), (_, b) in zip(ours.model.named_parameters(), ref.model.named_parameters()):
        assert torch.equal(a, b), k
    h5.close()


def test_without_h5py_the_store_functions_name_it(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **kw)

    path = tdata.write_store(tmp_path / "s.h5", _store(tdata))
    _write_era5_like(tmp_path / "z_500.nc", "z")
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for call in (lambda: tdata.write_store(tmp_path / "t.h5", _store(tdata)),
                 lambda: tdata.open_store(path),
                 lambda: tdata.read_netcdf_var(tmp_path / "z_500.nc", "z"),
                 lambda: tdata.ERA5Reanalysis(root_directory=tmp_path).open(["z"], [500])):
        with pytest.raises(ImportError, match="h5py"):
            call()
    lats, lons = np.linspace(-1.5, 1.5, 4), np.arange(8) * np.pi / 4
    pre = tdata.Preprocessor({"z500": np.zeros((2, 4, 8))}, lats, lons, [0.0, 0.25])
    with pytest.raises(ImportError, match="h5py"):
        pre.data_to_series(4, path=tmp_path / "p.h5", device="cpu")
    assert not (tmp_path / "t.h5").exists() and not (tmp_path / "p.h5").exists()


def test_cf_time_units_match_reference():
    for units in ("hours since 1900-01-01 00:00:00.0", "seconds since 1970-01-01",
                  "seconds since 1970-01-01T00:00:00Z", "days since 2000-01-01",
                  "minutes since 2000-01-02 12:00", b"hours since 1900-1-1",
                  "days since 1-1-1 0:0:0", "hrs since 2010-03-04 06:30:15.5+00:00"):
        assert tera5.parse_cf_time_units(units) == jera5.parse_cf_time_units(units)
    v = np.arange(5) * 21600.0
    np.testing.assert_array_equal(tera5.cf_time_to_epoch_days(v, "seconds since 1970-01-01"),
                                  jera5.cf_time_to_epoch_days(v, "seconds since 1970-01-01"))
    np.testing.assert_array_equal(tera5.netcdf_time_to_epoch_days(876576.0 + v),
                                  jera5.netcdf_time_to_epoch_days(876576.0 + v))
    for bad in ("fortnights since the epoch", "hours since someday", "hours since 2000-13-01"):
        with pytest.raises(ValueError):
            tera5.parse_cf_time_units(bad)


def _assert_same_read(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [
    dict(),  # legacy CDS schema: time in hours since 1900
    dict(packed=True),
    dict(schema="current", packed=True),  # valid_time in s since 1970, expver labels
    dict(expver_split=True),  # legacy ERA5/ERA5T (T, 2, H, W)
    dict(schema="current"),
])
def test_era5_reads_match_reference(tmp_path, case):
    path = tmp_path / "z_500.nc"
    _write_era5_like(path, "z", **case)
    for name in ("z", "latitude", "longitude"):
        _assert_same_read([tera5.read_netcdf_var(path, name)],
                          [jera5.read_netcdf_var(path, name)])
    ours = tera5.read_era5_file(path)
    _assert_same_read(ours, jera5.read_era5_file(path))
    assert ours[1][0] < ours[1][-1] and np.all(np.isfinite(ours[0]))


def test_era5_fill_markers_longitudes_and_open_match_reference(tmp_path):
    # both CF gap markers, packed
    p = tmp_path / "mv.nc"
    with h5py.File(p, "w") as f:
        stored = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
        stored[0, 1, 2], stored[1, 2, 3] = -32767, -9999
        ds = f.create_dataset("z", data=stored)
        ds.attrs["_FillValue"] = np.int16(-32767)
        ds.attrs["missing_value"] = np.int16(-9999)
        ds.attrs["scale_factor"] = np.float64(0.5)
        ds.attrs["add_offset"] = np.float64(100.0)
    out = tera5.read_netcdf_var(p, "z")
    assert np.isnan(out).sum() == 2
    _assert_same_read([out], [jera5.read_netcdf_var(p, "z")])
    with pytest.raises(KeyError):
        tera5.read_netcdf_var(p, "nope")
    # a [-180, 180) longitude subset grid is re-sorted to [0, 2 pi)
    q = tmp_path / "shift.nc"
    _write_era5_like(q, "t2m")
    with h5py.File(q, "a") as f:
        lon = f["longitude"][...]
        del f["longitude"]
        f.create_dataset("longitude", data=np.where(lon >= 180.0, lon - 360.0, lon))
    ours = tera5.read_era5_file(q)
    _assert_same_read(ours, jera5.read_era5_file(q))
    assert np.all(np.diff(ours[2]) > 0) and ours[2].min() >= 0
    # ERA5Reanalysis.open over mixed schemas, and its refusals
    _write_era5_like(tmp_path / "z_500.nc", "z")
    _write_era5_like(tmp_path / "t2m_single.nc", "t2m", schema="current")
    era, jera = (pkg.ERA5Reanalysis(root_directory=tmp_path) for pkg in (tdata, jdata))
    ours, ref = era.open(["z", "t2m"], [500]), jera.open(["z", "t2m"], [500])
    assert sorted(ours[0]) == sorted(ref[0]) == ["t2m", "z500"]
    _assert_same_read([ours[0][k] for k in ("z500", "t2m")] + list(ours[1:]),
                      [ref[0][k] for k in ("z500", "t2m")] + list(ref[1:]))
    with pytest.raises(FileNotFoundError):
        era.open(["z"], [850])
    _write_era5_like(tmp_path / "z_700.nc", "z", lat0=89.0)
    with pytest.raises(ValueError, match="latitude"):
        era.open(["z"], [500, 700])
    with h5py.File(tmp_path / "z_500.nc", "a") as f:
        del f["time"].attrs["units"]
    with pytest.raises(ValueError, match="units"):
        tera5.read_era5_file(tmp_path / "z_500.nc")


@pytest.mark.skipif(importlib.util.find_spec("cdsapi") is not None,
                    reason="cdsapi is installed: retrieve would try the network")
def test_era5_retrieve_raises_without_cdsapi(tmp_path):
    era = tdata.ERA5Reanalysis(root_directory=tmp_path)
    with pytest.raises(RuntimeError, match="cdsapi"):
        era.retrieve(["z"], [500], years=[2020])
    assert tera5.VARIABLE_TABLE == jera5.VARIABLE_TABLE


@pytest.mark.parametrize("template", [0, 2, 3, 40])
def test_grib2_templates_decode_bitwise_equal(tmp_path, template):
    f, lat, lon = _field(seed=template)
    p = tmp_path / "t.grb2"
    mask = np.random.default_rng(2).random(f.shape) > 0.3 if template == 0 else None
    p.write_bytes(encode_grib2(f, lat, lon, template=template)
                  + encode_grib2(f[::-1], lat, lon, template=template, bitmap=mask))
    ours, ref = tgrib2.read_grib2(p), jgrib2.read_grib2(p)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert (a.param, a.surface_type, a.surface_value, a.ref_time_days) == (
            b.param, b.surface_type, b.surface_value, b.ref_time_days)
        for k in ("lats", "lons", "values"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_allclose(ours[0].values, f, atol=0.005)
    assert [m[:2] for m in tgrib2.scan_messages(p)] == [m[:2] for m in jgrib2.scan_messages(p)]
    assert tgrib2.read_grib2(p, param=(0, 3, 5)) and not tgrib2.read_grib2(p, param=(0, 0, 0))


def test_grib2_corrupt_messages_rejected(tmp_path):
    f, lat, lon = _field()
    raw = bytearray(encode_grib2(f, lat, lon, template=0))
    zero = bytearray(raw)
    zero[16:20] = (0).to_bytes(4, "big")
    (tmp_path / "zero.grb2").write_bytes(bytes(zero))
    with pytest.raises(ValueError, match="corrupt GRIB2 section"):
        tgrib2.read_grib2(tmp_path / "zero.grb2")
    pos = 16
    while pos < len(raw) - 4:
        seclen = int.from_bytes(raw[pos:pos + 4], "big")
        if raw[pos + 4] == 5:
            raw[pos + 9:pos + 11] = (4).to_bytes(2, "big")  # IEEE floats
            break
        pos += seclen
    (tmp_path / "ieee.grb2").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="5.4"):
        tgrib2.read_grib2(tmp_path / "ieee.grb2")


def test_cfsr_open_and_open_grib_match_reference(tmp_path):
    f, lat, lon = _field(seed=5)
    p = tmp_path / "z500.l.gdas.202001.grb2"
    p.write_bytes(encode_grib2(f, lat, lon, template=3))
    for cls in ("CFSReanalysis", "CFSReforecast"):
        ours = getattr(tdata, cls)(root_directory=tmp_path).open_grib(p, param=(0, 3, 5))
        ref = getattr(jdata, cls)(root_directory=tmp_path).open_grib(p, param=(0, 3, 5))
        assert len(ours) == len(ref) == 1
        np.testing.assert_array_equal(ours[0].values, ref[0].values)
    # a netCDF conversion (wgrib2 style: seconds since 1970, north -> south)
    nc = tmp_path / "z500.nc"
    with h5py.File(nc, "w") as h:
        h.create_dataset("z", data=np.stack([f, f + 1.0]))
        h.create_dataset("latitude", data=lat)
        h.create_dataset("longitude", data=lon)
        h.create_dataset("time", data=np.asarray([1.5e9, 1.5e9 + 21600])).attrs["units"] = \
            "seconds since 1970-01-01 00:00:00"
    ours = tdata.CFSReanalysis(root_directory=tmp_path).open(nc, "z")
    _assert_same_read(ours, jdata.CFSReanalysis(root_directory=tmp_path).open(nc, "z"))
    assert ours[1][0] < ours[1][-1]
    assert tdata.CFSReforecast().file_format == jdata.CFSReforecast().file_format
    assert tdata.CFSReanalysis()._target("z500", 2020, 1) == \
        jdata.CFSReanalysis()._target("z500", 2020, 1)


def test_tscache_round_trip_and_cross_package(tmp_path):
    pytest.importorskip("tensorstore")
    from dlwp_cs_tpu.data import tscache as jts
    from dlwp_cs_tpu_torch.data import tscache as tts

    store = _store(tdata)
    back = tts.open_ts_cache(tts.write_ts_cache(tmp_path / "cache", store))
    assert back.grid_n == N
    np.testing.assert_array_equal(back.fields[3], store.fields[3])
    np.testing.assert_array_equal(back.fields[[5, 2]], store.fields[[5, 2]])
    _assert_same_store(back.load(), store)
    _assert_same_store(jts.open_ts_cache(tmp_path / "cache").load(), store)
    jts.write_ts_cache(tmp_path / "ref", _store(jdata))
    _assert_same_store(tts.open_ts_cache(tmp_path / "ref").load(), store)
    lat, lon = CubedSphere(N).cell_latlon
    cfg = DataConfig(grid_n=N, variables=store.variables, constants=("topo",))
    x1, y1 = next(iter(tdata.SeriesDataset(store, cfg, lat=lat, lon=lon, batch_size=4)))
    x2, y2 = next(iter(tdata.SeriesDataset(back, cfg, lat=lat, lon=lon, batch_size=4)))
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
