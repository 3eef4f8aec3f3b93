"""The port's ``Preprocessor`` (``dlwp_cs_tpu_torch.data.preprocessing``)
against the JAX package's.

The same analytic lat-lon sources (travelling waves and a seasonal cycle,
as ``examples/01_build_dataset.py`` makes them, plus seeded noise), a
derived thickness and two constants go through both packages' chains with
bilinear and with exact conservative weights; the port remaps on the CPU
here (``device="cpu"``), the reference with ``RemapWeights.apply_numpy``.
Tolerances: fields 1e-5 of each variable's largest |value| (float32 sums of
a row's nonzeros; measured 0, the same sums in the same order); mean and
std 1e-6 relative; the standardized constants 1e-5.
"""

import numpy as np
import pytest

import dlwp_cs_tpu.data as jdata
from dlwp_cs_tpu_torch.data import Preprocessor, open_store
from dlwp_cs_tpu_torch.remap import conservative_weights, latlon_grid

H, W, N, T = 19, 36, 6, 10


def _sources(cell_centered=True):
    lats, lons = latlon_grid(H, W, cell_centered=cell_centered)
    glat, glon = np.meshgrid(lats, lons, indexing="ij")
    times = np.arange(T) * 0.25
    t = times[:, None, None]
    z = np.sin(glat)
    noise = np.random.default_rng(0).normal(size=(T, H, W))
    wave = lambda k, c, amp: amp * np.cos(k * glon - c * 2 * np.pi * t) * np.cos(glat) ** 2
    sources = {
        "z500": 5500.0 + 100.0 * z[None] * np.cos(2 * np.pi * t / 365.25) + wave(4, 0.35, 80.0),
        "z300": 9000.0 + wave(5, 0.4, 60.0) + noise,
        "z700": 3000.0 - 50.0 * np.abs(z)[None] + wave(3, 0.3, 40.0),
        "t2m": (288.0 - 30.0 * z[None] ** 2 + noise).astype(np.float32),
    }
    x, y = np.cos(glat) * np.cos(glon), np.cos(glat) * np.sin(glon)
    constants = {"topography": np.maximum(0.0, 2000.0 * (x * y + 0.3 * z * z)),
                 "land_sea_mask": (x * y + 0.3 * z > 0).astype(np.int32)}
    return sources, constants, lats, lons, times


DERIVED = {"tau300-700": (("z300", "z700"), lambda a, b: a - b)}


def _both(weights, cell_centered=True, **kw):
    sources, constants, lats, lons, times = _sources(cell_centered)
    ours = Preprocessor(sources, lats, lons, times, derived=DERIVED).data_to_series(
        N, weights=weights, constant_sources=constants, device="cpu", **kw)
    ref = jdata.Preprocessor(sources, lats, lons, times, derived=DERIVED).data_to_series(
        N, weights=weights, constant_sources=constants, **kw)
    return ours, ref


def _assert_close(ours, ref):
    assert ours.fields.dtype == np.float32 and ours.fields.shape == ref.fields.shape
    assert ours.variables == ref.variables and ours.constant_names == ref.constant_names
    assert ours.attrs == ref.attrs
    scale = np.abs(ref.fields).max(axis=(0, 1, 2, 3))
    assert np.all(np.abs(ours.fields - ref.fields).max(axis=(0, 1, 2, 3)) <= 1e-5 * scale)
    np.testing.assert_allclose(ours.mean, ref.mean, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.std, ref.std, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.constants, ref.constants, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.times, ref.times)


@pytest.mark.parametrize("batch_size", [256, 4])
@pytest.mark.parametrize("scaler", ["standard", "robust"])
def test_bilinear_store_matches_reference(batch_size, scaler):
    ours, ref = _both(None, batch_size=batch_size, scaler=scaler)
    assert ours.variables == ("z500", "z300", "z700", "t2m", "tau300-700")
    _assert_close(ours, ref)
    # the derived variable is the remap of the difference: linear
    np.testing.assert_allclose(ours.fields[..., 4], ours.fields[..., 1] - ours.fields[..., 2],
                               rtol=0, atol=1e-5 * np.abs(ours.fields[..., 1]).max())


@pytest.mark.parametrize("cell_centered", [True, False])
def test_conservative_store_matches_reference(tmp_path, cell_centered):
    w = conservative_weights("ll2cs", n_lat=H, n_lon=W, n_cs=N,
                             lat_centered=cell_centered, cache_dir=tmp_path)
    assert np.diff(np.bincount(w.rows)).any()  # rows of unequal lengths
    ours, ref = _both(w, cell_centered=cell_centered, batch_size=3,
                      variables=["t2m", "tau300-700"], path=tmp_path / "cs.h5")
    _assert_close(ours, ref)
    # the written store reads back in both packages
    for back in (open_store(tmp_path / "cs.h5"), jdata.open_store(tmp_path / "cs.h5")):
        np.testing.assert_array_equal(np.asarray(back.fields), ours.fields)
        np.testing.assert_array_equal(back.mean, ours.mean)
        back.close()


def test_bad_inputs_rejected_as_the_reference_does():
    lats, lons = np.linspace(-1.5, 1.5, 4), np.linspace(0, 6, 8)
    for args, kw, match in (
        (({}, lats, lons, np.arange(3)), {}, "no source"),
        (({"x": np.zeros((3, 5, 8))}, lats, lons, np.arange(3)), {}, "shape"),
        (({"x": np.zeros((3, 4, 8))}, lats, lons, np.arange(3)),
         {"derived": {"x": (("x",), lambda a: a)}}, "shadows a source"),
        (({"x": np.zeros((3, 4, 8))}, lats, lons, np.arange(3)),
         {"derived": {"y": (("z",), lambda a: a)}}, "unknown sources"),
    ):
        with pytest.raises(ValueError, match=match):
            Preprocessor(*args, **kw)
        with pytest.raises(ValueError, match=match):
            jdata.Preprocessor(*args, **kw)
    pre = Preprocessor({"x": np.zeros((3, 4, 8))}, lats, lons, np.arange(3),
                       derived={"y": (("x",), lambda a: a[..., :4])})
    with pytest.raises(ValueError, match="unknown variables"):
        pre.data_to_series(8, variables=["nope"], device="cpu")
    with pytest.raises(ValueError, match="returned shape"):
        pre.data_to_series(8, variables=["y"], device="cpu")
    with pytest.raises(ValueError, match="ascending"):  # a north -> south axis
        Preprocessor({"x": np.zeros((3, 4, 8))}, lats[::-1], lons,
                     np.arange(3)).data_to_series(8, device="cpu")
