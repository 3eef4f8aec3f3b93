"""The port's ``plot/`` against the JAX package's: the same inputs (numpy
on the reference's side, numpy or tensors on the port's) through each of
the six functions, and the artists of both figures compared: images'
arrays, colour limits and extents, lines' data, labels and styles,
collections' arrays and offsets, bars, titles and axis labels.  Both sides
run the same numpy and matplotlib code on the same values, so the data are
equal, with no tolerance; the errors are the same.
"""

import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dlwp_cs_tpu import plot as jplot  # noqa: E402
from dlwp_cs_tpu_torch import plot  # noqa: E402


def _data(a):
    return np.ma.filled(np.ma.asarray(a, dtype=np.float64), np.nan)


def _summary(fig):
    """What each axes of ``fig`` draws, as plain values."""
    out = [fig._suptitle.get_text() if fig._suptitle is not None else None]
    for ax in fig.axes:
        out.append({
            "labels": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.get_yscale(),
                       ax.name, ax.axison),
            "images": [(_data(im.get_array()), im.get_clim(), tuple(im.get_extent()),
                        im.get_cmap().name) for im in ax.images],
            "lines": [(_data(ln.get_xdata()), _data(ln.get_ydata()), ln.get_label(),
                       ln.get_linestyle()) for ln in ax.lines],
            "collections": [(None if c.get_array() is None else _data(c.get_array()),
                             _data(c.get_offsets()), c.get_clim()) for c in ax.collections],
            "bars": [(p.get_x(), p.get_height()) for p in ax.patches
                     if isinstance(p, matplotlib.patches.Rectangle)],
            "legend": None if ax.get_legend() is None
            else [t.get_text() for t in ax.get_legend().get_texts()],
        })
    return out


def _assert_same(ours, ref, where="figure"):
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys(), where
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (o, r) in enumerate(zip(ours, ref)):
            _assert_same(o, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ours, ref, err_msg=where)
    else:
        assert ours == ref or (ours != ours and ref != ref), (where, ours, ref)


def _compare(name, args_ours, args_ref, **kwargs):
    """The port's figure's summary, once checked equal to the reference's."""
    fig_o = getattr(plot, name)(*args_ours, **kwargs)
    fig_r = getattr(jplot, name)(*args_ref, **kwargs)
    try:
        ours = _summary(fig_o)
        _assert_same(ours, _summary(fig_r))
    finally:
        plt.close(fig_o)
        plt.close(fig_r)
    return ours


def _cube_field(nan=False):
    f = np.random.default_rng(0).normal(size=(6, 8, 8)).astype(np.float32)
    if nan:
        f[2, 3, 3] = np.nan
    return f


@pytest.mark.parametrize("case", ["numpy", "tensor_one_nan", "limits"])
def test_plot_cube_faces_matches_reference(case):
    f = _cube_field(nan=case == "tensor_one_nan")
    ours = torch.from_numpy(f) if case == "tensor_one_nan" else f
    kwargs = {"vmin": -1.0, "vmax": 2.0} if case == "limits" else {"title": "faces",
                                                                    "cmap": "viridis"}
    summary = _compare("plot_cube_faces", (ours,), (f,), **kwargs)
    panels = [ax for ax in summary[1:] if ax["images"]]
    assert len(panels) == 6
    lo, hi = panels[0]["images"][0][1]  # NaN-robust colour limits: one NaN blanks nothing
    assert np.isfinite(lo) and np.isfinite(hi) and hi > lo


def test_plot_cube_faces_writes_png_and_rejects_bad_shapes(tmp_path):
    f = torch.from_numpy(_cube_field()).requires_grad_(True)  # detached for the plot
    fig = plot.plot_cube_faces(f, title="t", out_path=tmp_path / "faces.png")
    plt.close(fig)
    assert (tmp_path / "faces.png").stat().st_size > 1000
    for bad in (np.zeros((5, 8, 8)), np.zeros((6, 8))):
        with pytest.raises(ValueError) as ref:
            jplot.plot_cube_faces(bad)
        with pytest.raises(ValueError) as ours:
            plot.plot_cube_faces(torch.from_numpy(bad))
        assert str(ours.value) == str(ref.value)


def _latlon_case():
    lats = np.linspace(-88.0, 88.0, 23)
    lons = np.arange(0.0, 360.0, 8.0)
    f = np.sin(np.radians(lats))[:, None] * np.cos(np.radians(2 * lons))[None, :]
    f[4, 7] = np.nan
    return f, lats, lons


@pytest.mark.parametrize("projection",
                         ["equirectangular", "mollweide", "hammer", "aitoff", "orthographic"])
def test_plot_latlon_map_matches_reference(projection):
    f, lats, lons = _latlon_case()
    _compare("plot_latlon_map", (torch.from_numpy(f), torch.from_numpy(lats), lons),
             (f, lats, lons), projection=projection, title=projection, center_lat=30.0,
             center_lon=45.0)


def test_plot_latlon_map_wrapped_longitudes_match_reference():
    """lons wrapped to [-180, 180) but stored in 0..360 order: the image
    follows ascending longitude, as its extent claims, on both sides."""
    lats = np.linspace(-80.0, 80.0, 9)
    lons_sorted = np.arange(-180.0, 180.0, 30.0)
    f_sorted = np.sin(np.radians(lats))[:, None] * np.cos(np.radians(lons_sorted))[None, :]
    storage = np.argsort((lons_sorted + 360.0) % 360.0)
    lons_wrapped, f_wrapped = lons_sorted[storage], f_sorted[:, storage]
    _compare("plot_latlon_map", (f_wrapped, lats, lons_wrapped), (f_wrapped, lats, lons_wrapped))
    fig1 = plot.plot_latlon_map(f_sorted, lats, lons_sorted)
    fig2 = plot.plot_latlon_map(torch.from_numpy(f_wrapped), lats, lons_wrapped)
    np.testing.assert_array_equal(np.asarray(fig2.axes[0].images[0].get_array()),
                                  np.asarray(fig1.axes[0].images[0].get_array()))
    plt.close(fig1)
    plt.close(fig2)


@pytest.mark.parametrize("field,kwargs", [((20, 10), {}), ((10, 20), {"projection": "bogus"})])
def test_plot_latlon_map_errors_match_reference(field, kwargs):
    lats, lons = np.linspace(-80, 80, 10), np.linspace(0, 350, 20)
    with pytest.raises(ValueError) as ref:
        jplot.plot_latlon_map(np.zeros(field), lats, lons, **kwargs)
    with pytest.raises(ValueError) as ours:
        plot.plot_latlon_map(torch.zeros(field), lats, lons, **kwargs)
    assert str(ours.value) == str(ref.value)


def test_plot_error_curves_matches_reference():
    lead = np.arange(1, 11) * 6.0
    curves = {"model": np.linspace(1, 5, 10), "persistence": np.linspace(2, 6, 10)}
    ours = {"model": torch.from_numpy(curves["model"]), "persistence": curves["persistence"]}
    _compare("plot_error_curves", (torch.from_numpy(lead), ours), (lead, curves),
             ylabel="ACC", title="skill")


@pytest.mark.parametrize("with_val", [True, False])
def test_plot_history_matches_reference(with_val):
    from dlwp_cs_tpu.train import History as JHistory
    from dlwp_cs_tpu_torch.train import History

    epochs = [{"epoch": e, "train_loss": 1.0 / (e + 1), "val_loss": 1.2 / (e + 1) if with_val
               else None, "seconds": 1.0} for e in range(4)]
    _compare("plot_history", (History(epochs=[dict(r) for r in epochs]),),
             (JHistory(epochs=[dict(r) for r in epochs]),))


def test_plot_rank_histogram_matches_reference():
    counts = np.array([9, 4, 3, 2, 4, 10])
    _compare("plot_rank_histogram", (torch.from_numpy(counts),), (counts,), title="rank")


@pytest.mark.parametrize("members", [None, 8])
def test_plot_spread_error_matches_reference(members):
    lead = np.arange(1, 9) * 12.0
    rmse, spread = np.linspace(0.5, 2.0, 8), np.linspace(0.3, 1.5, 8)
    _compare("plot_spread_error", (lead, torch.from_numpy(rmse), torch.from_numpy(spread)),
             (lead, rmse, spread), members=members, title="spread")


def test_plotting_without_matplotlib_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot.plot_cube_faces(_cube_field())
