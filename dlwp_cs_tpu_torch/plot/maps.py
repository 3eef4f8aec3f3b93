"""Plotting helpers: cubed-sphere face maps, lat-lon maps and skill curves.

The counterpart of ``dlwp_cs_tpu.plot.maps``: the same six functions with
the same arguments, errors and figures.  Face fields are drawn as an
unfolded cross layout; lat-lon maps in five projections without basemap or
cartopy (a cubed-sphere field gets there through the inverse remap,
:mod:`dlwp_cs_tpu_torch.remap`).  Fields, axes and curves may be numpy
arrays or tensors; a tensor is detached and copied to the host.

matplotlib (Agg) is imported when a function is called, not with this
module; where it is missing the functions raise an ``ImportError`` that
names it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "plot_cube_faces",
    "plot_error_curves",
    "plot_history",
    "plot_latlon_map",
    "plot_rank_histogram",
    "plot_spread_error",
]

# Cross layout: (row, col) panel of each face in a 3x4 grid.
#         [4]
#  [3][0][1][2]
#         [5]
_CROSS = {0: (1, 1), 1: (1, 2), 2: (1, 3), 3: (1, 0), 4: (0, 1), 5: (2, 1)}


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib, which is not installed here"
        ) from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(a, dtype=None):
    """``a`` (an array, a tensor or a sequence) as a numpy array; a tensor
    is detached and copied to the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def plot_cube_faces(field, *, title: str | None = None, cmap: str = "RdBu_r",
                    vmin=None, vmax=None, out_path=None):
    """Draw a ``(6, n, n)`` field as an unfolded cube cross; returns Figure."""
    plt = _mpl()
    f = _host(field)
    if f.ndim != 3 or f.shape[0] != 6:
        raise ValueError(f"expected (6, n, n), got {f.shape}")
    # nan-robust like plot_latlon_map: one NaN cell (a diverged rollout)
    # must not blank every panel via vmin=vmax=NaN
    vmin = np.nanmin(f) if vmin is None else vmin
    vmax = np.nanmax(f) if vmax is None else vmax
    fig, axes = plt.subplots(3, 4, figsize=(10, 7.5))
    for ax in axes.ravel():
        ax.set_axis_off()
    for face, (r, c) in _CROSS.items():
        ax = axes[r][c]
        im = ax.imshow(f[face], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(f"face {face}", fontsize=8)
        ax.set_axis_on()
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes, shrink=0.6)
    if title:
        fig.suptitle(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_latlon_map(field, lats, lons, *, projection: str = "equirectangular",
                    center_lat: float = 40.0, center_lon: float = 0.0,
                    title: str | None = None, cmap: str = "RdBu_r",
                    vmin=None, vmax=None, out_path=None):
    """Projected map of a ``(nlat, nlon)`` lat-lon field; returns Figure.

    Map-projection parity with the reference's basemap/cartopy plots
    (``DLWP/plot/`` — SURVEY.md §2 row 18) without either dependency:

    * ``'equirectangular'`` — plate carrée via ``imshow``;
    * ``'mollweide'`` / ``'hammer'`` / ``'aitoff'`` — matplotlib's built-in
      geographic axes (equal-area / compromise global projections);
    * ``'orthographic'`` — the globe-from-space view, computed closed-form
      (x = cos φ sin Δλ, y = cos φ₀ sin φ − sin φ₀ cos φ cos Δλ, hemisphere
      mask cos c > 0) and centered on ``(center_lat, center_lon)``.

    ``lats``/``lons`` are 1-D degree axes matching ``field``; cubed-sphere
    fields get here through the inverse remap (:mod:`dlwp_cs_tpu_torch.remap`).
    Coastlines need offline geometry data neither matplotlib nor this
    environment ships; the grid graticule is drawn instead.
    """
    plt = _mpl()
    f = _host(field, dtype=np.float64)
    lats = _host(lats, dtype=np.float64)
    lons = _host(lons, dtype=np.float64)
    if f.shape != (lats.size, lons.size):
        raise ValueError(
            f"field {f.shape} does not match (nlat={lats.size}, nlon={lons.size})"
        )
    vmin = np.nanmin(f) if vmin is None else vmin
    vmax = np.nanmax(f) if vmax is None else vmax
    if projection == "equirectangular":
        fig, ax = plt.subplots(figsize=(9, 4.5))
        # sort BOTH axes into ascending order: imshow's extent claims
        # ascending coordinates, so wrapped-to-[-180,180) lons still in
        # 0..360 storage order would render hemispheres swapped
        order = np.argsort(lats)
        order_lo = np.argsort(lons)
        im = ax.imshow(
            f[order][:, order_lo], origin="lower", cmap=cmap,
            vmin=vmin, vmax=vmax,
            extent=[lons.min(), lons.max(), lats.min(), lats.max()],
            aspect="auto",
        )
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        fig.colorbar(im, ax=ax, shrink=0.8)
    elif projection in ("mollweide", "hammer", "aitoff"):
        # matplotlib geo axes want radians, lon in [-pi, pi)
        lon_w = (lons + 180.0) % 360.0 - 180.0
        order_lo = np.argsort(lon_w)
        order_la = np.argsort(lats)
        fw = f[order_la][:, order_lo]
        lon_r = np.radians(lon_w[order_lo])
        lat_r = np.radians(lats[order_la])
        fig = plt.figure(figsize=(9, 5))
        ax = fig.add_subplot(111, projection=projection)
        im = ax.pcolormesh(
            lon_r, lat_r, fw, cmap=cmap, vmin=vmin, vmax=vmax, shading="auto"
        )
        ax.grid(True, alpha=0.3)
        fig.colorbar(im, ax=ax, shrink=0.7)
    elif projection == "orthographic":
        lam = np.radians(lons)[None, :]
        phi = np.radians(lats)[:, None]
        lam0 = np.radians(center_lon)
        phi0 = np.radians(center_lat)
        cosc = (
            np.sin(phi0) * np.sin(phi)
            + np.cos(phi0) * np.cos(phi) * np.cos(lam - lam0)
        )
        x = np.cos(phi) * np.sin(lam - lam0)
        y = (
            np.cos(phi0) * np.sin(phi)
            - np.sin(phi0) * np.cos(phi) * np.cos(lam - lam0)
        )
        x, y = np.broadcast_to(x, f.shape), np.broadcast_to(y, f.shape)
        vis = cosc > 0.0
        fig, ax = plt.subplots(figsize=(6.5, 6.5))
        im = ax.scatter(
            x[vis], y[vis], c=f[vis], s=4, cmap=cmap, vmin=vmin, vmax=vmax,
            linewidths=0,
        )
        ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, lw=0.8))
        ax.set_xlim(-1.05, 1.05)
        ax.set_ylim(-1.05, 1.05)
        ax.set_aspect("equal")
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, shrink=0.7)
    else:
        raise ValueError(
            "projection must be 'equirectangular', 'mollweide', 'hammer', "
            f"'aitoff' or 'orthographic', got {projection!r}"
        )
    if title:
        fig.suptitle(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_error_curves(lead_hours, curves: dict, *, ylabel: str = "RMSE",
                      title: str | None = None, out_path=None):
    """Error-vs-lead-time plot; ``curves`` maps label -> (L,) array."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, values in curves.items():
        ax.plot(_host(lead_hours) / 24.0, _host(values), label=label)
    ax.set_xlabel("lead time (days)")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_history(history, *, out_path=None):
    """Training-history curves from a ``train.History`` (epoch records)."""
    plt = _mpl()
    epochs = [r["epoch"] for r in history.epochs]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(epochs, [r["train_loss"] for r in history.epochs], label="train")
    if any(r.get("val_loss") is not None for r in history.epochs):
        ax.plot(epochs, [r.get("val_loss") for r in history.epochs], label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_rank_histogram(counts, *, title: str | None = None, out_path=None):
    """Verification-rank (Talagrand) histogram from
    :func:`dlwp_cs_tpu_torch.verify.rank_histogram` counts.  A reliable ensemble
    is flat (dashed line); U shape = under-dispersive."""
    plt = _mpl()
    counts = _host(counts, np.float64)
    fig, ax = plt.subplots(figsize=(6, 4))
    ranks = np.arange(counts.shape[0])
    ax.bar(ranks, counts, color="#4878cf", edgecolor="none")
    ax.axhline(counts.sum() / counts.shape[0], ls="--", c="k", lw=1,
               label="flat (reliable)")
    ax.set_xlabel("rank of truth within ensemble")
    ax.set_ylabel("count")
    ax.legend()
    if title:
        ax.set_title(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


def plot_spread_error(lead_hours, rmse, spread, *, members: int | None = None,
                      title: str | None = None, out_path=None):
    """Spread-skill diagnostic from :func:`dlwp_cs_tpu_torch.verify.spread_error`:
    RMSE of the ensemble mean vs (scaled) mean spread per lead time.  With
    ``members`` given, the spread is scaled by sqrt((M+1)/M) so a reliable
    ensemble's curves coincide."""
    plt = _mpl()
    lead_days = _host(lead_hours) / 24.0
    spread = _host(spread, np.float64)
    label = "spread"
    if members is not None:
        spread = spread * np.sqrt((members + 1) / members)
        label = "spread * sqrt((M+1)/M)"
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(lead_days, _host(rmse), label="RMSE(ens mean)")
    ax.plot(lead_days, spread, ls="--", label=label)
    ax.set_xlabel("lead time (days)")
    ax.set_ylabel("error / spread")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig
