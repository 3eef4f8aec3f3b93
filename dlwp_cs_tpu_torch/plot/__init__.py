"""Plotting helpers (matplotlib, imported when a function is called)."""

from dlwp_cs_tpu_torch.plot.maps import (
    plot_cube_faces,
    plot_error_curves,
    plot_history,
    plot_latlon_map,
    plot_rank_histogram,
    plot_spread_error,
)

__all__ = [
    "plot_cube_faces",
    "plot_error_curves",
    "plot_history",
    "plot_latlon_map",
    "plot_rank_histogram",
    "plot_spread_error",
]
