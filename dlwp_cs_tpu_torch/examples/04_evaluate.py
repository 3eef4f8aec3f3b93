"""Example 4: verification of saved forecasts.

The counterpart of the reference's ``examples/04_evaluate.py``: the truth
aligned with ``forecast.npz``'s (initialization, lead) structure, per-lead
RMSE and ACC per channel with the cells' area weights, beside the
persistence and climatology baselines; the error curves and a face map of
the last lead drawn to PNGs (matplotlib), and the table printed.  The
scores are float64 numpy on the host, as the reference's, so this example
alone takes no ``--device``: it keeps the reference's arguments and runs on
any machine.

Usage:
  python -m dlwp_cs_tpu_torch.examples.04_evaluate --workdir /tmp/dlwp \\
      [--variable z500]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data import open_store
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.plot import plot_cube_faces, plot_error_curves
from dlwp_cs_tpu_torch.verify import (
    acc_curve,
    align_truth,
    climo_error,
    forecast_error,
    persistence_error,
)

__all__ = ["format_table", "main", "plot_scores", "score"]


def score(fields, lead_hours, init_times, store) -> dict:
    """Scores of forecast ``fields`` ``(B, L, 6, n, n, C)`` (physical units)
    against ``store``'s truth, every curve per channel ``(L', C)`` over the
    leads that have truth: ``rmse`` (the model), ``persistence``,
    ``climatology`` (the store's time mean) and ``acc``; with the kept
    ``lead_hours`` and ``fields``."""
    aligned = align_truth(store, init_times, lead_hours)
    truth = aligned["truth"]
    fields = np.asarray(fields)[:, aligned["kept"]]
    climo = np.asarray(store.fields).mean(axis=0)
    w = CubedSphere(store.grid_n).area_weights
    # all curves PER CHANNEL: an all-channel mix is dominated by whichever
    # variable has the largest physical scale
    return {
        "lead_hours": aligned["lead_hours"],
        "fields": fields,
        "rmse": forecast_error(fields, truth, "rmse", weights=w, keep_channels=True),
        "persistence": persistence_error(aligned["init_fields"], truth, weights=w,
                                         keep_channels=True),
        "climatology": climo_error(climo, truth, weights=w, keep_channels=True),
        "acc": acc_curve(fields, truth, climo, weights=w, keep_channels=True),
    }


def plot_scores(scores: dict, variables, vi: int, workdir) -> None:
    """The reference's two figures: ``rmse_curves.png`` and
    ``forecast_map.png`` (the first initialization's last lead) of
    variable ``vi``; raises matplotlib's ``ImportError`` where it is
    missing."""
    workdir = Path(workdir)
    lead_hours = scores["lead_hours"]
    curves = {
        f"model ({variables[vi]})": scores["rmse"][:, vi],
        "persistence": scores["persistence"][:, vi],
        "climatology": scores["climatology"][:, vi],
    }
    plot_error_curves(lead_hours, curves, title="RMSE vs lead time",
                      out_path=workdir / "rmse_curves.png")
    plot_cube_faces(
        scores["fields"][0, -1, ..., vi],
        title=f"{variables[vi]} forecast, +{lead_hours[-1] / 24:.1f} d",
        out_path=workdir / "forecast_map.png",
    )


def format_table(scores: dict, vi: int) -> str:
    """The reference's printed table of variable ``vi``."""
    lines = ["lead(h)  RMSE(model)  RMSE(pers)  RMSE(climo)  ACC"]
    for li, lead in enumerate(scores["lead_hours"]):
        lines.append(
            f"{lead:7.0f}  {scores['rmse'][li, vi]:11.4f}  "
            f"{scores['persistence'][li, vi]:10.4f}  "
            f"{scores['climatology'][li, vi]:11.4f}  {scores['acc'][li, vi]:5.3f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--variable", default=None, help="variable to plot (default: first)")
    args = ap.parse_args(argv)
    workdir = Path(args.workdir)

    fz = np.load(workdir / "forecast.npz", allow_pickle=True)
    variables = list(fz["variables"])
    store = open_store(workdir / "predictors_cs.h5").load()
    scores = score(fz["fields"], fz["lead_hours"], fz["init_times"], store)
    vi = variables.index(args.variable) if args.variable else 0
    plot_scores(scores, variables, vi, workdir)
    print(format_table(scores, vi))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
