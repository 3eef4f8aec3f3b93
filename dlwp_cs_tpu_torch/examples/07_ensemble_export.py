"""Example 7: ensemble forecasting and export.

The counterpart of the reference's ``examples/07_ensemble_export.py``:

1. a perturbed-IC ensemble forecast as ONE rollout (members folded into
   the batch), scored with CRPS and spread-error against the held-out truth
   in the predictor store; the perturbations come from a CPU
   ``torch.Generator`` seeded with ``--seed`` (the reference draws them from
   ``PRNGKey(seed)``);
2. the export round trip: ``rollout_artifact/``, a directory of
   ``torch.export`` programs of one model call (``serve/export.py``; the
   reference writes StableHLO of the whole rollout), reloaded with no model
   code and held against the live service (``< 1e-4`` raw units; on the GPU
   the artifact replays one CUDA graph a forecast, bitwise equal to the
   live forecast).

Usage:
  python -m dlwp_cs_tpu_torch.examples.07_ensemble_export --workdir /tmp/dlwp \\
      [--members 8] [--steps 8] [--amplitude 0.05] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.data import open_store
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.serve import ExportedForecaster, ForecastService, export_forecaster
from dlwp_cs_tpu_torch.verify import crps_ensemble, spread_error

__all__ = ["ensemble_scores", "export_round_trip", "last_window", "main"]


def last_window(store, *, input_time_steps: int, n_lead: int):
    """``(i0, window, t0)``: the last store index that leaves ``n_lead``
    verifying times after it, its raw input window and its init time."""
    i0 = len(store.times) - 1 - n_lead
    if i0 < input_time_steps - 1:
        raise SystemExit("store too short for the requested steps")
    window = np.asarray(store.fields[i0 - input_time_steps + 1 : i0 + 1])
    return i0, window, float(store.times[i0])


def ensemble_scores(svc, store, *, steps: int, members: int = 8, amplitude: float = 0.05,
                    seed: int = 0, perturbations=None, device=None, log=print) -> dict:
    """A ``members``-member ensemble from the store's last verifiable
    window, scored against the store: ``crps``, ``rmse`` (of the mean) and
    ``spread`` per lead, with the ``ensemble`` itself and the ``window``,
    ``t0`` it ran from.  ``perturbations``: the unit perturbations, else drawn
    from ``torch.Generator().manual_seed(seed)``."""
    dcfg = svc.config.data
    n_lead = steps * dcfg.output_time_steps
    i0, window, t0 = last_window(store, input_time_steps=dcfg.input_time_steps, n_lead=n_lead)
    ens = svc.forecast_ensemble(
        window, t0, steps=steps, members=members, amplitude=amplitude,
        generator=torch.Generator().manual_seed(int(seed)), keep_members=True,
        perturbations=perturbations,
    )
    truth = np.asarray(store.fields[i0 + 1 : i0 + 1 + n_lead])[None]  # (B=1, L, 6, n, n, C)
    crps = crps_ensemble(ens.members, truth, device=device).mean(dim=(0, 2, 3, 4, 5))
    crps = crps.cpu().numpy()
    rmse, spread = (v.cpu().numpy() for v in spread_error(ens.members, truth, device=device))
    log(f"[ensemble] {members} members, amplitude {amplitude}")
    for li in range(0, n_lead, max(1, n_lead // 4)):
        log(
            f"[ensemble] lead {float(ens.lead_hours[li]):5.0f} h: "
            f"crps={crps[li]:.4f} rmse(mean)={rmse[li]:.4f} "
            f"spread={spread[li]:.4f}"
        )
    return {"crps": crps, "rmse": rmse, "spread": spread, "lead_hours": ens.lead_hours,
            "ensemble": ens, "window": window, "t0": t0}


def export_round_trip(est, svc, store, artifact, *, steps: int, window, t0: float,
                      log=print) -> dict:
    """Export ``est``'s rollout of ``steps`` calls at batch 1 to
    ``artifact``, reload it with no model code and forecast ``window`` both
    ways: ``maxdiff`` (raw units), ``size_kib``, ``exported`` and ``live``."""
    artifact = Path(artifact)
    export_forecaster(est, artifact, steps=steps, batch_sizes=(1,), constants_store=store)
    exp = ExportedForecaster.load(artifact, device=est.device)
    live = svc.forecast(window, t0, steps=steps)
    aot = exp.forecast(window, t0)
    diff = float(np.max(np.abs(aot.fields - live.fields)))
    size_kib = sum(f.stat().st_size for f in artifact.iterdir()) / 1024.0
    log(f"[export] artifact {artifact.name}: {size_kib:.0f} KiB, "
        f"exported vs live maxdiff {diff:.2e}")
    return {"maxdiff": diff, "size_kib": size_kib, "exported": aot, "live": live}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--amplitude", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="forecast device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = Path(args.workdir)

    store = open_store(workdir / "predictors_cs.h5")
    est = DLWPEstimator.load(workdir / "model", device=device)
    svc = ForecastService(est, constants_store=store)
    try:
        scores = ensemble_scores(svc, store, steps=args.steps, members=args.members,
                                 amplitude=args.amplitude, seed=args.seed, device=device)
        trip = export_round_trip(est, svc, store, workdir / "rollout_artifact",
                                 steps=args.steps, window=scores["window"], t0=scores["t0"])
    finally:
        svc.close()
    ok = bool(np.isfinite(scores["ensemble"].mean).all()) and trip["maxdiff"] < 1e-4
    print("ensemble+export ok" if ok else "ensemble+export FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
