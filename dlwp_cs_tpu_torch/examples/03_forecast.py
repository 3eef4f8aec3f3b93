"""Example 3: autoregressive forecasts from a trained model.

The counterpart of the reference's ``examples/03_forecast.py``: the model
that ``02_train`` wrote is loaded by ``DLWPEstimator.load`` (the facade the
serving examples use), and one batched rollout runs from the last windows
of the store, each initialization with the insolation of its own init time
(``DLWPEstimator.forecast`` reduces the float64 ``t0``s modulo the
insolation period before the float32 clock).  The de-normalized fields go to
``forecast.npz`` with the lead hours, the init times and the variables.

Usage:
  python -m dlwp_cs_tpu_torch.examples.03_forecast --workdir /tmp/dlwp \\
      [--days 14] [--inits 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data import open_store
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.estimator import DLWPEstimator

__all__ = ["forecast_from_tail", "main", "save_forecast"]


def forecast_from_tail(est, store, *, days: float = 14.0, inits: int = 4) -> dict:
    """Forecast ``days`` from ``inits`` consecutive initializations at the
    tail of ``store``, leaving verifying truth after each at every lead.

    Returns ``fields`` (``(inits, leads, 6, n, n, C)`` de-normalized numpy),
    ``lead_hours``, ``init_times``, ``variables`` and ``init_indices``."""
    dcfg = est.config.data
    t_in = dcfg.input_time_steps
    calls = int(round(days * 24 / (dcfg.step_hours * dcfg.output_time_steps)))
    n_leads = calls * dcfg.output_time_steps
    last_start = store.fields.shape[0] - t_in - n_leads
    if last_start < inits - 1:
        raise SystemExit(
            f"store too short: need {t_in + n_leads + inits - 1} samples, "
            f"have {store.fields.shape[0]} — reduce --days or --inits"
        )
    starts = np.arange(inits) + (last_start - inits + 1)
    init_indices = starts + t_in - 1  # index of each window's LAST input time
    fc = est.forecast(store, init_indices=init_indices, steps=calls)
    return {
        "fields": est.denormalize(fc.fields),
        "lead_hours": fc.lead_hours.cpu().numpy(),
        "init_times": np.asarray(store.times)[init_indices],
        "variables": np.array(store.variables, dtype=object),
        "init_indices": init_indices,
    }


def save_forecast(path, result: dict) -> Path:
    """Write :func:`forecast_from_tail`'s result as the reference's
    ``forecast.npz``."""
    np.savez(path, **{k: result[k] for k in ("fields", "lead_hours", "init_times",
                                              "variables")})
    return Path(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--days", type=float, default=14.0)
    ap.add_argument("--inits", type=int, default=4)
    ap.add_argument("--device", default=None, help="rollout device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = Path(args.workdir)

    est = DLWPEstimator.load(workdir / "model", device=device)
    store = open_store(workdir / "predictors_cs.h5").load()
    result = forecast_from_tail(est, store, days=args.days, inits=args.inits)
    save_forecast(workdir / "forecast.npz", result)
    fields = result["fields"]
    print(
        f"forecast: {fields.shape} (B, leads, 6, n, n, C) to "
        f"{float(result['lead_hours'][-1]) / 24:.1f} days -> {workdir / 'forecast.npz'}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
