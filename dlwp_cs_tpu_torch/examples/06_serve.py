"""Example 6: production forecast serving.

The counterpart of the reference's ``examples/06_serve.py``: the model that
``02_train`` wrote, behind ``ForecastService`` (micro-batched rollouts) and
the HTTP front end (npz request and response, ``serve/http.py``).

Usage:
  python -m dlwp_cs_tpu_torch.examples.06_serve --workdir /tmp/dlwp --port 8800
      (blocks; POST npz {window, t0_days, steps} to /forecast)
  python -m dlwp_cs_tpu_torch.examples.06_serve --workdir /tmp/dlwp --selftest
      (starts the server on an ephemeral port, sends concurrent client
       requests from the store's last windows, prints a summary, exits)
  python -m dlwp_cs_tpu_torch.examples.06_serve --workdir /tmp/dlwp --artifact
      (serves the artifact written by 07_ensemble_export, rollout_artifact/,
       with NO model objects in the process; steps is fixed by the artifact)

``--device`` names the device (default: the GPU).
"""

from __future__ import annotations

import argparse
import threading
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data import open_store
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.serve import (
    ExportedForecastService,
    ForecastHTTPServer,
    ForecastService,
    forecast_request,
)

__all__ = ["artifact_service", "live_service", "main", "selftest"]


def live_service(est, store) -> ForecastService:
    """The estimator behind a ``ForecastService`` with the store's constant
    channels, coalescing requests up to 50 ms."""
    return ForecastService(est, constants_store=store, max_wait_ms=50.0)


def artifact_service(path, *, device=None) -> ExportedForecastService:
    """An artifact-only deployment: no store or model objects."""
    return ExportedForecastService(path, max_wait_ms=50.0, device=device)


def selftest(svc, store, *, steps: int, log=print) -> dict:
    """Serve ``svc`` on an ephemeral port and send three concurrent
    ``forecast_request`` calls from the store's last three windows.
    Returns ``results`` (store index -> ``(fields, lead_hours,
    init_times)``), ``windows`` and ``t0`` per index, the service's
    ``stats`` and ``ok`` (every answer there and finite)."""
    t_in = svc.info()["input_time_steps"]
    srv = ForecastHTTPServer(svc, host="127.0.0.1", port=0).start()
    log(f"[serve] selftest on port {srv.port}")
    idx = [len(store.times) - 3, len(store.times) - 2, len(store.times) - 1]
    windows = {i: np.asarray(store.fields[i - t_in + 1 : i + 1]) for i in idx}
    t0 = {i: float(store.times[i]) for i in idx}
    results: dict[int, tuple] = {}

    def call(i):
        results[i] = forecast_request("127.0.0.1", srv.port, windows[i], t0[i], steps)

    threads = [threading.Thread(target=call, args=(i,)) for i in idx]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        st = svc.stats
        srv.stop()
    ok = True
    for i in idx:
        if i not in results:
            log(f"[serve] request {i}: MISSING")
            ok = False
            continue
        fields, lead, _ = results[i]
        finite = bool(np.isfinite(fields).all())
        ok &= finite
        log(
            f"[serve] init t={t0[i]:.2f}d -> fields {fields.shape}, "
            f"lead {lead[0]:.0f}..{lead[-1]:.0f} h, finite={finite}"
        )
    log(
        f"[serve] stats: requests={st.requests} batches={st.batches} "
        f"mean_batch={st.mean_batch:.2f} dispatch_s={st.dispatch_seconds:.2f}"
    )
    log("selftest ok" if ok else "selftest FAILED")
    return {"results": results, "windows": windows, "t0": t0, "stats": st, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--artifact", action="store_true",
                    help="serve the exported artifact (07_ensemble_export) instead of "
                         "the live estimator; steps is fixed by the artifact")
    ap.add_argument("--device", default=None, help="serving device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = Path(args.workdir)

    store = None
    if args.artifact:
        svc = artifact_service(workdir / "rollout_artifact", device=device)
        args.steps = svc.steps
    else:
        store = open_store(workdir / "predictors_cs.h5")
        svc = live_service(DLWPEstimator.load(workdir / "model", device=device), store)

    ok = True
    try:
        if not args.selftest:
            from dlwp_cs_tpu_torch.serve import serve_forever

            serve_forever(svc, host=args.host, port=args.port)
        else:
            if store is None:
                store = open_store(workdir / "predictors_cs.h5")  # windows only
            ok = selftest(svc, store, steps=args.steps)["ok"]
    finally:
        svc.close()
        if store is not None:
            store.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
