"""``Trainer.fit`` wall clock at the flagship configuration.

The counterpart of the reference's ``tools/trainer_wallclock.py``: what a
user gets from ``Trainer.fit`` at the flagship configuration (C48,
(32, 64, 128), batch 16, bf16) on device-resident synthetic batches, so
that the input pipeline adds nothing and what is left beyond the step is
the trainer's own (launches, metric copies, bookkeeping).  It prints ms a
step for each epoch (the host clock around ``fit``, ending in
``torch.cuda.synchronize()``), the steady state from epoch 2 on (the first
plans and builds the kernels) and the mean ``dispatch_s`` / ``data_wait_s``
of the trainer's step records.  On the CPU no time is printed.

``--fused`` is accepted and changes nothing (``train/trainer.py``: eager
torch has no fused dispatch).  ``--store`` feeds the real pipeline
instead: an HDF5 predictor store at ``--store-dir`` (written on first use;
it needs ``h5py``, and without it ``data/store.py::import_h5py`` raises an
``ImportError`` naming it) -> ``SeriesDataset`` (shuffled windows, host-side
normalization and insolation, ``--workers`` threads) ->
``prefetch_to_device`` (depth 2) -> ``Trainer.fit``; :func:`store_pipeline`
takes any store, a ``MemoryStore`` too.

    python -m dlwp_cs_tpu_torch.tools.trainer_wallclock [--steps 128] [--store]
    python -m dlwp_cs_tpu_torch.tools.trainer_wallclock --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, TrainConfig, UNetConfig
from dlwp_cs_tpu_torch.tools.timing import add_device_args, card, tool_device
from dlwp_cs_tpu_torch.train import Trainer

__all__ = ["main", "store_pipeline", "synthetic_store", "wallclock"]

N, FILTERS, BATCH = 48, (32, 64, 128), 16
SMALL = (8, (4, 8), 2)  # --small: n, filters, batch


def synthetic_store(n, t_total, seed=7):
    """A ``MemoryStore`` of ``t_total`` seeded samples at C``n`` with
    ``DataConfig``'s variables and constants, 6-hourly."""
    from dlwp_cs_tpu_torch.data.store import MemoryStore

    dcfg = DataConfig(grid_n=n)
    rng = np.random.default_rng(seed)
    return MemoryStore.from_raw(
        rng.normal(size=(t_total, 6, n, n, dcfg.n_variables)).astype(np.float32),
        np.arange(t_total) * (dcfg.step_hours / 24.0),
        dcfg.variables,
        constants=rng.normal(size=(6, n, n, len(dcfg.constants))).astype(np.float32),
        constant_names=dcfg.constants,
    )


def store_pipeline(store, *, steps, batch, workers, device, log=print):
    """``(epoch_data, steps_per_epoch)``: ``store`` -> ``SeriesDataset``
    (shuffled windows of ``batch``, ``workers`` threads) ->
    ``prefetch_to_device`` (depth 2, onto ``device``), at most ``steps``
    batches an epoch."""
    from dlwp_cs_tpu_torch.data import SeriesDataset, prefetch_to_device
    from dlwp_cs_tpu_torch.geometry import CubedSphere

    n = store.grid_n
    dcfg = DataConfig(grid_n=n)
    lat, lon = CubedSphere(n).cell_latlon
    ds = SeriesDataset(store, dcfg, lat=lat, lon=lon, batch_size=batch, shuffle=True,
                       workers=workers)
    steps = min(len(ds), steps)

    def epoch_data():
        def limited():
            for i, item in enumerate(iter(ds)):
                if i >= steps:
                    return
                yield item

        return prefetch_to_device(limited(), device=device)

    log(f"[store] {type(store).__name__} -> SeriesDataset ({ds.n_samples} windows) "
        f"-> prefetch(depth=2), {steps} steps/epoch")
    return epoch_data, steps


def _h5_store(store_dir, n, t_total):
    """The HDF5 store at ``store_dir`` (written when missing or short),
    opened lazily; raises ``ImportError`` without h5py."""
    from dlwp_cs_tpu_torch.data import open_store
    from dlwp_cs_tpu_torch.data.store import import_h5py, write_store

    h5py = import_h5py("the --store pipeline's HDF5 store")
    path = Path(store_dir) / f"predictors_cs{n}.h5"
    short = True
    if path.exists():
        with h5py.File(path, "r") as f:
            short = f["fields"].shape[0] < t_total
    if short:
        print(f"[store] writing {path} ({t_total} samples)...", flush=True)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_store(path, synthetic_store(n, t_total))
    return open_store(path)


def wallclock(*, steps, epochs, fused=8, metrics_every=None, store=None, workers=6,
              device, small=False):
    """Run ``Trainer.fit`` ``epochs`` times one epoch each; returns the
    numbers the tool prints: ``per_step_ms`` (one per epoch), ``steady_ms``
    (the fastest from epoch 2 on), the mean ``dispatch_ms`` and
    ``data_wait_ms`` of the last epoch's step records, ``steps`` an epoch
    and the losses; times ``None`` on the CPU.  ``store``: a predictor store
    fed through :func:`store_pipeline` (else device-resident synthetic
    batches)."""
    n, filters, batch = SMALL if small else (N, FILTERS, BATCH)
    dcfg = DataConfig(grid_n=n)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, 6, n, n, dcfg.input_channels))
                         .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(batch, 6, n, n, dcfg.output_channels))
                         .astype(np.float32)).to(device)
    model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels, filters=filters,
                                      compute_dtype="bfloat16"),
                           dcfg.input_channels, device=device)
    me = metrics_every or max(1, steps // fused)
    tcfg = TrainConfig(learning_rate=1e-3, max_epochs=epochs, fused_steps=fused,
                       metrics_every=me, restore_best_weights=False,
                       early_stopping_patience=10**6)
    trainer = Trainer(model, tcfg)
    state = trainer.init(x)
    if store is not None:
        epoch_data, steps = store_pipeline(store, steps=steps, batch=batch, workers=workers,
                                           device=device)
    else:
        def epoch_data():
            return ((x, y) for _ in range(steps))

    cuda = device.type == "cuda"
    times = []
    for ep in range(epochs):
        t0 = time.perf_counter()
        state = trainer.fit(state, epoch_data, verbose=False, epochs=ep + 1)
        if cuda:
            torch.cuda.synchronize(device)
        trainer._epochs_done = ep + 1
        times.append(time.perf_counter() - t0)
    recs = trainer.history.steps[-steps:]
    per_step = [t / steps * 1e3 for t in times] if cuda else [None] * epochs
    steady = (min(per_step[1:]) if len(per_step) > 1 else per_step[0]) if cuda else None
    mean_ms = (lambda key: sum(r[key] for r in recs) / max(len(recs), 1) * 1e3
               if cuda else None)
    return {"fused": fused, "steps": steps, "epochs": epochs, "per_step_ms": per_step,
            "steady_ms": steady, "dispatch_ms": mean_ms("dispatch_s"),
            "data_wait_ms": mean_ms("data_wait_s"), "store": store is not None,
            "losses": [r["loss"] for r in recs]}


def main(argv=None, rows=None) -> int:
    """The command line; ``rows``, a list, receives the result (for a
    caller that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused", type=int, default=8)
    ap.add_argument("--steps", type=int, default=128, help="steps per epoch")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--metrics-every", type=int, default=None,
                    help="flush cadence in steps (default: --steps / --fused)")
    ap.add_argument("--store", action="store_true",
                    help="feed the HDF5 -> SeriesDataset -> prefetch_to_device pipeline "
                    "instead of device-resident synthetic batches (needs h5py)")
    ap.add_argument("--store-dir", default=None,
                    help="where the synthetic predictor store lives (written on first "
                    "use; default: a temporary directory)")
    ap.add_argument("--workers", type=int, default=6,
                    help="batch-assembly threads for --store (0 = serial)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    name = card(device)
    n, _, batch = SMALL if args.small else (N, FILTERS, BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        store = None
        if args.store:
            store = _h5_store(args.store_dir or tmp, n, args.steps * batch + 8)
        r = wallclock(steps=args.steps, epochs=args.epochs, fused=args.fused,
                      metrics_every=args.metrics_every, store=store, workers=args.workers,
                      device=device, small=args.small)
        if store is not None:
            store.close()
    r["card"] = name
    print(f"platform={device.type} fused={args.fused} steps/epoch={r['steps']} [{name}]")
    for i, ms in enumerate(r["per_step_ms"]):
        print(f"epoch {i}: " + ("(no time on the CPU)" if ms is None
                                else f"{ms:7.2f} ms/step [{name}]"))
    if r["steady_ms"] is None:
        print("steady-state: (no time on the CPU)")
    else:
        print(f"steady-state: {r['steady_ms']:.2f} ms/step  (mean dispatch "
              f"{r['dispatch_ms']:.2f} ms, data wait {r['data_wait_ms']:.3f} ms per record) "
              f"[{name}]")
    print(json.dumps({k: v for k, v in r.items() if k != "losses"}))
    if rows is not None:
        rows.append(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
