"""Example 2: train the cubed-sphere U-Net (or the ConvLSTM) on a predictor
store.

The counterpart of the reference's ``examples/02_train.py``: a
chronological train/validation split, series windowing with insolation and
constants (``SeriesDataset``, batches assembled by ``--workers`` threads),
host->device prefetch, the ``Trainer`` (Adam on MSE over the 2-step output
window, early stopping with a minimum-epoch floor, periodic checkpoints,
best-weights restore), then ``model/`` written as the reference writes it:
the state (``model/step_<N>/``, the port's ``torch.save`` layout),
``experiment.json`` and ``stats.json``, which ``DLWPEstimator.load``
reads.

Usage:
  python -m dlwp_cs_tpu_torch.examples.02_train --workdir /tmp/dlwp \\
      [--epochs 10] [--batch 16] [--filters 32 64 128] [--bf16] \\
      [--model unet|convlstm] [--device cpu]
      (expects 01_build_dataset to have run)
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from dlwp_cs_tpu_torch.data import SeriesDataset, open_store, prefetch_to_device
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.models import (
    ConvLSTMConfig,
    DataConfig,
    ExperimentConfig,
    TrainConfig,
    UNetConfig,
    build_model,
)
from dlwp_cs_tpu_torch.train import Trainer
from dlwp_cs_tpu_torch.utils import save_checkpoint, save_json

__all__ = ["chronological_split", "experiment_config", "main", "save_model", "train"]


def chronological_split(store, val_frac: float):
    """``(train_store, val_store)``: the first ``1 - val_frac`` of the
    store's times and the rest (the reference's year-split analog)."""
    t_total = store.fields.shape[0]
    split = int(t_total * (1 - val_frac))
    return (dataclasses.replace(store, fields=store.fields[:split], times=store.times[:split]),
            dataclasses.replace(store, fields=store.fields[split:], times=store.times[split:]))


def experiment_config(store, *, model: str = "unet", filters=(32, 64, 128), batch: int = 16,
                      lr: float = 1e-3, bf16: bool = False, epochs: int = 10,
                      min_epochs: int = 2, patience: int = 5) -> ExperimentConfig:
    """The reference script's configuration for ``store``'s grid, variables
    and constants."""
    dcfg = DataConfig(grid_n=store.grid_n, variables=store.variables,
                      constants=store.constant_names)
    compute_dtype = "bfloat16" if bf16 else "float32"
    if model == "convlstm":
        mcfg = ConvLSTMConfig(
            output_channels=dcfg.output_channels,
            filters=tuple(filters),
            input_time_steps=dcfg.input_time_steps,
            variable_channels=dcfg.n_variables,
            add_insolation=dcfg.add_insolation,
            compute_dtype=compute_dtype,
        )
    elif model == "unet":
        mcfg = UNetConfig(output_channels=dcfg.output_channels, filters=tuple(filters),
                          compute_dtype=compute_dtype)
    else:
        raise ValueError(f"model must be unet|convlstm, got {model!r}")
    tcfg = TrainConfig(
        batch_size=batch,
        learning_rate=lr,
        max_epochs=epochs,
        min_epochs=min_epochs,
        early_stopping_patience=patience,
        checkpoint_every_epochs=max(1, epochs // 5),
    )
    return ExperimentConfig(data=dcfg, model=mcfg, train=tcfg)


def train(store, cfg: ExperimentConfig, *, workdir=None, val_frac: float = 0.15,
          workers: int = 2, device=None, verbose: bool = True):
    """Train ``cfg``'s model on ``store`` (a ``MemoryStore``) on ``device``
    (``None``: the GPU); ``workdir`` receives ``metrics.jsonl`` and the
    periodic checkpoints.  Returns ``(trainer, state, stats)``: ``stats``
    is what ``stats.json`` holds."""
    dev = resolve_device(device)
    dcfg, tcfg = cfg.data, cfg.train
    lat, lon = CubedSphere(dcfg.grid_n).cell_latlon
    train_store, val_store = chronological_split(store, val_frac)
    common = dict(lat=lat, lon=lon, batch_size=tcfg.batch_size)
    train_ds = SeriesDataset(train_store, dcfg, shuffle=True, workers=workers, **common)
    val_ds = SeriesDataset(val_store, dcfg, **common)
    model = build_model(cfg.model, dcfg.input_channels, device=dev,
                        generator=torch.Generator().manual_seed(tcfg.seed))
    trainer = Trainer(model, tcfg, workdir=workdir)
    x0, _ = train_ds.make_batch(train_ds._starts[: tcfg.batch_size])
    try:
        state = trainer.init(x0)
        state = trainer.fit(
            state,
            lambda: prefetch_to_device(iter(train_ds), device=dev),
            val_data=lambda: prefetch_to_device(iter(val_ds), device=dev),
            verbose=verbose,
        )
    finally:
        trainer.close()
    stats = {
        "mean": [float(v) for v in store.mean],
        "std": [float(v) for v in store.std],
        "insol_mean": train_ds.insol_mean,
        "insol_std": train_ds.insol_std,
    }
    return trainer, state, stats


def save_model(path, state, cfg: ExperimentConfig, stats: dict) -> Path:
    """Write ``state``, ``experiment.json`` and ``stats.json`` under
    ``path``, the directory ``DLWPEstimator.load`` reads."""
    path = Path(path)
    save_checkpoint(path, state, step=int(state.step))
    save_json(path / "experiment.json", cfg.to_json())
    save_json(path / "stats.json", stats)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--filters", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument(
        "--model", choices=("unet", "convlstm"), default="unet",
        help="model family: cubed-sphere U-Net (default) or the recurrent "
        "ConvLSTM stack (the reference's is_recurrent path)",
    )
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--val-frac", type=float, default=0.15)
    ap.add_argument("--min-epochs", type=int, default=2)
    ap.add_argument("--patience", type=int, default=5)
    ap.add_argument("--workers", type=int, default=2,
                    help="batch-assembly threads (0 = serial)")
    ap.add_argument("--device", default=None, help="training device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = Path(args.workdir)

    store = open_store(workdir / "predictors_cs.h5").load()
    cfg = experiment_config(store, model=args.model, filters=args.filters, batch=args.batch,
                            lr=args.lr, bf16=args.bf16, epochs=args.epochs,
                            min_epochs=args.min_epochs, patience=args.patience)
    trainer, state, stats = train(store, cfg, workdir=workdir, val_frac=args.val_frac,
                                  workers=args.workers, device=device)
    save_model(workdir / "model", state, cfg, stats)
    print(f"saved model to {workdir / 'model'}; best loss in history:")
    print(min(r["val_loss"] or r["train_loss"] for r in trainer.history.epochs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
