"""Epoch-level training loop with early stopping, history and checkpoints.

The counterpart of ``dlwp_cs_tpu.train.trainer``: :class:`EarlyStoppingMin`
(early stopping with a minimum-epoch floor and best-weights restore),
:class:`History` and :class:`Trainer`, with ``metrics.jsonl`` logging,
periodic checkpoints keyed by the global optimizer step, resume from the
latest checkpoint, and an optional profiler window (``torch.profiler``).

Step metrics stay on the device and are fetched in one copy every
``metrics_every`` optimizer steps and at the end of an epoch, so the host
issues steps ahead of the device instead of waiting on each loss.

Every batch takes one ``train_step`` call.  ``TrainConfig.fused_steps`` is
accepted and changes nothing: the reference fuses k steps into one
dispatch with ``lax.scan``, and eager torch has no such dispatch to save.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dlwp_cs_tpu_torch.models.config import TrainConfig
from dlwp_cs_tpu_torch.train.train_step import (
    TrainState,
    init_params,
    init_state,
    make_eval_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    model_apply,
)

__all__ = ["Trainer", "EarlyStoppingMin", "History"]


@dataclass
class EarlyStoppingMin:
    """Early stopping with a minimum-epochs floor and best-weights tracking:
    never stop before ``min_epochs``; stop after ``patience`` epochs without
    improvement."""

    patience: int = 50
    min_epochs: int = 0
    min_delta: float = 0.0
    best: float = float("inf")
    best_params: Any = None
    wait: int = 0

    def update(self, epoch: int, value: float, params) -> bool:
        """Record an epoch's monitored value; returns True to stop.

        ``params`` may be the parameters or a zero-argument callable making
        them, called only on improvement (so a non-improving epoch copies
        nothing from the device).
        """
        if value < self.best - self.min_delta:
            self.best = value
            self.best_params = params() if callable(params) else params
            self.wait = 0
        else:
            self.wait += 1
        return epoch + 1 >= self.min_epochs and self.wait >= self.patience


@dataclass
class History:
    """Per-epoch and per-step metric records."""

    epochs: list[dict] = field(default_factory=list)
    steps: list[dict] = field(default_factory=list)


def _host_params(params: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


class Trainer:
    """Drives training of a model over an iterable data source.

    Args:
      model: a port model (``CubeSphereUNet`` or ``CubeSphereConvLSTMNet``,
        built with ``in_channels``); it runs on the state's
        parameters (``torch.func.functional_call``), its own are the
        template.
      cfg: TrainConfig.
      area_weights: optional (6, n, n) weights for the area-weighted loss.
      workdir: if set, ``metrics.jsonl`` and periodic checkpoints go under it.
      profile_steps: ``(start, stop)``: a ``torch.profiler`` trace of those
        global steps is written to ``workdir/profile``.
      mesh: data-parallel and sharded training are the next slice of
        ``parallel/`` (``ROADMAP.md`` queue 1, item 17); anything but
        ``None`` raises.  Serving under a mesh is ported
        (``ForecastService(mesh=...)``).
    """

    def __init__(self, model, cfg: TrainConfig, *, area_weights=None,
                 workdir: str | Path | None = None,
                 profile_steps: tuple[int, int] | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (data-parallel and sharded training) is not ported yet: "
                "ROADMAP.md queue 1, item 17 (the training slice of parallel/)"
            )
        self.model = model
        self.cfg = cfg
        self.optimizer = make_optimizer(cfg)
        self.loss_fn = make_loss_fn(cfg, area_weights)
        self.apply_fn = model_apply(model)
        self.train_step = make_train_step(self.apply_fn, self.optimizer, self.loss_fn)
        self.eval_step = make_eval_step(self.apply_fn, self.loss_fn)
        self.workdir = Path(workdir) if workdir is not None else None
        if profile_steps is not None and self.workdir is None:
            raise ValueError("profile_steps requires a workdir for the trace")
        self.profile_steps = profile_steps
        self._epochs_done = 0  # set by restore_or_init on resume
        # early-stopping state spans the whole run, across restarts
        self.stopper: EarlyStoppingMin | None = None
        self.history = History()
        self._metrics_file = None
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            self._metrics_file = (self.workdir / "metrics.jsonl").open("a")

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    # -- lifecycle ---------------------------------------------------------
    def init(self, sample_inputs, seed: int | None = None) -> TrainState:
        """Fresh state: parameters drawn from ``seed`` (default
        ``cfg.seed``) for inputs shaped like ``sample_inputs``."""
        seed = self.cfg.seed if seed is None else seed
        if sample_inputs.shape[-1] != self.model.in_channels:
            raise ValueError(
                f"inputs have {sample_inputs.shape[-1]} channels, the model "
                f"takes {self.model.in_channels}"
            )
        return init_state(init_params(self.model, seed), self.optimizer)

    def restore_or_init(self, sample_inputs, seed: int | None = None) -> TrainState:
        """Resume from the latest workdir checkpoint, else a fresh init.

        The completed-epoch count and the early-stopping state ride in the
        checkpoint, so a resumed ``fit`` trains only the remaining epochs
        and stops and restores exactly as the uninterrupted run would.
        """
        from dlwp_cs_tpu_torch.utils.checkpoint import (
            latest_step,
            restore_aux,
            restore_checkpoint,
        )

        template = self.init(sample_inputs, seed)
        if self.workdir is None:
            return template
        ckpt_dir = self.workdir / "checkpoints"
        if latest_step(ckpt_dir) is None:
            return template
        state, extras = restore_checkpoint(ckpt_dir, template)
        if extras:
            self._epochs_done = int(extras.get("epochs_done", 0))
            es = extras.get("early_stopping")
            if es is not None:
                self.stopper = EarlyStoppingMin(
                    patience=self.cfg.early_stopping_patience,
                    min_epochs=self.cfg.min_epochs,
                    best=float(es["best"]) if es.get("best") is not None else float("inf"),
                    wait=int(es.get("wait", 0)),
                )
                if es.get("has_best_params"):
                    self.stopper.best_params = restore_aux(
                        ckpt_dir, int(es["ckpt_step"]), "best_params",
                        _host_params(template.params),
                    )
        return state

    def _log(self, record: dict) -> None:
        if self._metrics_file is not None:
            self._metrics_file.write(json.dumps(record) + "\n")
            self._metrics_file.flush()

    def _checkpoint(self, state: TrainState, *, step: int, epochs_done: int,
                    stopper: EarlyStoppingMin | None = None) -> None:
        # keyed by the global optimizer step, monotone across restarts
        if self.workdir is None:
            return
        from dlwp_cs_tpu_torch.utils.checkpoint import save_checkpoint

        extras: dict = {"epochs_done": epochs_done}
        aux = None
        if stopper is not None:
            extras["early_stopping"] = {
                "best": stopper.best if np.isfinite(stopper.best) else None,
                "wait": stopper.wait,
                "has_best_params": stopper.best_params is not None,
                "ckpt_step": step,
            }
            aux = {"best_params": stopper.best_params}
        save_checkpoint(self.workdir / "checkpoints", state, step=step,
                        extras=extras, aux=aux)

    # -- main loop ---------------------------------------------------------
    def fit(self, state: TrainState, train_data, *, val_data=None,
            epochs: int | None = None, verbose: bool = True) -> TrainState:
        """Train; ``train_data``/``val_data`` are callables returning an
        iterable of (inputs, targets) per epoch, or re-iterable iterables."""
        cfg = self.cfg
        epochs = cfg.max_epochs if epochs is None else epochs
        if self.stopper is None:
            self.stopper = EarlyStoppingMin(
                patience=cfg.early_stopping_patience, min_epochs=cfg.min_epochs
            )
        stopper = self.stopper
        gstep = int(state.step)
        dev = next(iter(state.params.values())).device
        metrics_every = max(1, int(cfg.metrics_every))
        prof = None  # the profiler window may span epochs
        for epoch in range(self._epochs_done, epochs):
            t0 = time.perf_counter()
            losses: list[float] = []
            # (first step, device metrics, host dispatch s, data wait s)
            pending: list[tuple[int, dict, float, float]] = []
            t_flush = time.perf_counter()

            def flush():
                nonlocal t_flush
                if not pending:
                    return
                # one device->host copy for the whole window
                flat = torch.stack([
                    torch.stack([m["loss"].reshape(()), m["grad_norm"].reshape(())])
                    for _, m, _, _ in pending
                ]).double().cpu().numpy()
                wall = (time.perf_counter() - t_flush) / len(pending)
                for (step_i, _, dispatch_s, data_wait), (loss, gnorm) in zip(pending, flat):
                    losses.append(float(loss))
                    rec = {
                        "kind": "step", "step": step_i, "loss": float(loss),
                        "grad_norm": float(gnorm),
                        # amortized wall seconds per step, compute included
                        "step_s": wall, "dispatch_s": dispatch_s,
                        "data_wait_s": data_wait,
                    }
                    self.history.steps.append(rec)
                    self._log(rec)
                pending.clear()
                t_flush = time.perf_counter()

            it = iter(_epoch_iter(train_data))
            while True:
                t_wait = time.perf_counter()
                batch = next(it, None)
                data_wait = time.perf_counter() - t_wait
                if batch is None:
                    break
                if self.profile_steps is not None and prof is None and (
                    gstep == self.profile_steps[0]
                ):
                    prof = _start_profile()
                inputs, targets = batch
                t_step = time.perf_counter()
                state, metrics = self.train_step(state, _on(inputs, dev), _on(targets, dev))
                pending.append((gstep, metrics, time.perf_counter() - t_step, data_wait))
                gstep += 1
                if prof is not None and gstep > self.profile_steps[1]:
                    _stop_profile(prof, self.workdir)
                    prof = None
                if len(pending) >= metrics_every:
                    flush()
            flush()
            train_loss = float(np.mean(losses)) if losses else float("nan")
            val_loss = None
            if val_data is not None:
                vl = [self.eval_step(state.params, _on(vi, dev), _on(vt, dev))["loss"]
                      for vi, vt in _epoch_iter(val_data)]
                val_loss = float(torch.stack(vl).double().mean()) if vl else float("nan")
            dt = time.perf_counter() - t0
            rec = {"kind": "epoch", "epoch": epoch, "train_loss": train_loss,
                   "val_loss": val_loss, "seconds": dt}
            self.history.epochs.append(rec)
            self._log(rec)
            if verbose:
                msg = f"epoch {epoch}: train_loss={train_loss:.6f}"
                if val_loss is not None:
                    msg += f" val_loss={val_loss:.6f}"
                print(msg + f" ({dt:.1f}s)")
            monitored = train_loss if val_loss is None else val_loss
            # best weights are copied to host memory, and only on improvement
            params_now = state.params
            best_candidate = (
                (lambda: _host_params(params_now)) if cfg.restore_best_weights else None
            )
            # the stopper updates before the checkpoint, so the saved
            # early-stopping state includes this epoch
            should_stop = stopper.update(epoch, monitored, best_candidate)
            if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                self._checkpoint(state, step=gstep, epochs_done=epoch + 1, stopper=stopper)
            if should_stop:
                if verbose:
                    print(f"early stopping at epoch {epoch} (best={stopper.best:.6f})")
                break
        if prof is not None:  # the stop step lies beyond the last step
            _stop_profile(prof, self.workdir)
        if cfg.restore_best_weights and stopper.best_params is not None:
            dev = {k: v.device for k, v in state.params.items()}
            best = {k: v.to(dev[k], copy=True).requires_grad_(True)
                    for k, v in stopper.best_params.items()}
            state = TrainState(best, state.opt_state, state.step)
        return state


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, workdir: Path) -> None:
    prof.__exit__(None, None, None)
    out = workdir / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def _on(x, device):
    """``x`` (a tensor or numpy array) as a tensor on ``device``."""
    return torch.as_tensor(x).to(device)


def _epoch_iter(data):
    """Accept either an iterable of batches or a zero-arg callable yielding one."""
    return data() if callable(data) else data
