"""Training step: loss, optimizer, state.

The counterpart of ``dlwp_cs_tpu.train.train_step``.  The optimizer
reproduces optax's numerics rather than ``torch.optim``'s, so that a run of
the port follows the reference's step for step:

* ``adam`` / ``adamw`` / ``sgd`` as ``optax.adam`` / ``adamw`` / ``sgd``
  (Adam: ``m / (1 - b1^t)`` over ``sqrt(v / (1 - b2^t)) + eps``, the bias
  corrections in float32; AdamW adds ``weight_decay * param`` before the
  learning rate);
* the ``cosine`` and ``warmup_cosine`` schedules of optax, evaluated at the
  count before the step's increment;
* ``clip_by_global_norm``: ``g * max_norm / norm`` when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs);
* ``optax.MultiSteps`` for ``grad_accum_steps > 1``: a running mean of the
  k micro-gradients, zero updates in between, the inner state advancing
  only on the k-th step.

Parameters are a dict of leaf tensors by name (``model.named_parameters()``
names); the model runs on them through ``torch.func.functional_call``, so a
:class:`TrainState` holds the whole truth, as the reference's pytree does.
A step returns new parameter tensors and leaves the old state untouched.
Step counts are host integers: the host drives the loop and reading a
device counter would synchronise.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from dlwp_cs_tpu_torch.models.config import TrainConfig
from dlwp_cs_tpu_torch.ops.losses import AreaWeightedLoss, mae, mse

__all__ = [
    "TrainState",
    "Optimizer",
    "make_optimizer",
    "make_loss_fn",
    "init_state",
    "init_params",
    "params_of",
    "model_apply",
    "value_and_grad",
    "global_norm",
    "make_train_step",
    "make_scanned_train_step",
    "make_eval_step",
    "apply_gradients",
    "scan_steps",
]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam / adamw defaults


class TrainState(NamedTuple):
    """Training state: parameters by name, optimizer state, step count."""

    params: dict
    opt_state: dict
    step: int


def _f32(v) -> np.float32:
    return np.float32(v)


def _cosine(init_value: float, decay_steps: float, alpha: float = 0.0):
    """optax.cosine_decay_schedule, in float32."""

    def schedule(count: int) -> np.float32:
        c = min(_f32(count), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return _f32(init_value) * ((_f32(1) - _f32(alpha)) * cosine + _f32(alpha))

    return schedule


def _linear(init_value: float, end_value: float, steps: int):
    """optax.linear_schedule, in float32."""

    def schedule(count: int) -> np.float32:
        c = _f32(min(max(count, 0), steps))
        frac = _f32(1) - c / _f32(steps)
        return (_f32(init_value) - _f32(end_value)) * frac + _f32(end_value)

    return schedule


def _make_schedule(cfg: TrainConfig) -> Callable[[int], np.float32]:
    """Learning rate as a function of the optimizer's count."""
    sched = cfg.lr_schedule
    if sched == "constant":
        return lambda count: _f32(cfg.learning_rate)
    if sched == "cosine":
        return _cosine(cfg.learning_rate, max(1, cfg.lr_decay_steps))
    if sched == "warmup_cosine":
        warmup = max(1, cfg.lr_warmup_steps)
        warm = _linear(0.0, cfg.learning_rate, warmup)
        decay = _cosine(cfg.learning_rate, max(2, cfg.lr_decay_steps) - warmup)
        return lambda count: warm(count) if count < warmup else decay(count - warmup)
    raise ValueError(f"unknown lr_schedule {sched!r}")


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Optimizer:
    """The reference's optax chain, built from a :class:`TrainConfig`:
    ``[MultiSteps(] [clip_by_global_norm ->] adam | adamw | sgd -> learning
    rate [)]``.  State is a dict of host counters and tensors by parameter
    name, so ``torch.save`` writes it as it is."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = float(cfg.weight_decay)
        self.clip = None if cfg.grad_clip_norm is None else float(cfg.grad_clip_norm)
        self.accum = max(1, int(cfg.grad_accum_steps))
        self.schedule = _make_schedule(cfg)

    def init(self, params: dict) -> dict:
        inner: dict[str, Any] = {"count": 0}
        if self.kind != "sgd":
            inner["mu"] = {k: torch.zeros_like(p) for k, p in params.items()}
            inner["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        if self.accum == 1:
            return inner
        return {
            "mini_step": 0,
            "gradient_step": 0,
            "acc": {k: torch.zeros_like(p) for k, p in params.items()},
            "inner": inner,
        }

    def _inner_update(self, grads: dict, st: dict, params: dict):
        if self.clip is not None:
            norm = global_norm(grads.values())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip) for k, g in grads.items()}
        count = st["count"]
        new = {"count": count + 1}
        if self.kind == "sgd":
            u = grads
        else:
            mu = {k: (1 - _B1) * g + _B1 * st["mu"][k] for k, g in grads.items()}
            nu = {k: (1 - _B2) * torch.square(g) + _B2 * st["nu"][k] for k, g in grads.items()}
            bc1 = float(_f32(1) - _f32(_B1) ** _f32(count + 1))
            bc2 = float(_f32(1) - _f32(_B2) ** _f32(count + 1))
            u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS) for k in grads}
            if self.kind == "adamw":
                u = {k: v + self.weight_decay * params[k] for k, v in u.items()}
            new.update(mu=mu, nu=nu)
        step_size = -float(self.schedule(count))
        return {k: v * step_size for k, v in u.items()}, new

    def update(self, grads: dict, state: dict, params: dict):
        """``(updates, new_state)``; ``updates`` is ``None`` on a
        gradient-accumulation step that emits no update (optax's zeros)."""
        if self.accum == 1:
            return self._inner_update(grads, state, params)
        n = state["mini_step"]
        acc = {k: a + (grads[k] - a) / (n + 1) for k, a in state["acc"].items()}
        if n < self.accum - 1:
            return None, dict(state, mini_step=n + 1, acc=acc)
        updates, inner = self._inner_update(acc, state["inner"], params)
        return updates, {
            "mini_step": 0,
            "gradient_step": state["gradient_step"] + 1,
            "acc": {k: torch.zeros_like(a) for k, a in acc.items()},
            "inner": inner,
        }


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """The optimizer of ``cfg`` (adam/adamw/sgd + schedule + clip + accumulation)."""
    return Optimizer(cfg)


def make_loss_fn(cfg: TrainConfig, area_weights=None) -> Callable:
    """``loss(pred, target)`` per config; ``area_weights`` is a (6, n, n)
    array (``CubedSphere.area_weights``) for ``cfg.area_weighted_loss``."""
    if cfg.loss not in ("mse", "mae"):
        raise ValueError(f"unknown loss {cfg.loss!r}")
    if cfg.area_weighted_loss:
        if area_weights is None:
            raise ValueError("area_weighted_loss=True requires area_weights")
        return AreaWeightedLoss(cfg.loss, area_weights)
    return mse if cfg.loss == "mse" else mae


def params_of(model) -> dict:
    """A copy of ``model``'s parameters by name, as trainable leaf tensors."""
    return {k: p.detach().clone().requires_grad_(True) for k, p in model.named_parameters()}


def init_params(model, seed: int) -> dict:
    """Fresh parameters for ``model``: those of a new model of its class and
    configuration drawn from ``torch.Generator().manual_seed(seed)``, on
    ``model``'s device."""
    fresh = type(model)(model.config, model.in_channels, device="cpu",
                        generator=torch.Generator().manual_seed(int(seed)))
    dev = next(model.parameters()).device
    return {k: p.detach().to(dev).requires_grad_(True) for k, p in fresh.named_parameters()}


def model_apply(model) -> Callable:
    """``apply(params, inputs)``: ``model`` run on the parameter dict."""

    def apply(params, inputs):
        return torch.func.functional_call(model, params, (inputs,))

    return apply


def init_state(params: dict, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def value_and_grad(apply_fn, loss_fn) -> Callable:
    """``fn(params, inputs, targets) -> (loss, grads)``, grads by name."""

    def fn(params, inputs, targets):
        loss = loss_fn(apply_fn(params, inputs), targets)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    return fn


def apply_gradients(optimizer: Optimizer, state: TrainState, loss, grads: dict):
    """``(state, metrics)`` after one optimizer step on ``grads`` (by
    parameter name); metrics ``loss`` and the pre-clip ``grad_norm``."""
    gnorm = global_norm(grads.values())
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = state.params
        if updates is not None:
            params = {
                k: (p.detach() + updates[k]).requires_grad_(True)
                for k, p in params.items()
            }
    return TrainState(params, opt_state, state.step + 1), {"loss": loss, "grad_norm": gnorm}


def make_train_step(apply_fn, optimizer: Optimizer, loss_fn) -> Callable:
    """``train_step(state, inputs, targets) -> (state, metrics)``; metrics
    ``loss`` and the pre-clip ``grad_norm`` stay on the device."""
    vg = value_and_grad(apply_fn, loss_fn)

    def step(state: TrainState, inputs, targets):
        loss, grads = vg(state.params, inputs, targets)
        return apply_gradients(optimizer, state, loss, grads)

    return step


def make_scanned_train_step(apply_fn, optimizer: Optimizer, loss_fn) -> Callable:
    """``step_k(state, inputs_k, targets_k) -> (state, metrics_k)``: ``k``
    optimizer steps over the leading (step) axis of stacked batches, as a
    loop; metrics come back as ``(k,)`` tensors."""
    return scan_steps(make_train_step(apply_fn, optimizer, loss_fn))


def scan_steps(base: Callable) -> Callable:
    """``step_k(state, inputs_k, targets_k)``: ``base`` on each batch of the
    leading (step) axis in turn, the metrics stacked into ``(k,)``
    tensors (the reference's ``lax.scan`` of a step)."""

    def step_k(state: TrainState, inputs_k, targets_k):
        ms = []
        for inputs, targets in zip(inputs_k, targets_k):
            state, m = base(state, inputs, targets)
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_k


def make_eval_step(apply_fn, loss_fn) -> Callable:
    """``eval_step(params, inputs, targets) -> {"loss": ...}``."""

    def step(params, inputs, targets):
        with torch.no_grad():
            return {"loss": loss_fn(apply_fn(params, inputs), targets)}

    return step
