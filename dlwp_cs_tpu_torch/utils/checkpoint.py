"""Checkpoints with ``torch.save``, laid out as the reference's.

The counterpart of ``dlwp_cs_tpu.utils.checkpoint``: a checkpoint of global
step ``N`` is the directory ``path/step_N`` holding ``state.pt`` (the
:class:`~dlwp_cs_tpu_torch.train.train_step.TrainState` as a dict of host
integers and tensors), optional side trees ``<name>.pt`` (``aux``, e.g. the
early stopper's best parameters) and ``extras.json``.

Writes are atomic: the whole step directory is written under a temporary
name (``.step_N.tmp-<pid>``) and renamed into place, so a crash never
leaves a partial ``step_N`` that :func:`latest_step` would pick.  Restoring
loads with ``weights_only=True`` onto the devices of a template state.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any

import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "restore_aux",
    "latest_step",
    "save_json",
    "load_json",
    "wait_for_checkpoints",
]

_STATE = "state.pt"
_EXTRAS = "extras.json"


def _root(path) -> Path:
    return Path(path).absolute()


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _like(saved, template):
    """``saved`` with each tensor moved to the device of ``template``'s
    tensor at the same place (and keeping its ``requires_grad``); raises if
    the structures differ."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(
                f"checkpoint holds {getattr(saved, 'shape', type(saved))}, "
                f"expected a tensor of shape {tuple(template.shape)}"
            )
        t = saved.to(device=template.device, dtype=template.dtype)
        return t.requires_grad_(template.requires_grad)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(
                f"checkpoint keys {sorted(saved) if isinstance(saved, dict) else saved} "
                f"differ from {sorted(template)}"
            )
        return {k: _like(saved[k], v) for k, v in template.items()}
    return saved


def save_checkpoint(path, state, *, step: int, extras: dict | None = None,
                    aux: dict[str, Any] | None = None) -> Path:
    """Write ``state`` (a ``TrainState``) under ``path/step_{step}``;
    returns that directory.  ``aux``: named side trees (``None`` values are
    skipped), restored with :func:`restore_aux`."""
    root = _root(path)
    root.mkdir(parents=True, exist_ok=True)
    target = root / f"step_{step}"
    tmp = root / f".step_{step}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(
        {"params": _to_host(state.params), "opt_state": _to_host(state.opt_state),
         "step": int(state.step)},
        tmp / _STATE,
    )
    for name, tree in (aux or {}).items():
        if name in ("state", "extras"):
            raise ValueError(f"reserved aux name {name!r}")
        if tree is not None:
            torch.save(_to_host(tree), tmp / f"{name}.pt")
    if extras is not None:
        save_json(tmp / _EXTRAS, extras)
    if target.exists():  # an overwrite: move the old one aside first
        old = root / f".step_{step}.old-{os.getpid()}"
        os.replace(target, old)
        shutil.rmtree(old)
    os.replace(tmp, target)
    return target


def wait_for_checkpoints() -> None:
    """Block until every checkpoint write is durable.  The reference's
    saves may run in the background; :func:`save_checkpoint` here returns
    only once its step directory is renamed into place, so there is
    nothing to wait for and this returns at once."""


def restore_checkpoint(path, target_state, *, step: int | None = None):
    """Restore the state saved by :func:`save_checkpoint` onto the devices
    of ``target_state`` (a ``TrainState`` of the same structure).

    Returns ``(state, extras_or_None)``.  With ``step=None`` the newest
    complete step is used; one that fails to load is skipped with a warning
    for the one before it.
    """
    root = _root(path)
    if step is not None:
        return _restore_step(root / f"step_{step}", target_state)
    candidates = sorted(_complete_steps(root), reverse=True)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {root}")
    last_err = None
    for s in candidates:
        try:
            return _restore_step(root / f"step_{s}", target_state)
        except (OSError, RuntimeError, ValueError, KeyError) as e:
            # resuming from an older step must be visible
            warnings.warn(
                f"checkpoint step_{s} under {root} failed to restore "
                f"({type(e).__name__}: {e}); falling back to the previous step",
                RuntimeWarning,
                stacklevel=2,
            )
            last_err = e
    raise RuntimeError(f"all checkpoints under {root} failed to restore") from last_err


def _restore_step(target: Path, template):
    saved = torch.load(target / _STATE, map_location="cpu", weights_only=True)
    state = type(template)(
        params=_like(saved["params"], template.params),
        opt_state=_like(saved["opt_state"], template.opt_state),
        step=int(saved["step"]),
    )
    extras_path = target / _EXTRAS
    return state, (load_json(extras_path) if extras_path.exists() else None)


def restore_aux(path, step: int, name: str, template):
    """The ``aux`` tree ``name`` saved with ``step``, on ``template``'s
    devices, or ``None`` if that checkpoint has none."""
    target = _root(path) / f"step_{step}" / f"{name}.pt"
    if not target.exists():
        return None
    return _like(torch.load(target, map_location="cpu", weights_only=True), template)


def _complete_steps(root: Path) -> list[int]:
    """Steps whose directory was renamed into place (it holds ``state.pt``);
    temporary directories start with a dot and never match."""
    if not root.exists():
        return []
    steps = []
    for p in root.iterdir():
        if p.is_dir() and p.name.startswith("step_") and (p / _STATE).exists():
            try:
                steps.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                continue
    return steps


def latest_step(path) -> int | None:
    steps = _complete_steps(_root(path))
    return max(steps) if steps else None


def save_json(path, obj: Any) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(obj, indent=2))


def load_json(path) -> Any:
    return json.loads(Path(path).read_text())
