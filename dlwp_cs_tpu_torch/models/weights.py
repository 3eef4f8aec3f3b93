"""Carry the reference's flax parameters across to the port's modules."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]


def _scopes_of(tree, prefix=""):
    """``{"a/b/c": {param: leaf}}``: every dict of ``tree`` that holds no
    dict is a scope (an empty dict too)."""
    subs = {k: v for k, v in tree.items() if isinstance(v, dict)}
    if not subs:
        return {prefix.rstrip("/"): tree}
    if len(subs) != len(tree):
        leaves = sorted(set(tree) - set(subs))
        raise KeyError(f"scope {prefix.rstrip('/') or '/'}: unexpected parameters {leaves}")
    out = {}
    for k, v in subs.items():
        out.update(_scopes_of(v, f"{prefix}{k}/"))
    return out


def load_jax_params(model, params):
    """Fill ``model`` (any of the port's models with ``jax_scopes()``: a
    :class:`CubeSphereUNet`, :class:`CubeSphereConvLSTMNet`,
    :class:`LatLonUNet`, :class:`SequentialSpec` or
    :class:`CubeSphereConvLSTM`, of cubed-sphere or lat-lon cells) from a
    flax parameter tree.

    ``params`` is ``{"params": {...}}`` with numpy (or array-like) leaves:
    the U-Nets' flat scopes (``enc0_conv0/kernel_eq``, ``enc0_conv0/kernel``)
    or the ConvLSTM's nested ones (``convlstm0/cell/gates/kernel_eq``,
    ``head/...``), as ``model.jax_scopes()`` names them.  Raises ``KeyError`` on a missing or
    extra scope or parameter, and ``ValueError`` on a shape mismatch;
    nothing is copied unless the whole tree matches.  Returns ``model``.
    """
    if not isinstance(params, dict) or set(params) != {"params"}:
        raise KeyError(
            "expected a flax tree {'params': {...}}, got keys "
            f"{sorted(params) if isinstance(params, dict) else type(params)}"
        )
    tree = _scopes_of(params["params"])
    scopes = model.jax_scopes()
    missing, extra = sorted(set(scopes) - set(tree)), sorted(set(tree) - set(scopes))
    if missing or extra:
        raise KeyError(f"scopes missing: {missing}, unexpected: {extra}")
    copies = []
    for name, module in scopes.items():
        own = dict(module.named_parameters())
        got = tree[name]
        missing = sorted(set(own) - set(got))
        extra = sorted(set(got) - set(own))
        if missing or extra:
            raise KeyError(f"{name}: parameters missing: {missing}, unexpected: {extra}")
        for key, p in own.items():
            value = np.asarray(got[key], np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(
                    f"{name}/{key}: shape {value.shape}, expected {tuple(p.shape)}"
                )
            copies.append((p, value))
    with torch.no_grad():
        for p, value in copies:
            p.copy_(torch.from_numpy(value))
    return model
