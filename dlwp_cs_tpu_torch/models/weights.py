"""Carry the reference's flax parameters across to the port's modules."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]


def load_jax_params(model, params):
    """Fill ``model`` (a :class:`CubeSphereUNet`) from a flax parameter tree.

    ``params`` is ``{"params": {scope: {"kernel_eq": array, ...}}}`` with
    numpy (or array-like) leaves.  Raises ``KeyError`` on a missing or extra
    scope or parameter, and ``ValueError`` on a shape mismatch; nothing is
    copied unless the whole tree matches.  Returns ``model``.
    """
    if not isinstance(params, dict) or set(params) != {"params"}:
        raise KeyError(
            "expected a flax tree {'params': {...}}, got keys "
            f"{sorted(params) if isinstance(params, dict) else type(params)}"
        )
    tree = params["params"]
    scopes = dict(model.convs.items())
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
