"""String-keyed layer registry and the declarative sequential model.

The counterpart of ``dlwp_cs_tpu.models.registry``: a model is a list of
``('LayerName', args, kwargs)`` tuples resolved by name, as the reference's
``DLWPNeuralNet`` specs are.  Example::

    spec = [
        ("CubeSphereConv2D", (), {"features": 32}),
        ("LeakyReLU", (), {"negative_slope": 0.1}),
        ("AvgPool", (2,), {}),
        ("CubeSphereConv2D", (), {"features": 4, "kernel_size": (1, 1)}),
    ]
    model = SequentialSpec(freeze_spec(spec), in_channels=3)

Torch builds parameters when a module is made, so :class:`SequentialSpec`
walks the spec once and carries the channel count: a module is built as
``cls(channels, *args, **kwargs, generator=)`` and sets the count to its
``features`` (the keyword, else the first argument); a function keeps it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D, lecun_normal_
from dlwp_cs_tpu_torch.ops.pooling import cs_avg_pool, cs_max_pool, cs_upsample

__all__ = ["Dense", "LAYERS", "SequentialSpec", "freeze_spec", "get_layer", "register_layer"]


class Dense(nn.Module):
    """flax's ``nn.Dense`` over the last axis: ``kernel`` ``(in, out)``
    (lecun normal), ``bias`` ``(out,)`` (zeros), float32 parameters cast to
    the compute ``dtype`` (``None``: the input's)."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        dtype = x.dtype if self.dtype is None else self.dtype
        out = x.to(dtype) @ self.kernel.to(dtype)
        return out if self.bias is None else out + self.bias.to(dtype)


# Module layers: built with (channels, *args, **kwargs), then called on the input.
_MODULES = {
    "CubeSphereConv2D": CubeSphereConv2D,
    "Dense": Dense,
}
# "CubeSphereConvLSTM" is added by models/__init__ via register_layer
# (convlstm.py imports layers.py, so this module does not import it).

# Stateless ops: called as fn(x, *args, **kwargs).
_FUNCTIONS = {
    "AvgPool": cs_avg_pool,
    "MaxPool": cs_max_pool,
    "UpSampling": cs_upsample,
    "LeakyReLU": lambda x, negative_slope=0.1: F.leaky_relu(x, negative_slope),
    "ReLU": lambda x: F.relu(x),
    "Tanh": lambda x: torch.tanh(x),
}

LAYERS = {**_MODULES, **_FUNCTIONS}


def register_layer(name: str, fn, *, is_module: bool = False) -> None:
    """Extend the registry.  Re-registering a name replaces it in both the
    kind-specific table and the combined view, so that ``SequentialSpec``
    and :func:`get_layer` resolve it to the same layer."""
    _MODULES.pop(name, None)
    _FUNCTIONS.pop(name, None)
    target = _MODULES if is_module else _FUNCTIONS
    target[name] = fn
    LAYERS[name] = fn


def get_layer(name: str):
    """Resolve a layer name; raises KeyError with the known names listed."""
    try:
        return LAYERS[name]
    except KeyError:
        raise KeyError(f"unknown layer {name!r}; known: {sorted(LAYERS)}") from None


def freeze_spec(spec):
    """Make a layer spec hashable, recursively: lists become tuples and dicts
    sorted ``(key, value)`` tuples (specs loaded from JSON or YAML carry lists
    inside their values, e.g. ``kernel_size: [3, 3]``).  A frozen spec comes
    back as it is."""

    def freeze_value(v):
        if isinstance(v, (list, tuple)):
            return tuple(freeze_value(u) for u in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze_value(u)) for k, u in v.items()))
        return v

    return tuple(
        (name, tuple(freeze_value(a) for a in args),
         tuple(sorted((k, freeze_value(v)) for k, v in dict(kwargs).items())))
        for name, args, kwargs in spec
    )


class SequentialSpec(nn.Module):
    """Run a declarative ``(name, args, kwargs)`` layer spec sequentially on
    inputs of ``in_channels`` channels.  Module ``idx`` is named
    ``f"{name.lower()}_{idx}"``, the reference's flax scope, so its
    parameter tree loads by name
    (:func:`~dlwp_cs_tpu_torch.models.weights.load_jax_params`).  Parameters
    are drawn from ``generator`` on the CPU in spec order, then moved to
    ``device`` (``None``: the GPU, which must exist)."""

    def __init__(self, spec, in_channels: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.spec = freeze_spec(spec)
        # (module, None, (), {}) or (None, function, args, kwargs) per layer
        self._steps = []
        channels = in_channels
        for idx, (name, args, kw_items) in enumerate(self.spec):
            kwargs = dict(kw_items)
            if name in _MODULES:
                module = _MODULES[name](channels, *args, **kwargs, generator=generator)
                self.add_module(f"{name.lower()}_{idx}", module)
                channels = kwargs["features"] if "features" in kwargs else args[0]
                self._steps.append((module, None, (), {}))
            elif name in _FUNCTIONS:
                self._steps.append((None, _FUNCTIONS[name], args, kwargs))
            else:
                raise KeyError(f"unknown layer {name!r}; known: {sorted(LAYERS)}")
        self.out_channels = channels
        self.to(dev)

    def jax_scopes(self) -> dict:
        """The reference's flax scope of each layer with parameters."""
        scopes = {}
        for name, module in self.named_children():
            own = getattr(module, "jax_scopes", None)
            if own is None:
                scopes[name] = module
            else:
                scopes.update({f"{name}/{k}": m for k, m in own().items()})
        return scopes

    def forward(self, x):
        for module, fn, args, kwargs in self._steps:
            x = module(x) if module is not None else fn(x, *args, **kwargs)
        return x
