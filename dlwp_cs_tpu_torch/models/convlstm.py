"""Recurrent (ConvLSTM) model family on the cubed sphere.

The counterpart of ``dlwp_cs_tpu.models.convlstm``: one gate convolution
per step over ``cat([x, h])`` gives the four gates [i, f, g, o]; the gate
math and the cell state ``c`` are float32, ``h`` is carried in the cell
dtype.  The reference's ``nn.scan`` over time is a Python loop here.  A
fresh call starts from the zero carry; callers that want state across calls
pass it in (``initial_carry``) and take it back (``return_carry``).

:class:`CubeSphereConvLSTMNet` takes the standard folded channel layout
``[t·vars | t·insol | constants]`` (``data/channels.py``) and emits the
folded multi-step output, so the data feed, trainer and rollout run it as
they run the U-Net.  Module names follow the reference's flax scopes
(``convlstm{i}.cell.gates``, ``head``), so its parameter tree loads by name
(:func:`~dlwp_cs_tpu_torch.models.weights.load_jax_params`).
"""

from __future__ import annotations

import torch
from torch import nn

from dlwp_cs_tpu_torch.data.channels import unfold_time
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.models.config import ConvLSTMConfig
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D

__all__ = [
    "CubeSphereConvLSTM",
    "CubeSphereConvLSTMCell",
    "CubeSphereConvLSTMNet",
    "LatLonConvLSTMCell",
]


class CubeSphereConvLSTMCell(nn.Module):
    """ConvLSTM cell whose gate convolution is a cubed-sphere conv over
    ``in_channels + features`` channels.  ``dtype`` is the compute dtype
    (``None``: the input's)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3), *, forget_bias: float = 1.0,
                 separate_polar_weights: bool = True, backend: str = "auto",
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.features = features
        self.forget_bias = forget_bias
        self.dtype = dtype
        self.gates = CubeSphereConv2D(
            in_channels + features, 4 * features, tuple(kernel_size),
            separate_polar_weights=separate_polar_weights, backend=backend,
            dtype=dtype, generator=generator,
        )

    def jax_scopes(self) -> dict:
        """The reference's flax scope of the gate conv."""
        return {"gates": self.gates}

    def forward(self, carry, x):
        """One step: ``carry = (h, c)``, ``x`` (B, 6, n, n, C).  Returns
        ``((h_new, c_new), out)``: each carry in its own dtype, ``out`` (=
        ``h_new``) in ``x``'s."""
        h, c = carry
        z = self.gates(torch.cat([x, h.to(x.dtype)], dim=-1))
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f.float() + self.forget_bias) * c.float()
        c_new = c_new + torch.sigmoid(i.float()) * torch.tanh(g.float())
        h_new = torch.sigmoid(o.float()) * torch.tanh(c_new)
        return (h_new.to(h.dtype), c_new.to(c.dtype)), h_new.to(x.dtype)

    def initialize_carry(self, x_like):
        """Zero carry for a step input shaped like ``x_like``: ``h`` in the
        cell dtype (else ``x_like``'s), ``c`` in float32."""
        shape = tuple(x_like.shape[:-1]) + (self.features,)
        dtype = self.dtype if self.dtype is not None else x_like.dtype
        return (x_like.new_zeros(shape, dtype=dtype),
                x_like.new_zeros(shape, dtype=torch.float32))


class LatLonConvLSTMCell(nn.Module):
    """The lat-lon ConvLSTM cell: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the lat-lon ConvLSTM cell is not ported yet: ROADMAP.md queue 1, "
            "item 15 (lat-lon models)"
        )


class CubeSphereConvLSTM(nn.Module):
    """ConvLSTM layer over a sequence ``(B, T, 6, n, n, C)``.

    Returns all hidden states ``(B, T, 6, n, n, F)`` with
    ``return_sequences``, else the last; ``return_carry=True`` also returns
    the final ``(h, c)``, which as ``initial_carry`` continues the sequence.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: tuple[int, int] = (3, 3), *, return_sequences: bool = False,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None, **cell_kwargs):
        super().__init__()
        self.return_sequences = return_sequences
        self.cell = CubeSphereConvLSTMCell(in_channels, features, kernel_size, dtype=dtype,
                                           generator=generator, **cell_kwargs)

    def jax_scopes(self) -> dict:
        """The reference's flax scope of the gate conv (under ``nn.scan``)."""
        return {f"cell/{k}": m for k, m in self.cell.jax_scopes().items()}

    def forward(self, xs, initial_carry=None, *, return_carry: bool = False):
        carry = initial_carry
        if carry is None:
            carry = self.cell.initialize_carry(xs[:, 0])
        hs = []
        for t in range(xs.shape[1]):
            carry, h = self.cell(carry, xs[:, t])
            hs.append(h)
        out = torch.stack(hs, dim=1) if self.return_sequences else carry[0]
        return (out, carry) if return_carry else out


class CubeSphereConvLSTMNet(nn.Module):
    """Stacked ConvLSTM forecast network, a drop-in for the U-Net.

    ``(B, 6, n, n, in_channels)`` folded input -> ``(B, 6, n, n,
    output_channels)`` float32: the input unfolds to ``(B, T_in, 6, n, n,
    C_step)`` (constants tiled over time), runs ``len(filters)`` ConvLSTM
    layers (all but the last return sequences) and a linear conv head on the
    final hidden state.  Parameters are drawn from ``generator`` on the CPU,
    then moved to ``device`` (``None``: the GPU, which must exist).
    """

    def __init__(self, config: ConvLSTMConfig, in_channels: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.in_channels = in_channels
        self.dtype = getattr(torch, config.compute_dtype)
        t, cv = config.input_time_steps, config.variable_channels
        self.n_const = in_channels - t * cv - (t if config.add_insolation else 0)
        if self.n_const < 0:
            raise ValueError(
                f"input channels {in_channels} < folded prognostic+insolation "
                f"channels for T_in={t}, C_var={cv}"
            )
        cin = cv + (1 if config.add_insolation else 0) + self.n_const
        self.layers = []
        for i, feats in enumerate(config.filters):
            layer = CubeSphereConvLSTM(
                cin, feats, config.kernel_size,
                return_sequences=i < len(config.filters) - 1, dtype=self.dtype,
                generator=generator,
                separate_polar_weights=config.separate_polar_weights,
                backend=config.conv_backend,
            )
            self.add_module(f"convlstm{i}", layer)
            self.layers.append(layer)
            cin = feats
        self.head = CubeSphereConv2D(
            cin, config.output_channels, tuple(config.head_kernel_size),
            separate_polar_weights=config.separate_polar_weights,
            backend=config.conv_backend, dtype=self.dtype, generator=generator,
        )
        self.to(dev)

    def jax_scopes(self) -> dict:
        """The reference's flax scope of each conv layer, ``"a/b/c"``."""
        scopes = {f"convlstm{i}/{k}": m for i, layer in enumerate(self.layers)
                  for k, m in layer.jax_scopes().items()}
        scopes["head"] = self.head
        return scopes

    def forward(self, x):
        cfg = self.config
        t, cv = cfg.input_time_steps, cfg.variable_channels
        x = x.to(self.dtype)
        parts = [unfold_time(x[..., : t * cv], t)]
        if cfg.add_insolation:
            parts.append(unfold_time(x[..., t * cv : t * cv + t], t))
        if self.n_const:
            const = x[..., -self.n_const :]
            parts.append(const[:, None].expand((const.shape[0], t) + tuple(const.shape[1:])))
        h = torch.cat(parts, dim=-1)
        for layer in self.layers:
            h = layer(h)
        return self.head(h).float()
