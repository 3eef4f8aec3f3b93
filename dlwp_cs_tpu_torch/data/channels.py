"""Channel packing conventions shared by the model input and the rollout.

The counterpart of ``dlwp_cs_tpu.data.channels``.  Input channel layout
(channels-last ``(B, 6, n, n, C)``)::

    [ t_0 vars... | t_1 vars... | ... | insol(t_0..t_{Tin-1}) | constants ]

Output channels are the prognostic fields of the predicted times,
time-major-outer.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.geometry.insolation import insolation

__all__ = [
    "advance_window",
    "fold_time",
    "make_input_insolation",
    "pack_inputs",
    "unfold_time",
]


def fold_time(x):
    """``(B, T, 6, n, n, C) -> (B, 6, n, n, T*C)`` (time-major-outer)."""
    t = x.shape[1]
    x = torch.movedim(x, 1, -2)  # (B, 6, n, n, T, C)
    return x.reshape(tuple(x.shape[:-2]) + (t * x.shape[-1],))


def unfold_time(x, t: int):
    """Inverse of :func:`fold_time`: ``(B, 6, n, n, T*C) -> (B, T, 6, n, n, C)``."""
    c = x.shape[-1] // t
    if t * c != x.shape[-1]:
        raise ValueError(f"channels {x.shape[-1]} not divisible by time steps {t}")
    x = x.reshape(tuple(x.shape[:-1]) + (t, c))
    return torch.movedim(x, -2, 1)


def pack_inputs(window, insol=None, constants=None):
    """Model input ``(B, 6, n, n, T_in*C_var [+ T_in] [+ K])`` from the
    normalized ``window`` ``(B, T_in, 6, n, n, C_var)``, optional insolation
    ``(B, T_in, 6, n, n)`` or ``(T_in, 6, n, n)`` (broadcast over batch) and
    optional constants ``(6, n, n, K)``."""
    parts = [fold_time(window)]
    b = window.shape[0]
    if insol is not None:
        if insol.ndim == 4:
            insol = insol[None].expand((b,) + tuple(insol.shape))
        parts.append(fold_time(insol[..., None]))
    if constants is not None:
        parts.append(constants[None].expand((b,) + tuple(constants.shape)))
    return torch.cat(parts, dim=-1)


def make_input_insolation(data_cfg, lat, lon, insol_mean=0.0, insol_std=1.0):
    """Closure: normalized insolation channels for the input window ENDING
    at ``t_days`` (offsets ``-(T_in-1)..0`` steps), or ``None`` when
    ``data_cfg.add_insolation`` is off.

    ``lat``/``lon`` are ``(6, n, n)`` tensors on the device; ``t_days`` a
    scalar or ``(B,)`` float32 tensor.  The channels are ``(T_in, 6, n, n)``
    or ``(B, T_in, 6, n, n)`` respectively.
    """
    t_in = data_cfg.input_time_steps
    dt_days = data_cfg.step_hours / 24.0
    offsets = (torch.arange(t_in, device=lat.device) - (t_in - 1)) * dt_days

    def input_insolation(t_days):
        if not data_cfg.add_insolation:
            return None
        if t_days.ndim == 0:
            times = t_days + offsets  # (T_in,)
        else:
            times = t_days[:, None] + offsets[None, :]  # (B, T_in)
        ins = insolation(times[..., None, None, None], lat, lon)
        return (ins - insol_mean) / insol_std

    return input_insolation


def advance_window(window, out, t_out: int):
    """Append the ``T_out`` predicted steps of ``out`` ``(B, 6, n, n,
    T_out*C)`` to ``window`` and keep the last ``T_in``.  Returns
    ``(new_window, out_window)``."""
    t_in = window.shape[1]
    out_window = unfold_time(out, t_out)  # (B, T_out, 6, n, n, C)
    new_window = torch.cat([window, out_window], dim=1)[:, -t_in:]
    return new_window, out_window
