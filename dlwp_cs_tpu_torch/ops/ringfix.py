"""Weight-group helpers shared by the conv formulations.

The part of ``dlwp_cs_tpu.ops.ringfix`` that the serving path runs: the
per-face select between the two weight groups' outputs and the per-group
bias.  The ring-fix conv formulation itself is not ported (``ROADMAP.md``
queue 1, item 4).
"""

from __future__ import annotations

import torch

__all__ = ["face_select", "add_group_bias"]


def face_select(eq_out, po_out):
    """Per-face weight-group select: faces 0-3 take ``eq_out``, 4-5 ``po_out``."""
    return torch.cat([eq_out[:, :4], po_out[:, 4:]], dim=1)


def add_group_bias(out, bias_eq, bias_pole):
    """Add per-weight-group biases to ``(B, 6, ..., Cout)`` conv output
    (equatorial faces 0-3, polar faces 4-5); no-op when both are None."""
    if bias_eq is None and bias_pole is None:
        return out
    zeros = out.new_zeros(out.shape[-1])
    b_eq = zeros if bias_eq is None else bias_eq
    b_po = zeros if bias_pole is None else bias_pole
    bias = torch.stack([b_eq] * 4 + [b_po] * 2, dim=0)  # (6, Cout)
    shape = (1, 6) + (1,) * (out.ndim - 3) + (out.shape[-1],)
    return out + bias.reshape(shape).to(out.dtype)
