"""Ring-fix cubed-sphere convolution and the weight-group helpers.

The counterpart of ``dlwp_cs_tpu.ops.ringfix``: a 3x3 stride-1 cubed-sphere
conv as per-face zero-padded SAME convs plus the halo correction
:func:`ring_term`, which contracts the corner-extended ghost strips
(:func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips`) with the kernel's outside
rows and columns and adds the four edge fixes on each face's boundary ring,
less the corner ghosts that entered through two edges.  Everything is plain
torch and differentiable; the result equals ``cs_pad`` + VALID conv.

The base convs use the reference's unpacked AUTO structure (``"dual"``: two
full 6-face convs and a face select).  Its batch->lane packing
(``use_packed_base``, ``ops/packing.py``) is a TPU matrix-unit layout of
the same map and has no counterpart here.

:func:`_same_conv` runs cuDNN in full float32 for float32 inputs, whatever
the global ``torch.backends.cudnn.allow_tf32`` says (its default, ``True``,
rounds the products to TF32, a 1e-3 error); its backward does the same, with
deterministic algorithms, so that two identical steps give bitwise-equal
gradients.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_N, EDGE_S, EDGE_W
from dlwp_cs_tpu_torch.ops.halo import ext_strips

__all__ = [
    "add_group_bias",
    "cs_conv3x3_ringfix",
    "face_select",
    "ring_apply",
    "ring_contract",
    "ring_term",
]


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


# cuDNN's flags are process-global: one lock keeps concurrent callers (the
# forecast service's worker, autograd's device threads) from restoring them
# under each other's convolutions.
_CUDNN_LOCK = threading.Lock()


@contextlib.contextmanager
def _cudnn_flags(t, deterministic: bool = False):
    """cuDNN convolutions launched in this block on the CUDA tensor ``t``
    run in full float32 (for float32) and, with ``deterministic``, with
    deterministic algorithms (the backward's weight gradient may otherwise
    sum with atomics in an order that changes from run to run)."""
    if not t.is_cuda:
        yield
        return
    cudnn = torch.backends.cudnn
    with _CUDNN_LOCK:
        saved = (cudnn.allow_tf32, cudnn.deterministic)
        cudnn.allow_tf32 = saved[0] and t.dtype != torch.float32
        cudnn.deterministic = saved[1] or deterministic
        try:
            yield
        finally:
            cudnn.allow_tf32, cudnn.deterministic = saved


def _nchw(xg):
    """``(B, F, n, n, C) -> (B*F, C, n, n)``: faces folded into the batch, a
    channels-last view."""
    return xg.reshape((-1,) + tuple(xg.shape[2:])).permute(0, 3, 1, 2)


def _faces(out_nchw, b):
    """Inverse of :func:`_nchw`, contiguous."""
    out = out_nchw.permute(0, 2, 3, 1)
    return out.reshape((b, -1) + tuple(out.shape[1:])).contiguous()


def _same_conv_vjp(xg, kernel, g, need=(True, True)):
    """``(dx, dk)`` of :func:`_same_conv` at ``(xg, kernel)`` for the
    cotangent ``g``, in the input's and the kernel's dtype (None where
    ``need`` says so)."""
    b = xg.shape[0]
    with _cudnn_flags(xg, deterministic=True):
        dx, dk, _ = torch.ops.aten.convolution_backward(
            _nchw(g.to(xg.dtype)), _nchw(xg), kernel.to(xg.dtype).permute(3, 2, 0, 1),
            None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [need[0], need[1], False],
        )
    return (
        None if dx is None else _faces(dx, b),
        None if dk is None else dk.permute(2, 3, 1, 0).to(kernel.dtype),
    )


class _SameConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, kernel):
        ctx.save_for_backward(xg, kernel)
        with _cudnn_flags(xg):
            out = F.conv2d(_nchw(xg), kernel.to(xg.dtype).permute(3, 2, 0, 1), padding=1)
        return _faces(out, xg.shape[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xg, kernel = ctx.saved_tensors
        return _same_conv_vjp(xg, kernel, g, ctx.needs_input_grad)


def _same_conv(xg, kernel):
    """Zero-padded SAME 3x3 conv of ``(B, F, n, n, Cin)`` with the HWIO
    ``kernel`` (3, 3, Cin, Cout), faces folded into the batch; cuDNN (full
    float32 for float32), output contiguous in the input's dtype."""
    return _SameConv.apply(xg, kernel)


def cs_conv3x3_ringfix(x, k_eq, k_pole, *, bias_eq=None, bias_pole=None):
    """Ring-fix CS conv, 3x3/stride-1: ``(B, 6, n, n, Cin) -> (B, 6, n, n,
    Cout)``; exactly ``cs_pad(x, 1)`` + per-group VALID conv."""
    b, nf, n, n2, _ = x.shape
    if nf != 6 or n != n2:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    out = face_select(_same_conv(x, k_eq), _same_conv(x, k_pole))
    out = out + ring_term(x, k_eq, k_pole)
    return add_group_bias(out, bias_eq, bias_pole)


def _edge_taps(k):
    """(3, 3, Cin, D) -> (4, 3, Cin, D): the tap rows that meet each ghost
    strip, in [S, N, W, E] order: k[0], k[2], k[:, 0], k[:, 2]."""
    return torch.stack([k[0], k[2], k[:, 0], k[:, 2]], dim=0)


def _corner_taps(k):
    """(3, 3, Cin, D) -> (4, Cin, D) corner taps in [sw, se, nw, ne] order."""
    return torch.stack([k[0, 0], k[0, 2], k[2, 0], k[2, 2]], dim=0)


def _windows(ext):
    """``(..., n+2, C) -> (..., n, 3C)``: the three strip positions each
    along-edge position's fix reads."""
    n, cin = ext.shape[-2] - 2, ext.shape[-1]
    win = torch.stack([ext[..., 0:n, :], ext[..., 1 : n + 1, :], ext[..., 2 : n + 2, :]], dim=-2)
    return win.reshape(tuple(ext.shape[:-2]) + (n, 3 * cin))


def _corner_ghosts(ext):
    """``(B, F, 2 or 4, n+2, C) -> (B, F, 4, C)``: the ends of the S and N
    strips, the corner ghosts, in [sw, se, nw, ne] order."""
    last = ext.shape[3] - 1
    return torch.stack(
        [ext[:, :, EDGE_S, 0], ext[:, :, EDGE_S, last],
         ext[:, :, EDGE_N, 0], ext[:, :, EDGE_N, last]],
        dim=2,
    )


def ring_contract(sn, we, k_eq, k_pole):
    """The ring fixes of an ``(H, W)`` block's ghost strips, in the strips'
    dtype: ``sn`` (B, 6, 2, W+2, C) the corner-extended [S, N] strips and
    ``we`` (B, 6, 2, H+2, C) the [W, E] strips (each at positions 1..H),
    contracted per weight group with the outside tap rows of the HWIO
    kernels (3, 3, C, D), cast to the strips' dtype, and the corner ghosts
    (the ends of ``sn``) with the corner taps.  Returns ``fix_sn`` (B, 6, 2,
    W, D), ``fix_we`` (B, 6, 2, H, D) and ``corners`` (B, 6, 4, D) in [sw,
    se, nw, ne] order."""
    cin = sn.shape[-1]
    win_sn, win_we, ghosts = _windows(sn), _windows(we), _corner_ghosts(sn)
    fix_sn, fix_we, corners = [], [], []
    for faces, k in ((slice(0, 4), k_eq), (slice(4, 6), k_pole)):
        k = k.to(sn.dtype)
        taps = _edge_taps(k).reshape(4, 3 * cin, -1)
        fix_sn.append(torch.einsum("bfenk,ekd->bfend", win_sn[:, faces], taps[:2]))
        fix_we.append(torch.einsum("bfenk,ekd->bfend", win_we[:, faces], taps[2:]))
        corners.append(torch.einsum("bfec,ecd->bfed", ghosts[:, faces], _corner_taps(k)))
    return torch.cat(fix_sn, dim=1), torch.cat(fix_we, dim=1), torch.cat(corners, dim=1)


def ring_apply(base, fix_sn, fix_we, corners):
    """Masked perimeter add in the fixes' dtype on an ``(H, W)`` block
    ``base`` (B, 6, H, W, D) (or a scalar): ``fix_sn`` (B, 6, 2, W, D) on
    rows 0 and H-1, ``fix_we`` (B, 6, 2, H, D) on columns 0 and W-1, the
    ``corners`` (B, 6, 4, D) in [sw, se, nw, ne] order subtracted."""
    h, w = fix_we.shape[3], fix_sn.shape[3]
    row = torch.arange(h, device=fix_sn.device)[None, None, :, None, None]
    col = torch.arange(w, device=fix_sn.device)[None, None, None, :, None]
    zero = torch.zeros((), dtype=fix_sn.dtype, device=fix_sn.device)
    fix_s, fix_n = fix_sn.unbind(2)
    fix_w, fix_e = fix_we.unbind(2)
    c_sw, c_se, c_nw, c_ne = corners.unbind(2)
    assert (EDGE_S, EDGE_N, EDGE_W, EDGE_E) == (0, 1, 2, 3)
    return (
        base
        + torch.where(row == 0, fix_s[:, :, None, :, :], zero)
        + torch.where(row == h - 1, fix_n[:, :, None, :, :], zero)
        + torch.where(col == 0, fix_w[:, :, :, None, :], zero)
        + torch.where(col == w - 1, fix_e[:, :, :, None, :], zero)
        - torch.where((row == 0) & (col == 0), c_sw[:, :, None, None, :], zero)
        - torch.where((row == 0) & (col == w - 1), c_se[:, :, None, None, :], zero)
        - torch.where((row == h - 1) & (col == 0), c_nw[:, :, None, None, :], zero)
        - torch.where((row == h - 1) & (col == w - 1), c_ne[:, :, None, None, :], zero)
    )


def ring_term(x, k_eq, k_pole):
    """The halo correction: everything of the CS conv except the per-face
    zero-padded SAME convs and the bias, in ``x``'s dtype
    (``cs_conv3x3_ringfix == same convs + ring_term + bias``)."""
    ext = ext_strips(x)  # (B, 6, 4, n+2, C); ends are the corner ghosts
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return ring_apply(zero, *ring_contract(ext[:, :, :2], ext[:, :, 2:], k_eq, k_pole))
