"""The xring cubed-sphere conv: cuDNN SAME convs + a hand-written ring-fix
kernel, and its backward.

The counterpart of ``dlwp_cs_tpu.ops.ring_kernel``::

    cs_conv3x3_xring(x, ...) = xring_fused_apply(same_conv(x, k_eq),
                                                 same_conv(x, k_pole),
                                                 ext_strips(x)) + bias

Two CUDA kernels (``csrc/cs_ring.cu``, whose header says what bounds them)
replace the Pallas kernels:

* :data:`ring_fixes` (``_ring_kernel``): the per-edge fixes and the corner
  corrections from the ghost strips, each rounded to the input dtype;
  :func:`ring_apply` adds them (the [S, N] and [W, E] pairs) onto a base
  in that dtype;
* :data:`xring_fused_apply` (``_fused_kernel``): the face select of the two
  SAME-conv bases, the fixes on the boundary ring and the corners
  subtracted, one f32 sum rounded once.

Beside each, its plain-torch version (:func:`ring_fixes_plain`,
:func:`xring_fused_apply_plain`), which CPU tensors take; on a CUDA tensor
the wrapper launches the kernel or raises, and counts the launch in its
``launches``.

:func:`cs_conv3x3_xring` is a ``torch.autograd.Function``.  Its backward
is :func:`split_vjp` (the default: the SAME convs' VJP on the split base,
the ring's transpose and Eᵀ, in plain torch; the reference has no backward
kernel here) or autograd through
:func:`~dlwp_cs_tpu_torch.ops.ringfix.cs_conv3x3_ringfix`
(``backward="ringfix"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dlwp_cs_tpu_torch.ops.cuda_build import (
    DTYPES,
    I32,
    VP,
    CudaLibrary,
    KernelWrapper,
    check_cuda_args,
    check_faces,
)
from dlwp_cs_tpu_torch.ops.halo import _ext_transpose, ext_strips
from dlwp_cs_tpu_torch.ops.ringfix import (
    _corner_ghosts,
    _corner_taps,
    _edge_taps,
    _same_conv,
    _same_conv_vjp,
    _windows,
    add_group_bias,
    cs_conv3x3_ringfix,
    face_select,
    ring_apply,
    ring_contract,
)

__all__ = [
    "cs_conv3x3_xring",
    "ring_apply",
    "ring_fixes",
    "ring_fixes_plain",
    "split_vjp",
    "xring_fused_apply",
    "xring_fused_apply_plain",
]

# Output tile side of the fused kernel and edge chunk of the fixes kernel:
# 36 tiles per face at n=48 (216 blocks at batch 1), of which 20 hold a
# boundary line.
_TILE = 8
_GROUPS = (slice(0, 4), slice(4, 6))  # equatorial, polar faces


def _fix_terms(ext, k_eq, k_pole):
    """f32 ``(fixes (B, 6, 4, n, D), corners (B, 6, 4, D))`` from the ghost
    strips and the kernels rounded to ``ext``'s dtype."""
    e32 = ext.float()
    fix_sn, fix_we, corners = ring_contract(e32[:, :, :2], e32[:, :, 2:],
                                            k_eq.to(ext.dtype), k_pole.to(ext.dtype))
    return torch.cat([fix_sn, fix_we], dim=2), corners


def ring_fixes_plain(ext, k_eq, k_pole):
    """Plain-torch ring fixes: ``ext`` (B, 6, 4, n+2, Cin) from
    :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips`, HWIO kernels (3, 3, Cin,
    D) -> ``(fixes, corners)``, (B, 6, 4, n, D) in [S, N, W, E] edge order
    and (B, 6, 4, D) in [sw, se, nw, ne] corner order: f32 sums of
    ``ext``-dtype values, each rounded once to ``ext``'s dtype."""
    fixes, corners = _fix_terms(ext, k_eq, k_pole)
    return fixes.to(ext.dtype), corners.to(ext.dtype)


def xring_fused_apply_plain(base_eq, base_po, ext, k_eq, k_pole):
    """Plain-torch fused select + ring correction: ``base_*`` (B, 6, n, n,
    D) the two SAME-conv outputs, ``ext`` their input's ghost strips.
    ``select(base) + S|row 0 + N|row n-1 + W|col 0 + E|col n-1 - sw - se -
    nw - ne``, summed in f32 in that order and rounded once to
    ``base_eq``'s dtype."""
    n = base_eq.shape[2]
    fixes, cor = _fix_terms(ext, k_eq, k_pole)
    acc = face_select(base_eq, base_po).to(torch.float32, copy=True)
    acc[:, :, 0] += fixes[:, :, 0]
    acc[:, :, n - 1] += fixes[:, :, 1]
    acc[:, :, :, 0] += fixes[:, :, 2]
    acc[:, :, :, n - 1] += fixes[:, :, 3]
    acc[:, :, 0, 0] -= cor[:, :, 0]
    acc[:, :, 0, n - 1] -= cor[:, :, 1]
    acc[:, :, n - 1, 0] -= cor[:, :, 2]
    acc[:, :, n - 1, n - 1] -= cor[:, :, 3]
    return acc.to(base_eq.dtype)


_RING_LIB = CudaLibrary("cs_ring.cu", {
    "cs_ring_fixes_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
    "cs_xring_apply_launch": [I32, I32] + [VP] * 6 + [I32] * 6 + [VP],
}, "cs_ring_error_string")


def _strips_shape(name, ext, k_eq, k_pole):
    """Check the CUDA arguments; ``(b, n, cin, d, k_eq, k_pole)`` with the
    kernels rounded to ``ext``'s dtype, as the kernels read them."""
    check_faces(name, ext, strips=True)
    b, _, _, np2, cin = ext.shape
    d = k_eq.shape[-1]
    k_eq = k_eq.to(ext.dtype).contiguous()
    k_pole = k_pole.to(ext.dtype).contiguous()
    check_cuda_args(name, ext, {
        "ext": (ext, (b, 6, 4, np2, cin)),
        "k_eq": (k_eq, (3, 3, cin, d)),
        "k_pole": (k_pole, (3, 3, cin, d)),
    })
    return b, np2 - 2, cin, d, k_eq, k_pole


class _RingFixesKernel(KernelWrapper):
    def __call__(self, ext, k_eq, k_pole):
        """Ring fixes and corners of the ghost strips ``ext`` (B, 6, 4, n+2,
        Cin) with HWIO kernels (3, 3, Cin, D), see :func:`ring_fixes_plain`."""
        if ext.device.type == "cpu":
            return ring_fixes_plain(ext, k_eq, k_pole)
        b, n, cin, d, k_eq, k_pole = _strips_shape("ring_fixes", ext, k_eq, k_pole)
        dev = self._device(ext)
        fixes = torch.empty((b, 6, 4, n, d), dtype=ext.dtype, device=ext.device)
        corners = torch.empty((b, 6, 4, d), dtype=ext.dtype, device=ext.device)
        self._launch(
            "cs_ring_fixes_launch", dev, DTYPES[ext.dtype], dev,
            *(t.data_ptr() for t in (ext, k_eq, k_pole, fixes, corners)),
            b, n, cin, d, _TILE, 0,
        )
        return fixes, corners


class _XringApplyKernel(KernelWrapper):
    def __call__(self, base_eq, base_po, ext, k_eq, k_pole):
        """Fused select + ring correction of the SAME-conv outputs
        ``base_*`` (B, 6, n, n, D) with the ghost strips ``ext`` (B, 6, 4,
        n+2, Cin) of their input, see :func:`xring_fused_apply_plain`."""
        if base_eq.device.type == "cpu":
            return xring_fused_apply_plain(base_eq, base_po, ext, k_eq, k_pole)
        check_faces("xring_fused_apply", base_eq)
        b, n, cin, d, k_eq, k_pole = _strips_shape("xring_fused_apply", ext, k_eq, k_pole)
        check_cuda_args("xring_fused_apply", ext, {
            "base_eq": (base_eq, (b, 6, n, n, d)),
            "base_po": (base_po, (b, 6, n, n, d)),
        })
        dev = self._device(ext)
        out = torch.empty_like(base_eq)
        # 16-byte accesses where D and the bases' addresses allow
        vec = 16 // ext.element_size()
        if d % vec or any(t.data_ptr() % 16 for t in (base_eq, base_po, out)):
            vec = 1
        self._launch(
            "cs_xring_apply_launch", dev, DTYPES[ext.dtype], dev,
            *(t.data_ptr() for t in (base_eq, base_po, ext, k_eq, k_pole, out)),
            b, n, cin, d, _TILE, vec,
        )
        return out


ring_fixes = _RingFixesKernel("ring_fixes", _RING_LIB)
xring_fused_apply = _XringApplyKernel("xring_fused_apply", _RING_LIB)


def _xring_forward(x, k_eq, k_pole, b_eq, b_pole):
    # the dual base: two full 6-face SAME convs, the select in the kernel
    out = xring_fused_apply(_same_conv(x, k_eq), _same_conv(x, k_pole), ext_strips(x),
                            k_eq, k_pole)
    return add_group_bias(out, b_eq, b_pole)


def _boundary_cotangents(g):
    """Cotangents of (fixes, corners) under :func:`ring_apply`: the fix
    strips receive g's boundary lines (+), the corners g's corner cells (-)."""
    n = g.shape[2]
    d_fix = torch.stack(
        [g[:, :, 0, :, :], g[:, :, n - 1, :, :], g[:, :, :, 0, :], g[:, :, :, n - 1, :]],
        dim=2,
    )  # (B, 6, 4, n, D) in [S, N, W, E] order
    d_cor = -torch.stack(
        [g[:, :, 0, 0], g[:, :, 0, n - 1], g[:, :, n - 1, 0], g[:, :, n - 1, n - 1]],
        dim=2,
    )  # (B, 6, 4, D) in [sw, se, nw, ne] order
    return d_fix, d_cor


def _ring_transpose(ext, d_fix, d_cor, k_eq, k_pole):
    """Transpose of ``(ext, taps) -> (fixes, corners)`` in ``ext``'s dtype:
    ``(d_ext, dk_eq, dk_pole)``, the kernel cotangents (3, 3, Cin, D) of the
    ring's taps only (the SAME convs' dk adds separately).  The window
    transpose is three shifted zero-pads."""
    b, _, _, np2, cin = ext.shape
    n = np2 - 2
    d = d_fix.shape[-1]
    dt = ext.dtype
    d_fix = d_fix.to(dt)
    d_cor = d_cor.to(dt)
    d_ext_groups, dk_ring = [], []
    for faces, k in zip(_GROUPS, (k_eq, k_pole)):
        taps = _edge_taps(k).reshape(4, 3 * cin, d).to(dt)
        dfg = d_fix[:, faces]  # (B, F, 4, n, D)
        nf = dfg.shape[1]
        d_win = torch.einsum("bfend,ekd->bfenk", dfg, taps).reshape(b, nf, 4, n, 3, cin)
        # strip position s receives d_win[t, dy] for every t + dy == s
        d_ext_g = (
            F.pad(d_win[..., 0, :], (0, 0, 0, 2))
            + F.pad(d_win[..., 1, :], (0, 0, 1, 1))
            + F.pad(d_win[..., 2, :], (0, 0, 2, 0))
        )  # (B, F, 4, n+2, C)
        # corners: the ends of the S/N strips fed the corner dots
        ck = _corner_taps(k).to(dt)  # (4, C, D)
        dcg = d_cor[:, faces]  # (B, F, 4, D)
        sw, se, nw, ne = torch.einsum("bfed,ecd->bfec", dcg, ck).unbind(2)
        s_line = F.pad(sw[:, :, None], (0, 0, 0, n + 1)) + F.pad(se[:, :, None], (0, 0, n + 1, 0))
        n_line = F.pad(nw[:, :, None], (0, 0, 0, n + 1)) + F.pad(ne[:, :, None], (0, 0, n + 1, 0))
        zeros = torch.zeros_like(s_line)
        d_ext_groups.append(d_ext_g + torch.stack([s_line, n_line, zeros, zeros], dim=2))

        # tap gradients of the ring part: per batch item, then summed
        eg = ext[:, faces]
        win = _windows(eg)
        d_taps = torch.einsum("bfenk,bfend->bekd", win, dfg).sum(dim=0)
        d_s, d_n, d_w, d_e = d_taps.reshape(4, 3, cin, d).unbind(0)
        dsw, dse, dnw, dne = torch.einsum("bfec,bfed->ecd", _corner_ghosts(eg), dcg).unbind(0)
        z = torch.zeros_like(d_s[0])
        row0 = torch.stack([d_s[0] + d_w[0] + dsw, d_s[1], d_s[2] + d_e[0] + dse])
        row1 = torch.stack([d_w[1], z, d_e[1]])
        row2 = torch.stack([d_n[0] + d_w[2] + dnw, d_n[1], d_n[2] + d_e[2] + dne])
        dk_ring.append(torch.stack([row0, row1, row2], dim=0))
    return torch.cat(d_ext_groups, dim=1), dk_ring[0], dk_ring[1]


def split_vjp(x, k_eq, k_pole, b_eq, b_pole, g):
    """VJP of the CS conv's linear map: the SAME convs' VJP on the split
    base (faces 0:4 with ``k_eq``, 4:6 with ``k_pole``), the ring's explicit
    transpose and Eᵀ.  Returns ``(dx, dk_eq, dk_pole, db_eq, db_pole)``; in
    bf16 the ring's dk is added to the SAME conv's in that dtype, as the
    reference does."""
    g = g.to(x.dtype)
    dx_eq, dk_eq_base = _same_conv_vjp(x[:, :4], k_eq, g[:, :4])
    dx_po, dk_po_base = _same_conv_vjp(x[:, 4:], k_pole, g[:, 4:])
    d_fix, d_cor = _boundary_cotangents(g)
    d_ext, dk_eq_ring, dk_po_ring = _ring_transpose(ext_strips(x), d_fix, d_cor, k_eq, k_pole)
    dx = torch.cat([dx_eq, dx_po], dim=1) + _ext_transpose(d_ext.contiguous())
    g32 = g.float()
    db_eq = g32[:, :4].sum(dim=(0, 1, 2, 3)).to(b_eq.dtype)
    db_po = g32[:, 4:].sum(dim=(0, 1, 2, 3)).to(b_pole.dtype)
    return (
        dx,
        dk_eq_base + dk_eq_ring.to(dk_eq_base.dtype),
        dk_po_base + dk_po_ring.to(dk_po_base.dtype),
        db_eq,
        db_po,
    )


class _XringConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_eq, k_pole, b_eq, b_pole, backward):
        ctx.save_for_backward(x, k_eq, k_pole, b_eq, b_pole)
        ctx.backward_mode = backward
        return _xring_forward(x, k_eq, k_pole, b_eq, b_pole)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.backward_mode == "split":
            return (*split_vjp(*saved, g), None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved]
            out = cs_conv3x3_ringfix(ins[0], ins[1], ins[2], bias_eq=ins[3], bias_pole=ins[4])
            return (*torch.autograd.grad(out, ins, g), None)


def cs_conv3x3_xring(x, k_eq, k_pole, b_eq, b_pole, backward: str = "split"):
    """CS conv, 3x3/stride-1, ``(B, 6, n, n, Cin) -> (B, 6, n, n, Cout)``:
    cuDNN SAME convs + the fused ring kernel.  The same map as
    ``cs_conv3x3_ringfix`` / ``cs_pad`` + VALID conv; kernels (3, 3, Cin,
    Cout) and biases (Cout,) are required (pass zeros), all of ``x``'s
    dtype.  ``backward``: ``"split"`` (:func:`split_vjp`) or ``"ringfix"``
    (autograd through ``cs_conv3x3_ringfix``)."""
    if backward not in ("split", "ringfix"):
        raise ValueError(f"unknown xring backward {backward!r}")
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    return _XringConv.apply(x.contiguous(), k_eq, k_pole, b_eq, b_pole, backward)
