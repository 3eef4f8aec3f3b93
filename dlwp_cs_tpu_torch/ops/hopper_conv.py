"""Fused halo-pad + 3x3 cubed-sphere conv and its backward: the Hopper
kernels, their plain versions, their wrappers and the autograd function.

The counterpart of ``dlwp_cs_tpu.ops.pallas_conv`` with its ``"fused"``
backward.  Three CUDA kernels replace the Pallas kernels; each source's
header says what bounds it and how:

* ``csrc/cs_conv3x3.cu``: the forward ``_kernel`` in all of its launch
  shapes: whole faces and row bands (#1, #2), and a shard's local row band
  (#8) or tile (#9) of the spatially decomposed path, whose ghost strips
  :mod:`dlwp_cs_tpu_torch.parallel` exchanges before the launch;
* ``csrc/cs_conv3x3_bwd.cu``: ``_bwd_dx_kernel`` (the input cotangent: dx's
  interior and the ghost-strip cotangent ``d_ext``) and ``_bwd_dw_kernel``
  (the weight and bias gradients, as per-block partial sums that a fixed-order
  ``torch.sum`` reduces).

Beside each kernel:

* a plain-torch version of the same function (:func:`cs_conv3x3_plain`,
  :func:`cs_conv3x3_dx_plain`, :func:`cs_conv3x3_dw_plain`), which CPU
  tensors take; on the card it is only the comparison in ``chip_smoke.py``;
* a wrapper (:data:`cs_conv3x3`, :data:`cs_conv3x3_dx`,
  :data:`cs_conv3x3_dw`; :data:`cs_conv3x3_band` and :data:`cs_conv3x3_tile`
  launch the forward kernel on a shard's block and count apart).  On a CPU
  tensor it returns the plain version; on a CUDA tensor it launches the
  kernel or raises, and counts the launch in its ``launches``.

:func:`cs_conv3x3_fused` is the differentiable conv: a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the two backward kernels.  Its ``ext`` input is
:func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips` of ``x``, whose own backward
(the scatter-free Eᵀ) folds ``d_ext`` into ``x``'s gradient.

Each kernel source is built and bound by
:mod:`~dlwp_cs_tpu_torch.ops.cuda_build` at its first CUDA use.
"""

from __future__ import annotations

import math

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

__all__ = [
    "cs_conv3x3",
    "cs_conv3x3_band",
    "cs_conv3x3_dw",
    "cs_conv3x3_dw_plain",
    "cs_conv3x3_dx",
    "cs_conv3x3_dx_plain",
    "cs_conv3x3_fused",
    "cs_conv3x3_plain",
    "cs_conv3x3_tile",
    "dw_plan",
    "tile_plan",
]

# Register tile of one thread and the block-size cap (csrc/cs_conv3x3.cu;
# the dx kernel of csrc/cs_conv3x3_bwd.cu uses the same).
_PX, _CO, _MAX_THREADS = 4, 8, 256
# The dx kernel's widest channel slice: a block stages 9 x 16 x cs weights
# per chunk, so a wider slice (up to 256 at Cin = 192) fills shared memory
# with weights, leaves one block per SM and spends the block's time
# staging them for a single frame row.
_DX_MAX_CS = 64
# The dw kernel's block tile: input and output channels per block
# (csrc/cs_conv3x3_bwd.cu); the face rows it stages at a time (4: 44 KB of
# shared memory at n=48, five blocks per SM) and the blocks per SM its grid
# aims at, so that other blocks compute while one waits on its staging.
_DW_CI, _DW_CO, _DW_ROWS, _DW_BLOCKS_PER_SM = 16, 32, 4, 8


def _padded_faces(x, ext):
    """``(B, 6, H+2, W+2, C)``: the block x ``(B, 6, H, W, C)`` framed by
    its ghost rows and columns (ext ``(B, 6, 4, W+2, C)``, W/E at 1..H)."""
    rows = x.shape[2]
    mid = torch.cat(
        [ext[:, :, 2, 1 : rows + 1, None], x, ext[:, :, 3, 1 : rows + 1, None]], dim=3
    )
    return torch.cat([ext[:, :, 0, None], mid, ext[:, :, 1, None]], dim=2)


_GROUPS = (slice(0, 4), slice(4, 6))  # equatorial, polar faces


def cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole):
    """Plain-torch fused CS conv: ``(B, 6, H, W, Cin) -> (B, 6, H, W, Cout)``.

    ``x`` is whole faces (H = W = n, ``ext`` is
    :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips` of ``x``) or a shard's
    local block (H <= W) with its exchanged ghost strips ``ext`` ``(B, 6, 4,
    W+2, Cin)``: S/N rows corner-extended, W/E columns at positions 1..H.
    Kernels and biases are rounded to ``x``'s dtype, the taps summed in
    ``promote_types(x.dtype, float32)`` (float32 for float32 and bfloat16
    inputs, float64 for a float64 reference) and the result cast once to
    ``x``'s dtype.
    """
    rows, cols = x.shape[2], x.shape[3]
    dt = x.dtype
    acc_dt = torch.promote_types(dt, torch.float32)
    p = _padded_faces(x, ext).to(acc_dt)
    parts = []
    for k, bias, faces in ((k_eq, b_eq, _GROUPS[0]), (k_pole, b_pole, _GROUPS[1])):
        kf = k.to(dt).to(acc_dt)
        acc = sum(
            torch.einsum("bfijc,cd->bfijd", p[:, faces, dy : dy + rows, dx : dx + cols],
                         kf[dy, dx])
            for dy in range(3)
            for dx in range(3)
        )
        parts.append(acc + bias.to(dt).to(acc_dt))
    return torch.cat(parts, dim=1).to(dt)


def _dx_frame_plain(dout, k_eq, k_pole):
    """``(B, 6, n+2, n+2, Cin)``: the padded-input cotangent ``dxp[a, b] =
    sum_{dy,dx} K_g[dy,dx] dout[a-dy, b-dx]`` of ``dout`` ``(B, 6, n, n,
    Cout)``, summed in ``promote_types(dout.dtype, float32)`` and rounded
    once to ``dout``'s dtype."""
    n = dout.shape[2]
    dt = dout.dtype
    acc_dt = torch.promote_types(dt, torch.float32)
    q = F.pad(dout.to(acc_dt), (0, 0, 2, 2, 2, 2))  # (B, 6, n+4, n+4, Cout)
    parts = []
    for k, faces in ((k_eq, _GROUPS[0]), (k_pole, _GROUPS[1])):
        kf = k.to(dt).to(acc_dt)
        parts.append(sum(
            torch.einsum(
                "bfijd,cd->bfijc",
                q[:, faces, 2 - dy : n + 4 - dy, 2 - dx : n + 4 - dx], kf[dy, dx],
            )
            for dy in range(3)
            for dx in range(3)
        ))
    return torch.cat(parts, dim=1).to(dt)


def cs_conv3x3_dx_plain(dout, k_eq, k_pole):
    """Plain-torch input cotangent of the fused conv.

    ``dout`` ``(B, 6, n, n, Cout)``, kernels ``(3, 3, Cin, Cout)`` of its
    dtype.  The padded-input cotangent ``dxp`` (:func:`_dx_frame_plain`)
    over the ``(n+2)^2`` frame is returned split as ``(dx, d_ext)``: dx
    ``(B, 6, n, n, Cin)`` is its interior, ``d_ext`` ``(B, 6, 4, n+2, Cin)``
    its ring as ghost-strip cotangents: rows S and N whole (corners
    included), columns W and E at rows 1..n with both ends zero, since the
    forward reads W/E only there.
    """
    n = dout.shape[2]
    dxp = _dx_frame_plain(dout, k_eq, k_pole)  # (B, 6, n+2, n+2, Cin)
    w_col, e_col = dxp[:, :, :, 0].clone(), dxp[:, :, :, n + 1].clone()
    for col in (w_col, e_col):
        col[:, :, 0] = 0
        col[:, :, n + 1] = 0
    d_ext = torch.stack([dxp[:, :, 0], dxp[:, :, n + 1], w_col, e_col], dim=2)
    return dxp[:, :, 1 : n + 1, 1 : n + 1].contiguous(), d_ext


def cs_conv3x3_dw_plain(x, ext, dout):
    """Plain-torch weight and bias gradients of the fused conv, in
    ``promote_types(x.dtype, float32)`` (f32 for f32 and bf16 inputs).

    ``dK_g[dy, dx] = sum_{b, f in g, i, j} P[i+dy, j+dx] (x) dout[i, j]``
    over the padded faces ``P`` (as the forward reads them) and
    ``db_g = sum dout``; returns ``(dk_eq, dk_pole, db_eq, db_pole)``.
    """
    n = x.shape[2]
    acc_dt = torch.promote_types(x.dtype, torch.float32)
    p = _padded_faces(x, ext).to(acc_dt)
    d = dout.to(x.dtype).to(acc_dt)
    out = []
    for faces in _GROUPS:
        out.append(torch.stack([
            torch.stack([
                torch.einsum("bfijc,bfijd->cd", p[:, faces, dy : dy + n, dx : dx + n],
                             d[:, faces])
                for dx in range(3)
            ])
            for dy in range(3)
        ]))
    db = [d[:, faces].sum(dim=(0, 1, 2, 3)) for faces in _GROUPS]
    return out[0], out[1], db[0], db[1]


def tile_plan(b: int, rows: int, cols: int, cout: int, sm_count: int,
              max_cs: int | None = None):
    """``(h, cs)``: output rows and output channels per block, for a block
    of ``rows x cols`` cells of each of ``b * 6`` faces.

    A block holds at most 256 threads of ``4 x 8`` (pixels x channels)
    register tiles.  ``cs`` is the widest power-of-two channel slice (at
    most ``max_cs``) that lets one row fit a block; ``h`` the most rows that
    fit, lowered until the grid holds two blocks per SM where the batch is
    small (batch-1 serving).  The dx kernel plans its ``(n+2)^2`` frame with
    the same function, its slices capped at ``_DX_MAX_CS``.
    """
    ncg = -(-cols // _PX)
    if ncg > _MAX_THREADS:
        raise ValueError(f"a block {cols} columns wide is too large for the conv kernel")
    widest = 1 << ((_CO * (_MAX_THREADS // ncg)).bit_length() - 1)
    if max_cs is not None:
        widest = min(widest, max_cs)
    cs = min(1 << (max(cout, _CO) - 1).bit_length(), widest)
    per_row = ncg * (cs // _CO)
    nslices = -(-cout // cs)
    h = min(rows, _MAX_THREADS // per_row)
    while h > 1 and math.ceil(rows / h) * nslices * 6 * b < 2 * sm_count:
        h -= 1
    return h, cs


def dw_plan(b: int, n: int, cin: int, cout: int, sm_count: int):
    """``(rows, nsplit)`` of the dw kernel: face rows staged at a time, and
    reduction slices per face group.

    The grid has ``ceil(Cin/16) * ceil(Cout/32)`` channel tiles per group,
    each summing over ``nsplit`` contiguous slices of the group's (batch,
    face, row chunk) items; ``nsplit`` is raised until the grid holds
    ``_DW_BLOCKS_PER_SM`` blocks per SM, and never past the polar group's
    item count.  The partial sums take ``nsplit * 2 * 9 * Cin * Cout``
    floats (at most 20 MB at the flagship's batch-16 shapes).
    """
    rows = min(n, _DW_ROWS)
    tiles = 2 * -(-cin // _DW_CI) * -(-cout // _DW_CO)
    polar_items = b * 2 * -(-n // rows)
    return rows, max(1, min(polar_items, -(-_DW_BLOCKS_PER_SM * sm_count // tiles)))


_FWD_LIB = CudaLibrary("cs_conv3x3.cu", {
    "cs_conv3x3_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
}, "cs_conv3x3_error_string")
_BWD_LIB = CudaLibrary("cs_conv3x3_bwd.cu", {
    "cs_conv3x3_dx_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
    # kernel #14, the raw-ring instance (ops/conv_variants.py)
    "cs_conv3x3_dx_ring_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
    "cs_conv3x3_dw_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
}, "cs_conv3x3_bwd_error_string")


class _Conv3x3Kernel(KernelWrapper):
    def __call__(self, x, ext, k_eq, k_pole, b_eq, b_pole):
        """Fused CS conv of ``x`` (B, 6, H, W, Cin), whole faces (H = W = n,
        ``ext`` :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips` of ``x``) or a
        shard's block (H <= W) with its exchanged ghost strips ``ext`` (B, 6,
        4, W+2, Cin); HWIO kernels (3, 3, Cin, Cout) and biases (Cout,), all
        of ``x``'s dtype.  Returns (B, 6, H, W, Cout); see
        :func:`cs_conv3x3_plain`."""
        if x.device.type == "cpu":
            return cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole)
        check_faces(self.name, x)
        b, _, rows, cols, cin = x.shape
        if rows > cols:
            raise ValueError(
                f"{self.name}: a block of {rows} rows x {cols} columns; the W/E "
                "ghost columns ride in the (W+2) ext strips, so H <= W"
            )
        cout = k_eq.shape[-1]
        check_cuda_args(self.name, x, {
            "x": (x, (b, 6, rows, cols, cin)),
            "ext": (ext, (b, 6, 4, cols + 2, cin)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
            "b_eq": (b_eq, (cout,)),
            "b_pole": (b_pole, (cout,)),
        })
        dev = self._device(x)
        h, cs = tile_plan(b, rows, cols, cout, self._sm_count[dev])
        out = torch.empty((b, 6, rows, cols, cout), dtype=x.dtype, device=x.device)
        self._launch(
            "cs_conv3x3_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, k_eq, k_pole, b_eq, b_pole, out)),
            b, rows, cols, cin, cout, h, cs, sizes=7,
        )
        return out


class _Conv3x3DxKernel(KernelWrapper):
    def __call__(self, dout, k_eq, k_pole):
        """Input cotangent of the fused conv: ``dout`` (B, 6, n, n, Cout) and
        HWIO kernels (3, 3, Cin, Cout) of its dtype -> ``(dx, d_ext)``, see
        :func:`cs_conv3x3_dx_plain`."""
        if dout.device.type == "cpu":
            return cs_conv3x3_dx_plain(dout, k_eq, k_pole)
        check_faces("cs_conv3x3_dx", dout)
        b, _, n, _, cout = dout.shape
        cin = k_eq.shape[2]
        check_cuda_args("cs_conv3x3_dx", dout, {
            "dout": (dout, (b, 6, n, n, cout)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
        })
        dev = self._device(dout)
        h, cs = tile_plan(b, n + 2, n + 2, cin, self._sm_count[dev], max_cs=_DX_MAX_CS)
        dx = torch.empty((b, 6, n, n, cin), dtype=dout.dtype, device=dout.device)
        d_ext = torch.empty((b, 6, 4, n + 2, cin), dtype=dout.dtype, device=dout.device)
        self._launch(
            "cs_conv3x3_dx_launch", dev, DTYPES[dout.dtype], dev,
            *(t.data_ptr() for t in (dout, k_eq, k_pole, dx, d_ext)),
            b, n, cin, cout, h, cs,
        )
        return dx, d_ext


class _Conv3x3DwKernel(KernelWrapper):
    def __call__(self, x, ext, dout):
        """Weight and bias gradients of the fused conv, f32: ``x`` (B, 6, n,
        n, Cin), its ghost strips ``ext`` and ``dout`` (B, 6, n, n, Cout), all
        of one dtype -> ``(dk_eq, dk_pole, db_eq, db_pole)``, see
        :func:`cs_conv3x3_dw_plain`.  The kernel writes per-block partial
        sums; ``torch.sum`` reduces them in a fixed order, so the result does
        not change from run to run."""
        if x.device.type == "cpu":
            return cs_conv3x3_dw_plain(x, ext, dout)
        check_faces("cs_conv3x3_dw", x)
        b, _, n, _, cin = x.shape
        cout = dout.shape[-1]
        check_cuda_args("cs_conv3x3_dw", x, {
            "x": (x, (b, 6, n, n, cin)),
            "ext": (ext, (b, 6, 4, n + 2, cin)),
            "dout": (dout, (b, 6, n, n, cout)),
        })
        dev = self._device(x)
        rows, nsplit = dw_plan(b, n, cin, cout, self._sm_count[dev])
        f32 = dict(dtype=torch.float32, device=x.device)
        dk_part = torch.empty((nsplit, 2, 3, 3, cin, cout), **f32)
        db_part = torch.empty((nsplit, 2, cout), **f32)
        self._launch(
            "cs_conv3x3_dw_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, dout, dk_part, db_part)),
            b, n, cin, cout, rows, nsplit,
        )
        dk, db = dk_part.sum(dim=0), db_part.sum(dim=0)
        return dk[0], dk[1], db[0], db[1]


cs_conv3x3 = _Conv3x3Kernel("cs_conv3x3", _FWD_LIB)
# kernels #8 (a row band) and #9 (a tile): the same kernel, counted apart
cs_conv3x3_band = _Conv3x3Kernel("cs_conv3x3_band", _FWD_LIB)
cs_conv3x3_tile = _Conv3x3Kernel("cs_conv3x3_tile", _FWD_LIB)
cs_conv3x3_dx = _Conv3x3DxKernel("cs_conv3x3_dx", _BWD_LIB)
cs_conv3x3_dw = _Conv3x3DwKernel("cs_conv3x3_dw", _BWD_LIB)


class _FusedConv3x3(torch.autograd.Function):
    """Forward on :data:`cs_conv3x3`, backward on :data:`cs_conv3x3_dx` and
    :data:`cs_conv3x3_dw` (or their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, ext, k_eq, k_pole, b_eq, b_pole):
        ctx.save_for_backward(x, ext, k_eq, k_pole)
        ctx.bias_dtypes = (b_eq.dtype, b_pole.dtype)
        return cs_conv3x3(x, ext, k_eq, k_pole, b_eq, b_pole)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, ext, k_eq, k_pole = ctx.saved_tensors
        need = ctx.needs_input_grad
        # the reference casts the cotangent to x's dtype; the backward of a
        # skip concat hands it over as a non-contiguous view
        g = g.to(x.dtype).contiguous()
        dx = d_ext = dk_eq = dk_pole = db_eq = db_pole = None
        if need[0] or need[1]:
            dx, d_ext = cs_conv3x3_dx(g, k_eq, k_pole)
        if any(need[2:]):
            dk_eq, dk_pole, db_eq, db_pole = cs_conv3x3_dw(x, ext, g)
            # f32 sums rounded once to the parameters' (compute) dtype
            dk_eq, dk_pole = dk_eq.to(k_eq.dtype), dk_pole.to(k_pole.dtype)
            db_eq, db_pole = db_eq.to(ctx.bias_dtypes[0]), db_pole.to(ctx.bias_dtypes[1])
        grads = (dx, d_ext, dk_eq, dk_pole, db_eq, db_pole)
        return tuple(gr if nd else None for gr, nd in zip(grads, need))


def cs_conv3x3_fused(x, ext, k_eq, k_pole, b_eq, b_pole):
    """Differentiable fused CS conv; arguments as :data:`cs_conv3x3`.

    Pass ``ext = ext_strips(x)`` so that the ghost-strip cotangent reaches
    ``x`` through Eᵀ.  The backward launches the dx kernel only when ``x``
    or ``ext`` needs a gradient (not for a model's input data).
    """
    return _FusedConv3x3.apply(x, ext, k_eq, k_pole, b_eq, b_pole)
