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

All three run on the tensor cores in both dtypes, float32 as 3xTF32.  The
forward and dx kernels are an implicit GEMM on ``mma.sync``
(``csrc/cs_conv3x3_tile.cuh::tc_conv``) with the tiles, slices and walks of
:func:`tc_plan`, the forward's weights resident in shared memory or, where
they do not fit (the bfloat16 forward from Cin = 512), streamed with each
staged chunk (bitwise equal); the dw kernel is an implicit GEMM over the
pixels of a face group (:func:`dw_tc_plan`).  The CUDA-core instances they replaced
stay as timing rows (``ops/conv_variants.py``, planned by :func:`tile_plan`
and :func:`dw_plan`); no path of the port selects them.

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

The reference's backward-mode selector (:func:`use_pallas_backward`,
:func:`backward_mode`, :data:`BACKWARD_MODES`) is kept for its callers:
every mode runs this backward.  The reference's five modes are TPU
ablations of one linear map with the same gradients; the port's is its
``"fused"`` mode (the reference's default is ``"split"``).

Each kernel source is built and bound by
:mod:`~dlwp_cs_tpu_torch.ops.cuda_build` at its first CUDA use.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import heapq
import math
from typing import NamedTuple

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
    "BACKWARD_MODES",
    "backward_mode",
    "cs_conv3x3",
    "cs_conv3x3_band",
    "cs_conv3x3_dw",
    "cs_conv3x3_dw_plain",
    "cs_conv3x3_dx",
    "cs_conv3x3_dx_plain",
    "cs_conv3x3_fused",
    "cs_conv3x3_plain",
    "cs_conv3x3_tile",
    "dw_launch_args",
    "dw_plan",
    "dw_tc_blocks",
    "dw_tc_geom",
    "dw_tc_plan",
    "dx_plan_args",
    "fused_fits",
    "fwd_plan",
    "fwd_plan_args",
    "tc_blocks",
    "tc_geom",
    "tc_plan",
    "tile_plan",
    "use_pallas_backward",
]

# Register tile of one thread and the block-size cap of the CUDA-core
# kernels (the timing rows of ops/conv_variants.py).
_PX, _CO, _MAX_THREADS = 4, 8, 256
# The CUDA-core dx kernel's widest channel slice (a timing row): a block
# stages 9 x 16 x cs weights per chunk, so a wider slice (up to 256 at Cin =
# 192) fills shared memory with weights, leaves one block per SM and spends
# the block's time staging them for a single frame row.
_DX_MAX_CS = 64
# The tensor-core kernels (csrc/cs_conv3x3_tile.cuh::make_tc_geom): threads
# per block, 16-bit units after each staged cell, the shared memory a block
# may opt in to on an H100 and the per-SM share the occupancy reckoning
# takes (228 KB less 1 KB a block reserved by the runtime).
_TC_MAX_THREADS, _TC_PAD, _SMEM_LIMIT, _SMEM_PER_SM = 256, 8, 232448, 233472
# What tc_plan aims at: output pixels per tile (whole rows), the shared
# memory above which a block leaves no room for a second on its SM, and
# the blocks per SM the whole-grid walk keeps resident.
_TC_TILE_PX, _TC_SOFT_SMEM, _TC_BLOCKS_PER_SM = 128, 113 * 1024, 4
# The CUDA-core dw kernel's block tile (a timing row): input and output
# channels per block (csrc/cs_conv3x3_bwd.cu); the face rows it stages at a time (4: 44 KB of
# shared memory at n=48, five blocks per SM) and the blocks per SM its grid
# aims at, so that other blocks compute while one waits on its staging.
_DW_CI, _DW_CO, _DW_ROWS, _DW_BLOCKS_PER_SM = 16, 32, 4, 8
# The tensor-core dw kernel (csrc/cs_conv3x3_bwd.cu::make_dw_tc_geom):
# elements after each staged cell; the pixels an item aims at (whole face
# rows, 12 k16 steps at n = 48 and 24), the blocks per SM its grid aims at
# (two of 6 warps are resident; two waves), and the partial sums' cap.
_DWT_PAD, _DWT_ITEM_PX, _DWT_BLOCKS_PER_SM, _DWT_PARTIAL_BYTES = 8, 192, 4, 20 * 2**20
# Its float32 instance (3xTF32): ~194 registers a thread leave one block of
# 6 warps an SM (two of 3 warps where their shared memory allows); the
# pixels an item aims at, and what each block a resident slot runs adds to
# the time, as a share of the makespan (tools/tc_sweep.py --kind dw).
_DWF_ITEM_PX, _DWF_BLOCK_COST = 192, 0.02


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
    small (batch-1 serving).  The CUDA-core timing rows of
    ``ops/conv_variants.py`` take it (the dx row plans its ``(n+2)^2``
    frame with it, its slices capped at ``_DX_MAX_CS``).
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


class TcGeom(NamedTuple):
    """What ``csrc/cs_conv3x3_tile.cuh::make_tc_geom`` computes from a plan."""

    h: int  # output rows per tile
    cs: int  # output channels per slice
    nw: int  # n8 tiles per warp
    wn: int  # warps along N
    wm: int  # warps along M (2 m16 tiles each)
    threads: int
    nslices: int
    ntr: int  # row tiles per face
    kc: int  # reduced channels per staged chunk
    kp: int  # reduced channels, whole chunks
    smem: int  # bytes of shared memory per block
    stream: bool = False  # the weights streamed with each chunk, else resident


def _tc_warps_m(h: int, cols: int) -> int:
    """Warps along M of a tile of ``h`` rows: 2 m16 tiles (32 pixels) each."""
    return -(-(h * cols) // 32)


def tc_geom(rows: int, cols: int, kch: int, nch: int, h: int, cs: int, nw: int,
            dx: bool = False, esize: int = 2, stream: bool = False) -> TcGeom:
    """The tensor-core kernel's geometry for a tile of ``h`` rows of a
    ``rows x cols`` block (the dx kernel: of the ``(n+2)^2`` frame), ``kch``
    reduced and ``nch`` output channels of ``esize`` bytes (2: bfloat16, 4:
    float32), slices of ``cs`` channels and ``nw`` n8 tiles per warp, the
    weights resident or (``stream``) carried by each stage with its chunk;
    raises ``ValueError`` where the kernel does not take them (as
    ``make_tc_geom`` returns false).  ``kc``, ``kp`` and the staged sizes
    count 16-bit units: a float32 value takes two."""
    if not (1 <= h <= rows and cols >= 1 and kch >= 1 and nch >= 1):
        raise ValueError(f"tc_geom: h={h} rows of a {rows} x {cols} block, K={kch}, N={nch}")
    if cs not in (8, 16, 32, 64) or nw not in (1, 2, 4, 8) or 8 * nw > cs:
        raise ValueError(f"tc_geom: slice {cs} with {nw} n8 tiles per warp")
    if esize not in (2, 4) or (esize == 4 and nw > 4):
        raise ValueError(f"tc_geom: {esize}-byte elements with {nw} n8 tiles per warp")
    wn = cs // (8 * nw)
    wm = _tc_warps_m(h, cols)
    threads = 32 * wm * wn
    if threads > _TC_MAX_THREADS:
        raise ValueError(f"tc_geom: {threads} threads > {_TC_MAX_THREADS}")
    units = kch * esize // 2
    kc = 16 if units <= 16 else 32
    kp = -(-units // kc) * kc
    stage = (h + 2) * (cols + 2) * (kc + _TC_PAD)
    klen = kc if stream else kp  # units of K a tap holds in shared memory
    if dx or esize == 4:
        wsize = cs * (9 * klen + _TC_PAD)
    else:
        wsize = 9 * klen * (cs + (8 if (cs // 8) % 2 == 0 else 16))
    # the weights (resident, or two stages of a chunk's), two stages and,
    # in float32, the lo halves of one stage
    return TcGeom(h, cs, nw, wn, wm, threads, -(-nch // cs), -(-rows // h), kc, kp,
                  2 * ((2 if stream else 1) * wsize + (3 if esize == 4 else 2) * stage),
                  stream)


class TcPlan(NamedTuple):
    """A launch of the tensor-core kernel: its geometry, the tiles each
    block walks (``tpb``), the tiles and the blocks of the grid."""

    geom: TcGeom
    tpb: int
    tiles: int
    blocks: int

    def args(self):
        """``(h, cs, nw, tpb, smem)``, the numbers the C entry points take."""
        g = self.geom
        return g.h, g.cs, g.nw, self.tpb, g.smem


def _tc_blocks_per_sm(g: TcGeom) -> int:
    return max(1, min(_SMEM_PER_SM // (g.smem + 1024), 2048 // g.threads, _TC_BLOCKS_PER_SM))


def _tc_grid(g: TcGeom, b: int, tpb: int) -> int:
    return g.nslices * (-(-4 * b * g.ntr // tpb) + -(-2 * b * g.ntr // tpb))


def _tc_launch(g: TcGeom, b: int, sm_count: int, tpb: int | None = None) -> TcPlan:
    """The launch of geometry ``g`` on ``b * 6`` faces: ``tpb`` tiles a
    block, by default as many as keep about ``_TC_BLOCKS_PER_SM`` blocks
    per SM resident."""
    tiles = b * 6 * g.ntr * g.nslices
    if tpb is None:
        tpb = max(1, -(-tiles // (_tc_blocks_per_sm(g) * sm_count)))
    return TcPlan(g, tpb, tiles, _tc_grid(g, b, tpb))


def _tc_wide(rows, cols, kch, nch, widest, dx, esize, score, stream=False):
    """The training-batch regime's geometry: warps own 32 pixels x 32
    channels (fewer on slices under 32), a tile holds as many whole rows as
    8 warps take (or half as many), and the slice ``cs`` (8 to ``widest``)
    maximises ``score``; ``None`` where none fits the shared memory."""
    wide = []
    for cs in (8, 16, 32, 64):
        if cs > widest:
            continue
        nw = min(4, cs // 8)
        wm = _TC_MAX_THREADS // 32 // (cs // (8 * nw))  # warps along M
        hmax = max(1, min(rows, wm * 32 // cols))
        for h in sorted({hmax, max(1, hmax // 2)}):
            try:
                g = tc_geom(rows, cols, kch, nch, h, cs, nw, dx, esize, stream)
            except ValueError:
                continue
            if g.smem <= _SMEM_LIMIT - 1024:  # room for a launch's static shared memory
                wide.append(g)
    return max(wide, key=score) if wide else None


def _tc_small_geom(rows, cols, kch, nch, h, cs, warps, dx, esize, stream=False):
    """The batch-1 regime's geometry of ``h``-row tiles and ``cs``-channel
    slices: warps split N where M has fewer than ``warps`` of them; raises
    ``ValueError`` past the shared memory with the narrowest slice."""
    wm = _tc_warps_m(h, cols)
    wn = 1
    while wm * wn < warps and cs // (8 * wn) > 1 and 64 * wm * wn <= _TC_MAX_THREADS:
        wn *= 2
    g = tc_geom(rows, cols, kch, nch, h, cs, cs // (8 * wn), dx, esize, stream)
    if cs == 8 and g.smem > _SMEM_LIMIT - 1024:
        raise ValueError(
            f"the tensor-core conv cannot hold the weights of K={kch} channels x 8 in "
            f"shared memory ({g.smem} > {_SMEM_LIMIT - 1024} bytes)")
    return g


def tc_plan(b: int, rows: int, cols: int, kch: int, nch: int, sm_count: int,
            dx: bool = False, esize: int = 2, stream: bool | None = None) -> TcPlan:
    """The tensor-core kernel's plan for ``b * 6`` faces of a ``rows x
    cols`` block (the forward: the block's rows; the dx kernel: the
    ``(n+2)^2`` frame, ``dx=True``), ``kch`` reduced channels (K = 9 kch)
    and ``nch`` output channels of ``esize`` bytes (float32, ``esize=4``:
    :func:`_tc_plan_f32`, :func:`_tc_plan_dx_f32`).

    ``stream`` (the forward only): ``None`` plans the weights resident
    and, only where no such plan fits, streamed with each staged chunk
    (two stages of 9 taps x ``kc`` x ``cs``: the bfloat16 forward from Cin
    = 512, whose 8-channel slice pads its weight rows to 24 channels);
    ``True`` plans them streamed and ``False`` resident, whatever fits.
    The two modes sum each output in the same K order, so their outputs
    are bitwise equal; a streamed plan is chosen by the same regimes and
    scores as a resident one.

    Where the faces give enough tiles (training batches; n = 96), the plan
    of :func:`_tc_wide` whose slice maximises :func:`_tc_score`.  Otherwise
    (batch-1 serving), the tiles must first fill ``sm_count`` SMs: from
    tiles of about 128 pixels and the widest slice that leaves room for a
    second block, slices narrow to 16 channels, then tiles lose rows, then
    slices narrow to 8; warps split N where M has fewer than 4 of them.  A
    block walks ``tpb`` tiles of one (face group, slice) so that the grid
    holds about ``_TC_BLOCKS_PER_SM`` blocks per SM.  Raises ``ValueError``
    on a shape the kernel cannot take (a row of more than 256 pixels, or the
    weights of one 8-channel slice past the shared memory).
    """
    if cols > _TC_MAX_THREADS:
        raise ValueError(
            f"the tensor-core conv takes rows of at most {_TC_MAX_THREADS} pixels, not {cols}")
    if dx and stream:
        raise ValueError("the dx kernel keeps its weights resident")
    if stream is None and not dx:
        try:
            return tc_plan(b, rows, cols, kch, nch, sm_count, dx, esize, False)
        except ValueError:
            stream = True  # no resident plan fits
    stream = bool(stream)
    if esize == 4:
        if dx:
            return _tc_plan_dx_f32(b, rows, cols, kch, nch, sm_count)
        return _tc_plan_f32(b, rows, cols, kch, nch, sm_count, stream)
    widest = min(64, max(8, 1 << (nch - 1).bit_length()))
    g = _tc_wide(rows, cols, kch, nch, widest, dx, esize, lambda g: _tc_score(g, cols, nch),
                 stream)
    if g is not None and b * 6 * g.ntr * g.nslices >= sm_count:
        return _tc_launch(g, b, sm_count)
    return _tc_small_plan(b, rows, cols, kch, nch, sm_count, widest, dx, esize, stream)


def _tc_small_plan(b, rows, cols, kch, nch, sm_count, widest, dx, esize,
                   stream=False) -> TcPlan:
    """:func:`tc_plan`'s batch-1 regime (see there)."""
    def geom(h, cs):
        return _tc_small_geom(rows, cols, kch, nch, h, cs, 4, dx, esize, stream)

    cs, h = widest, max(1, min(rows, _TC_TILE_PX // cols))
    while cs > 8 and geom(h, cs).smem > _TC_SOFT_SMEM:
        cs //= 2
    g = geom(h, cs)
    while b * 6 * g.ntr * g.nslices < sm_count:
        if cs > 16:
            cs //= 2
        elif h > 1:
            ntr = g.ntr
            while h > 1 and -(-rows // h) == ntr:
                h -= 1
        elif cs > 8:
            cs //= 2
        else:
            break
        g = geom(h, cs)
    return _tc_launch(g, b, sm_count)


def _tc_plan_f32(b: int, rows: int, cols: int, kch: int, nch: int, sm_count: int,
                 stream: bool = False) -> TcPlan:
    """:func:`tc_plan` for the float32 forward (3xTF32).  It does six times
    the bfloat16 kernel's tensor-core work per staged value, so fuller
    blocks pay (fitted on ``tools/tc_sweep.py --dtype float32`` on an
    H100): slices of at most 32 channels (at most 4 n8 tiles a warp), the
    training-batch score times ``cs``; at batch 1 tiles of about 256 pixels
    and 16-channel slices whatever their shared memory (unless the tiles
    then need a second wave of resident blocks), up to 8 warps, row tiles
    split evenly until the tiles fill 90 % of the SMs, and one tile a
    block.  ``stream``: the weights streamed with each chunk."""
    widest = min(32, max(8, 1 << (nch - 1).bit_length()))
    g = _tc_wide(rows, cols, kch, nch, widest, False, 4,
                 lambda g: _tc_score(g, cols, nch) * g.cs, stream)
    if g is not None and b * 6 * g.ntr * g.nslices >= sm_count:
        return _tc_launch(g, b, sm_count)

    def geom(h, cs):
        return _tc_small_geom(rows, cols, kch, nch, h, cs, 8, False, 4, stream)

    def small(soft):
        """The batch-1 geometry, its slices narrowed to ``soft`` bytes first."""
        cs, h = min(widest, 16), max(1, min(rows, 2 * _TC_TILE_PX // cols))
        while cs > 8 and geom(h, cs).smem > soft:
            cs //= 2
        g = geom(h, cs)
        while b * 6 * g.ntr * g.nslices < 0.9 * sm_count:
            if h > 1:  # one more row tile, the rows split evenly
                ntr = g.ntr
                h = -(-rows // (ntr + 1))
                while h > 1 and -(-rows // h) == ntr:
                    h -= 1
            elif cs > 8:
                cs //= 2
            else:
                break
            g = geom(h, cs)
        return g

    g = small(_SMEM_LIMIT - 1024)
    if b * 6 * g.ntr * g.nslices > _tc_blocks_per_sm(g) * sm_count:  # a second wave
        g = small(_TC_SOFT_SMEM)
    return _tc_launch(g, b, sm_count, tpb=1)


def _tc_plan_dx_f32(b: int, m: int, cols: int, kch: int, nch: int,
                    sm_count: int) -> TcPlan:
    """:func:`tc_plan` for the float32 dx kernel (3xTF32) on the ``(n+2)^2``
    frame (``m = cols = n + 2``; K = 9 Cout, N = Cin).  It runs only in
    training, at batch 16, where the training-batch regime applies: slices
    of at most 32 channels and the f32 forward's score (the float32
    forward's reasoning holds: six times the bfloat16 products per staged
    value).  The weights are resident, ``9 Cout x cs`` floats (147 KB for
    a 32-channel slice at Cout = 128).  At the flagship's batch-16 shapes
    its plans take 1 % longer in sum than the fastest of the candidates
    ``tools/tc_sweep.py --dtype float32 --kind dx`` times on an H100.
    Smaller grids (the card tests' shapes) take :func:`tc_plan`'s batch-1
    regime."""
    widest = min(32, max(8, 1 << (nch - 1).bit_length()))
    g = _tc_wide(m, cols, kch, nch, widest, True, 4, lambda g: _tc_score(g, cols, nch) * g.cs)
    if g is not None and b * 6 * g.ntr * g.nslices >= sm_count:
        return _tc_launch(g, b, sm_count)
    return _tc_small_plan(b, m, cols, kch, nch, sm_count, widest, True, 4)


def _tc_score(g: TcGeom, cols: int, nch: int) -> float:
    """How well a plan of :func:`tc_plan`'s training-batch regime uses the
    card: resident warps per SM (at most 16) x the useful share of a tile
    (its output rows among its staged rows, its pixels among its m16 tiles'
    rows, the slices' channels that exist) x cs^0.3 (a wider slice stages
    each input row for more channels).  Fitted on the flagship U-Net's
    forward and dx shapes at batch 16 on an H100 (``tools/tc_sweep.py``):
    the plans it picks there take 1-3 % longer in sum than the fastest of
    the candidates the sweep times."""
    bps = max(1, min(_SMEM_PER_SM // (g.smem + 1024), 2048 // g.threads))
    warps = min(16, bps * g.threads // 32)
    return (warps * g.h / (g.h + 2) * nch / (g.nslices * g.cs)
            * g.h * cols / (g.wm * 32) * g.cs ** 0.3)


def tc_blocks(plan: TcPlan, b: int):
    """The tiles of each block of the whole-grid launch, as
    ``csrc/cs_conv3x3_tile.cuh::GridWalk`` walks them: a list per block of
    ``(face, r0, n0)`` (face = batch item * 6 + face of the cube)."""
    g, tpb = plan.geom, plan.tpb
    out = []
    for grp, nf in ((0, 4), (1, 2)):
        per = nf * b * g.ntr
        for s in range(g.nslices):
            for j in range(-(-per // tpb)):
                block = []
                for q in range(j * tpb, min((j + 1) * tpb, per)):
                    tr, fb = q % g.ntr, q // g.ntr
                    f = grp * 4 + fb % nf
                    block.append(((fb // nf) * 6 + f, tr * g.h, s * g.cs))
                out.append(block)
    return out


def dw_plan(b: int, n: int, cin: int, cout: int, sm_count: int):
    """``(rows, nsplit)`` of the CUDA-core dw kernel (a timing row): face
    rows staged at a time, and reduction slices per face group.

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


class DwTcPlan(NamedTuple):
    """A launch of the tensor-core dw kernel, as
    ``csrc/cs_conv3x3_bwd.cu::make_dw_tc_geom`` computes it."""

    rows: int  # face rows per item
    cig: int  # Cin groups of 16 per block (1 or 2)
    ng: int  # Cout groups of 32 per block (1 or 2)
    nsplit: int  # K slices per face group
    ncib: int  # Cin tiles
    ncob: int  # Cout tiles
    steps: int  # k steps per item
    threads: int
    smem: int  # bytes of shared memory per block
    kpx: int = 16  # pixels per k step: 16 (bfloat16, k16) or 8 (float32, TF32 k8)

    def args(self):
        """``(rows, nsplit, cig, ng, smem)``, the numbers the C entry point
        takes."""
        return self.rows, self.nsplit, self.cig, self.ng, self.smem


def _dw_tc_rows(n: int, kpx: int = 16, item_px: int = _DWT_ITEM_PX) -> int:
    """Face rows per item: the fewest whole rows, dividing the face and
    filling whole k steps of ``kpx`` pixels, that give ``item_px`` pixels;
    else the whole face."""
    for r in range(1, n + 1):
        if n % r == 0 and r * n % kpx == 0 and r * n >= item_px:
            return r
    return n


def dw_tc_geom(b: int, n: int, cin: int, cout: int, rows: int, nsplit: int, cig: int,
               ng: int, esize: int = 2) -> DwTcPlan:
    """The tensor-core dw kernel's geometry for ``esize``-byte elements (2:
    bfloat16, k16 steps, two stages; 4: float32, TF32 k8 steps, two stages
    and the lo halves of one); raises ``ValueError`` where the kernel does
    not take it (as ``make_dw_tc_geom`` returns false)."""
    if not (b >= 1 and n >= 1 and cin >= 1 and cout >= 1 and 1 <= rows <= n
            and 1 <= nsplit <= 65535 and cig in (1, 2) and ng in (1, 2) and cig * ng <= 2
            and esize in (2, 4)):
        raise ValueError(f"dw_tc_geom: b={b} n={n} Cin={cin} Cout={cout} rows={rows} "
                         f"nsplit={nsplit} cig={cig} ng={ng} esize={esize}")
    kpx = 16 if esize == 2 else 8
    steps = -(-(rows * n) // kpx)
    pstage = (rows + 2) * (n + 2) * (16 * cig + _DWT_PAD)
    dstage = kpx * steps * (32 * ng + _DWT_PAD)
    buffers = 2 if esize == 2 else 3
    return DwTcPlan(rows, cig, ng, nsplit, -(-cin // (16 * cig)), -(-cout // (32 * ng)), steps,
                    96 * cig * ng, esize * buffers * (pstage + dstage), kpx)


def _dw_nsplit(g: DwTcPlan, b: int, n: int, cin: int, cout: int, sm_count: int,
               blocks_per_sm: int) -> int:
    """K slices per face group: raised until the grid holds
    ``blocks_per_sm`` blocks per SM, never past the polar group's item
    count nor past partial sums (``nsplit * 2 * 9 * Cin * Cout`` floats) of
    ``_DWT_PARTIAL_BYTES``."""
    tiles = 2 * g.ncib * g.ncob
    polar_items = b * 2 * -(-n // g.rows)
    budget = max(1, _DWT_PARTIAL_BYTES // (4 * 2 * 9 * cin * cout))
    return max(1, min(polar_items, budget, 65535, -(-blocks_per_sm * sm_count // tiles)))


def dw_tc_plan(b: int, n: int, cin: int, cout: int, sm_count: int,
               esize: int = 2) -> DwTcPlan:
    """The tensor-core dw kernel's plan for ``b * 6`` faces of ``n x n`` of
    ``esize``-byte elements (float32, ``esize=4``: :func:`_dw_tc_plan_f32`).

    A block owns 9 taps x ``16 cig`` Cin x ``32 ng`` Cout channels (``cig``
    = 2 past 16 input channels, else ``ng`` = 2 past 32 output channels:
    at most 6 warps) and sums over ``nsplit`` contiguous slices of its face
    group's items (batch item, face, ``rows`` face rows); ``nsplit`` aims at
    ``_DWT_BLOCKS_PER_SM`` blocks per SM (:func:`_dw_nsplit`).  Raises
    ``ValueError`` where one block's stages pass the shared memory."""
    if esize == 4:
        return _dw_tc_plan_f32(b, n, cin, cout, sm_count)
    cig = 1 if cin <= 16 else 2
    ng = 2 if cig == 1 and cout > 32 else 1
    rows = _dw_tc_rows(n)
    g = dw_tc_geom(b, n, cin, cout, rows, 1, cig, ng)
    if g.smem > _SMEM_LIMIT - 1024:
        raise ValueError(f"the tensor-core dw kernel cannot stage {rows} rows of n={n} "
                         f"({g.smem} bytes of shared memory)")
    return g._replace(nsplit=_dw_nsplit(g, b, n, cin, cout, sm_count, _DWT_BLOCKS_PER_SM))


def _dw_makespan(g: DwTcPlan, b: int, n: int, slots: int):
    """``(makespan, blocks per slot)`` of the dw grid ``g`` on ``slots``
    resident blocks, each block taking as long as its items: the blocks
    issued in launch order (Cin and Cout tile, then K slice, then face
    group; a polar slice holds half an equatorial one's items), each to the
    slot that frees first."""
    nchunk = -(-n // g.rows)
    free = [0] * slots
    for nf in (4, 2):
        items = b * nf * nchunk
        for s in range(g.nsplit):
            work = items * (s + 1) // g.nsplit - items * s // g.nsplit
            for _ in range(g.ncib * g.ncob):
                heapq.heappush(free, heapq.heappop(free) + work)
    return max(free), 2 * g.nsplit * g.ncib * g.ncob / slots


@functools.lru_cache(maxsize=256)
def _dw_tc_plan_f32(b: int, n: int, cin: int, cout: int, sm_count: int) -> DwTcPlan:
    """:func:`dw_tc_plan` for float32 (3xTF32), fitted on ``tools/tc_sweep.py
    --dtype float32 --kind dw`` on an H100.  The bfloat16 plan's blocks
    (``cig``, ``ng``).  Each value takes 4 bytes and a third stage-sized
    buffer holds the lo halves, so an item of ``_DWF_ITEM_PX`` pixels is cut
    to the most whole rows (filling whole k8 steps where they divide the
    face) whose three buffers fit one block's shared memory, or half an
    SM's where blocks of 3 warps let two share it.  Of the K slices that
    give 1, 2 or 4 blocks per resident slot, the one whose list schedule
    (:func:`_dw_makespan`) ends first, each block adding
    ``_DWF_BLOCK_COST``: the polar group's blocks hold half the items, and
    a grid of 2.2 blocks a slot can end a third later than one of 2.  The
    plans it picks at the flagship's shapes take 0.7 % longer in sum than
    the fastest of the candidates the sweep times."""
    cig = 1 if cin <= 16 else 2
    ng = 2 if cig == 1 and cout > 32 else 1
    resident = 2 if cig * ng == 1 else 1  # by registers: 1 block of 6 warps, 3 of 3
    rows = _dw_tc_rows(n, 8, _DWF_ITEM_PX)
    g = dw_tc_geom(b, n, cin, cout, rows, 1, cig, ng, 4)
    limit = min(_SMEM_LIMIT, _SMEM_PER_SM // resident) - 1024
    while rows > 1 and g.smem > limit:
        rows -= 1
        while rows > 1 and (n % rows or rows * n % 8):
            rows -= 1
        g = dw_tc_geom(b, n, cin, cout, rows, 1, cig, ng, 4)
    if g.smem > _SMEM_LIMIT - 1024:
        raise ValueError(f"the tensor-core dw kernel cannot stage a row of n={n} "
                         f"({g.smem} bytes of shared memory)")
    if g.smem > limit:
        resident = 1
    slots = resident * sm_count

    def cost(nsplit):
        span, per_slot = _dw_makespan(g._replace(nsplit=nsplit), b, n, slots)
        return span * (1 + _DWF_BLOCK_COST * per_slot)

    splits = sorted({_dw_nsplit(g, b, n, cin, cout, sm_count, k * resident) for k in (1, 2, 4)})
    return g._replace(nsplit=min(splits, key=cost))


def dw_tc_blocks(plan: DwTcPlan, b: int, n: int, cin: int, cout: int):
    """The work of each block of the tensor-core dw kernel, in block order
    (``blockIdx`` x, then y, then z, as the grid launches them): a list of
    ``(grp, ci0, co0, items)`` with ``items`` a list of ``(face, r0)``
    (face = batch item * 6 + face of the cube, r0 its first row)."""
    nchunk = -(-n // plan.rows)
    out = []
    for grp, nf in ((0, 4), (1, 2)):
        total = b * nf * nchunk
        for s in range(plan.nsplit):
            lo, hi = total * s // plan.nsplit, total * (s + 1) // plan.nsplit
            items = []
            for it in range(lo, hi):
                bf = it // nchunk
                items.append(((bf // nf) * 6 + grp * 4 + bf % nf, (it % nchunk) * plan.rows))
            for x in range(plan.ncib * plan.ncob):
                out.append((grp, (x % plan.ncib) * 16 * plan.cig,
                            (x // plan.ncib) * 32 * plan.ng, items))
    return out


_FWD_LIB = CudaLibrary("cs_conv3x3.cu", {
    # the plan's (h, cs, nw, tpb, smem) and its weight mode (1: streamed)
    "cs_conv3x3_launch": [I32, I32] + [VP] * 7 + [I32] * 11 + [VP],
    # the CUDA-core kernel in either dtype (ops/conv_variants.py's timing row)
    "cs_conv3x3_cc_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
}, "cs_conv3x3_error_string")
_BWD_LIB = CudaLibrary("cs_conv3x3_bwd.cu", {
    "cs_conv3x3_dx_launch": [I32, I32] + [VP] * 5 + [I32] * 9 + [VP],
    # kernel #14, the raw-ring instance (ops/conv_variants.py)
    "cs_conv3x3_dx_ring_launch": [I32, I32] + [VP] * 5 + [I32] * 9 + [VP],
    # the CUDA-core dx and dw kernels in either dtype (ops/conv_variants.py's
    # timing rows)
    "cs_conv3x3_dx_cc_launch": [I32, I32] + [VP] * 5 + [I32] * 7 + [VP],
    "cs_conv3x3_dw_launch": [I32, I32] + [VP] * 5 + [I32] * 9 + [VP],
    "cs_conv3x3_dw_cc_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
}, "cs_conv3x3_bwd_error_string")


def fwd_plan(x_dtype, b, rows, cols, cin, cout, sm_count, stream=None) -> TcPlan:
    """The forward kernel's plan (:func:`tc_plan`, ``stream`` as there)
    for elements of ``x_dtype``."""
    esize = torch.finfo(x_dtype).bits // 8
    return tc_plan(b, rows, cols, cin, cout, sm_count, esize=esize, stream=stream)


def fwd_plan_args(x_dtype, b, rows, cols, cin, cout, sm_count):
    """``(h, cs, nw, tpb, smem)`` of ``cs_conv3x3_launch``: the plan that
    :func:`fwd_plan` chooses for the paths."""
    return fwd_plan(x_dtype, b, rows, cols, cin, cout, sm_count).args()


def dx_plan_args(dtype, b, n, cin, cout, sm_count):
    """``(h, cs, nw, tpb, smem)`` of the dx entry points: the tensor-core
    kernel's (:func:`tc_plan`; the frame is ``(n+2)^2``, K = 9 Cout, N =
    Cin) for elements of ``dtype``."""
    esize = torch.finfo(dtype).bits // 8
    return tc_plan(b, n + 2, n + 2, cout, cin, sm_count, dx=True, esize=esize).args()


def dw_launch_args(dtype, b, n, cin, cout, sm_count, cudacore=False):
    """The dw kernel's C entry point and its plan arguments: the
    tensor-core kernel's (``cs_conv3x3_dw_launch``, :func:`dw_tc_plan`'s
    ``(rows, nsplit, cig, ng, smem)`` for elements of ``dtype``); with
    ``cudacore`` the CUDA-core timing row's (``cs_conv3x3_dw_cc_launch``,
    :func:`dw_plan`'s ``(rows, nsplit)``).  ``args[1]`` is ``nsplit`` in
    both."""
    if not cudacore:
        esize = torch.finfo(dtype).bits // 8
        return "cs_conv3x3_dw_launch", dw_tc_plan(b, n, cin, cout, sm_count, esize).args()
    return "cs_conv3x3_dw_cc_launch", dw_plan(b, n, cin, cout, sm_count)


class _Conv3x3Kernel(KernelWrapper):
    def __init__(self, name, library):
        super().__init__(name, library)
        # the launches whose plan streams the weights, by (rows, cols, Cin,
        # Cout), counted beside ``launches``
        self.stream_launches: collections.Counter = collections.Counter()

    def __call__(self, x, ext, k_eq, k_pole, b_eq, b_pole):
        """Fused CS conv of ``x`` (B, 6, H, W, Cin), whole faces (H = W = n,
        ``ext`` :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips` of ``x``) or a
        shard's block (H <= W) with its exchanged ghost strips ``ext`` (B, 6,
        4, W+2, Cin); HWIO kernels (3, 3, Cin, Cout) and biases (Cout,), all
        of ``x``'s dtype.  Returns (B, 6, H, W, Cout); see
        :func:`cs_conv3x3_plain`.  The weights stay resident unless no such
        plan fits (:func:`tc_plan`)."""
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
        plan = fwd_plan(x.dtype, b, rows, cols, cin, cout, self._sm_count[dev])
        out = torch.empty((b, 6, rows, cols, cout), dtype=x.dtype, device=x.device)
        self._launch(
            "cs_conv3x3_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, k_eq, k_pole, b_eq, b_pole, out)),
            b, rows, cols, cin, cout, *plan.args(), int(plan.geom.stream), sizes=11,
        )
        if plan.geom.stream:
            with self._lock:
                self.stream_launches[(rows, cols, cin, cout)] += 1
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
        plan = dx_plan_args(dout.dtype, b, n, cin, cout, self._sm_count[dev])
        dx = torch.empty((b, 6, n, n, cin), dtype=dout.dtype, device=dout.device)
        d_ext = torch.empty((b, 6, 4, n + 2, cin), dtype=dout.dtype, device=dout.device)
        self._launch(
            "cs_conv3x3_dx_launch", dev, DTYPES[dout.dtype], dev,
            *(t.data_ptr() for t in (dout, k_eq, k_pole, dx, d_ext)),
            b, n, cin, cout, *plan, sizes=9,
        )
        return dx, d_ext


class _Conv3x3DwKernel(KernelWrapper):
    _cudacore = False  # the CUDA-core kernel in both dtypes (a timing row)

    def __call__(self, x, ext, dout):
        """Weight and bias gradients of the fused conv, f32: ``x`` (B, 6, n,
        n, Cin), its ghost strips ``ext`` and ``dout`` (B, 6, n, n, Cout), all
        of one dtype -> ``(dk_eq, dk_pole, db_eq, db_pole)``, see
        :func:`cs_conv3x3_dw_plain`.  The kernel writes per-block partial
        sums; ``torch.sum`` reduces them in a fixed order, so the result does
        not change from run to run."""
        if x.device.type == "cpu":
            return cs_conv3x3_dw_plain(x, ext, dout)
        check_faces(self.name, x)
        b, _, n, _, cin = x.shape
        cout = dout.shape[-1]
        check_cuda_args(self.name, x, {
            "x": (x, (b, 6, n, n, cin)),
            "ext": (ext, (b, 6, 4, n + 2, cin)),
            "dout": (dout, (b, 6, n, n, cout)),
        })
        dk_part, db_part = self._partials(x, ext, dout, b, n, cin, cout, self._device(x))
        dk, db = dk_part.sum(dim=0), db_part.sum(dim=0)
        return dk[0], dk[1], db[0], db[1]

    def _partials(self, x, ext, dout, b, n, cin, cout, dev):
        """One launch: ``(dk_part (nsplit, 2, 3, 3, Cin, Cout), db_part
        (nsplit, 2, Cout))``, float32."""
        entry, plan = dw_launch_args(x.dtype, b, n, cin, cout, self._sm_count[dev],
                                     self._cudacore)
        f32 = dict(dtype=torch.float32, device=x.device)
        dk_part = torch.empty((plan[1], 2, 3, 3, cin, cout), **f32)
        db_part = torch.empty((plan[1], 2, cout), **f32)
        self._launch(
            entry, dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, dout, dk_part, db_part)),
            b, n, cin, cout, *plan, sizes=4 + len(plan),
        )
        return dk_part, db_part


cs_conv3x3 = _Conv3x3Kernel("cs_conv3x3", _FWD_LIB)
# kernels #8 (a row band) and #9 (a tile): the same kernel, counted apart
cs_conv3x3_band = _Conv3x3Kernel("cs_conv3x3_band", _FWD_LIB)
cs_conv3x3_tile = _Conv3x3Kernel("cs_conv3x3_tile", _FWD_LIB)
cs_conv3x3_dx = _Conv3x3DxKernel("cs_conv3x3_dx", _BWD_LIB)
cs_conv3x3_dw = _Conv3x3DwKernel("cs_conv3x3_dw", _BWD_LIB)


BACKWARD_MODES = ("xla", "split", "packdw", "hybrid", "fused")
_BWD_MODE: contextvars.ContextVar = contextvars.ContextVar("cs_conv3x3_fused_bwd",
                                                           default="fused")


@contextlib.contextmanager
def use_pallas_backward(mode: str):
    """The reference's backward-mode selector: within this context
    :func:`backward_mode` is ``mode`` (one of :data:`BACKWARD_MODES`).
    Every mode runs :func:`cs_conv3x3_fused`'s one backward, the dx and dw
    kernels: the reference's modes compute the same gradients."""
    if mode not in BACKWARD_MODES:
        raise ValueError(f"unknown pallas backward mode {mode!r}")
    token = _BWD_MODE.set(mode)
    try:
        yield
    finally:
        _BWD_MODE.reset(token)


def backward_mode() -> str:
    """The backward mode :func:`use_pallas_backward` set (``"fused"``
    outside it)."""
    return _BWD_MODE.get()


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


@functools.lru_cache(maxsize=None)
def fused_fits(dtype, b, n, cin, cout, sm_count, dx, dw) -> bool:
    """Whether the kernels :func:`cs_conv3x3_fused` launches on a card of
    ``sm_count`` SMs plan the whole-face conv ``(b, 6, n, n, cin) -> cout``
    in ``dtype``: the forward kernel's plan, and the dx kernel's (``dx``)
    and the dw kernel's (``dw``) where its backward will launch them.  The
    plan functions those launches run; only their ``ValueError`` is caught,
    and nothing is launched."""
    plans = [(fwd_plan_args, (dtype, b, n, n, cin, cout, sm_count))]
    if dx:
        plans.append((dx_plan_args, (dtype, b, n, cin, cout, sm_count)))
    if dw:
        plans.append((dw_launch_args, (dtype, b, n, cin, cout, sm_count)))
    try:
        for plan, args in plans:
            plan(*args)
    except ValueError:
        return False
    return True
