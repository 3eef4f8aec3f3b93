"""Other formulations and launches of the fused 3x3 cubed-sphere conv: the
kernels that the reference's kernel tools time beside its production conv.

* :data:`cs_conv3x3_npack`: kn2row on the tensor cores
  (``csrc/cs_conv3x3_mma.cu``), replacing
  ``dlwp_cs_tpu/ops/pallas_conv.py::_kernel_npack``.  Weights tap-packed
  ``(Cin, 9*Cout)`` as :func:`npack_taps` makes them; per dy, one product of
  the padded face's rows with the dy slice, then the dx-shifted adds of its
  three Cout slices, in tiles of output rows x output channels
  (:func:`npack_plan`).  :data:`cs_conv3x3_npack_v1`, the kernel of the
  first design (one face's rows a block, one product a padded row,
  :func:`mma_plan`), is a timing row.
* :data:`cs_conv3x3_im2col`: im2col on the tensor cores (the same source),
  replacing ``tools/kernel_variants.py::_kernel_im2col`` without its
  batch->lane packing.  Weights ``(9*Cin, Cout)`` as :func:`im2col_taps`
  makes them; one product of the ``(pixels, 9*Cin)`` column matrix with
  them per weight group, in tiles of pixels x channels
  (:func:`im2col_plan`), the column chunks gathered straight from ``x`` and
  the ghost strips.  :data:`cs_conv3x3_im2col_v1`, the kernel of the first
  design (one face's rows a block, :func:`mma_plan`), is a timing row.
* :data:`cs_conv3x3_kernel_only`: the conv kernel of ``csrc/cs_conv3x3.cu``
  (#1) launched on ghost strips the caller computed, counted apart;
  replaces ``tools/conv_micro.py::_kernel_only``.
* :data:`cs_conv3x3_dx_ring`: the input cotangent on the ``(n+2)^2``
  padded grid as the interior ``dx`` and the raw ring ``[row 0, row n+1,
  column 0, column n+1]``, corners at both ends of the W/E columns: the raw
  instance of the dx kernel of ``csrc/cs_conv3x3_bwd.cu`` (#4), replacing
  ``tools/kernel_variants.py::_dx_aligned_kernel``.
* :data:`cs_conv3x3_cudacore`, :data:`cs_conv3x3_dx_cudacore` and
  :data:`cs_conv3x3_dw_cudacore`: the CUDA-core kernels of #1, #4 (#14
  with ``raw=True``) and #5 in either dtype, with
  :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.tile_plan`'s tiles (#5:
  :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.dw_plan`'s): the instances
  that the tensor-core kernels replaced in both dtypes, kept only so that
  a timing run can set the two side by side on one card.  No path of the
  port selects them.
* :data:`ring_fixes_cudacore` and :data:`xring_fused_apply_cudacore`: the
  CUDA-core ring kernels of ``csrc/cs_ring.cu`` (#6, #7: one block per 8 x 8
  output tile or edge chunk, the fix dots serial per thread), which the ring
  blocks on the tensor cores replaced; timing rows likewise, never selected
  by a path of the port.

#3 and #13 take bfloat16 only, as the tools run them: a float32 CUDA tensor
raises ``ValueError`` (TF32 would change the numbers, and nothing falls
back).  Each wrapper counts its launches in ``launches``; on a CPU tensor it
returns its plain version (:func:`cs_conv3x3_npack_plain`,
:func:`cs_conv3x3_im2col_plain`, :func:`cs_conv3x3_dx_ring_plain`; #12's is
:func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_plain`), which takes any
float dtype and sums in ``torch.promote_types(dtype, float32)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dlwp_cs_tpu_torch.ops.cuda_build import (
    DTYPES,
    I32,
    VP,
    CudaLibrary,
    KernelWrapper,
    check_cuda_args,
    check_faces,
)
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    _BWD_LIB,
    _DX_MAX_CS,
    _Conv3x3DwKernel,
    _FWD_LIB,
    _GROUPS,
    _Conv3x3Kernel,
    _dx_frame_plain,
    _padded_faces,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
    dx_plan_args,
    tile_plan,
)
from dlwp_cs_tpu_torch.ops.ring_kernel import (
    _RING_LIB,
    _bases_shape,
    _copy_vec,
    _strips_shape,
    ring_fixes_plain,
    xring_fused_apply_plain,
)

__all__ = [
    "Im2colPlan",
    "NpackPlan",
    "cs_conv3x3_cudacore",
    "cs_conv3x3_dw_cudacore",
    "cs_conv3x3_dx_cudacore",
    "cs_conv3x3_dx_ring",
    "cs_conv3x3_dx_ring_plain",
    "cs_conv3x3_im2col",
    "cs_conv3x3_im2col_plain",
    "cs_conv3x3_im2col_v1",
    "cs_conv3x3_kernel_only",
    "cs_conv3x3_npack",
    "cs_conv3x3_npack_plain",
    "cs_conv3x3_npack_v1",
    "im2col_blocks",
    "im2col_launch",
    "im2col_plan",
    "im2col_taps",
    "mma_plan",
    "npack_blocks",
    "npack_launch",
    "npack_occupancy",
    "npack_plan",
    "npack_taps",
    "npack_tiles",
    "ring_fixes_cudacore",
    "xring_fused_apply_cudacore",
]

# csrc/cs_ring.cu's CUDA-core kernels: output tile side and edge chunk
_RING_TILE = 8
# csrc/cs_conv3x3_mma.cu: rows after each staged row, the im2col kernel's
# accumulator tiles per block, and the shared memory a block may opt in to
# on an H100 (232,448 bytes)
_PAD, _IM_TILES, _SMEM_LIMIT = 8, 64, 232448
# its im2col GEMM kernel (csrc/cs_conv3x3_mma.cu, namespace im2): the tile
# configurations (pixels, channels, threads, warp groups along K) by index,
# the K window widths to choose from, the copy stages and an SM's shared
# memory (228 KB, less 1 KB a block)
_IM2_CFGS = ((64, 32, 256, 2), (64, 64, 256, 2), (128, 32, 256, 1), (128, 64, 256, 1))
_IM2_KWS, _IM2_STAGES, _SMEM_PER_SM = (256, 128, 64), 3, 233472
# its kn2row tile kernel (namespace kn2): the tile channel widths to choose
# from, the output units (8 channels of a pixel) a block holds in
# registers (4 a thread), the M tiles of a warp's chunk and the floats
# after each product row
_KN2_BNS, _KN2_UNITS, _KN2_PADF = (8, 16, 32, 64, 128), 4 * 256, 8


def npack_taps(k):
    """``(3, 3, Cin, Cout) -> (Cin, 9*Cout)``: column ``(dy*3 + dx)*Cout + co``
    of row ``ci`` is ``k[dy, dx, ci, co]`` (the reference tool's
    ``k.transpose(2, 0, 1, 3).reshape(Cin, 9*Cout)``)."""
    cin, cout = k.shape[2], k.shape[3]
    return k.permute(2, 0, 1, 3).reshape(cin, 9 * cout).contiguous()


def im2col_taps(k):
    """``(3, 3, Cin, Cout) -> (9*Cin, Cout)``: row ``(dy*3 + dx)*Cin + ci``
    is ``k[dy, dx, ci]`` (the reference tool's ``k.reshape(9*Cin, Cout)``)."""
    return k.reshape(9 * k.shape[2], k.shape[3]).contiguous()


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def cs_conv3x3_npack_plain(x, ext, taps_eq, taps_pole, b_eq, b_pole):
    """Plain-torch kn2row conv: ``x`` (B, 6, n, n, Cin), ``ext`` its ghost
    strips (B, 6, 4, n+2, Cin), tap-packed weights ``(Cin, 9*Cout)`` and
    biases ``(Cout,)`` -> (B, 6, n, n, Cout) in ``x``'s dtype.  Per dy the
    product ``P[dy : dy+n, :] @ taps[:, dy slice]`` over all n+2 padded
    columns, then ``out[.., j, :] += prod[.., j+dx, dx slice]``; weights and
    biases rounded to ``x``'s dtype, sums in ``promote_types(dtype,
    float32)``, one rounding at the end."""
    n, dt = x.shape[2], x.dtype
    acc_dt = _acc_dtype(dt)
    cout = taps_eq.shape[1] // 9
    p = _padded_faces(x, ext).to(acc_dt)
    parts = []
    for taps, bias, faces in ((taps_eq, b_eq, _GROUPS[0]), (taps_pole, b_pole, _GROUPS[1])):
        t = taps.to(dt).to(acc_dt)
        acc = 0
        for dy in range(3):
            prod = p[:, faces, dy : dy + n] @ t[:, dy * 3 * cout : (dy + 1) * 3 * cout]
            for dx in range(3):
                acc = acc + prod[..., dx : dx + n, dx * cout : (dx + 1) * cout]
        parts.append(acc + bias.to(dt).to(acc_dt))
    return torch.cat(parts, dim=1).to(dt)


def cs_conv3x3_im2col_plain(x, ext, w_eq, w_pole, b_eq, b_pole):
    """Plain-torch im2col conv: ``x`` (B, 6, n, n, Cin), ``ext`` its ghost
    strips, weights ``(9*Cin, Cout)`` and biases -> (B, 6, n, n, Cout) in
    ``x``'s dtype.  The column tile ``(B, 6, n, n, 9*Cin)`` holds the 9
    shifted windows of the padded face side by side (tap ``dy*3 + dx``), one
    product with the weights; sums in ``promote_types(dtype, float32)``."""
    n, dt = x.shape[2], x.dtype
    acc_dt = _acc_dtype(dt)
    p = _padded_faces(x, ext).to(acc_dt)
    col = torch.cat([p[:, :, dy : dy + n, dx : dx + n] for dy in range(3) for dx in range(3)],
                    dim=-1)
    parts = []
    for w, bias, faces in ((w_eq, b_eq, _GROUPS[0]), (w_pole, b_pole, _GROUPS[1])):
        parts.append(col[:, faces] @ w.to(dt).to(acc_dt) + bias.to(dt).to(acc_dt))
    return torch.cat(parts, dim=1).to(dt)


def cs_conv3x3_dx_ring_plain(dout, k_eq, k_pole):
    """Plain-torch input cotangent on the padded grid, as ``(dx, dring)``:
    dx (B, 6, n, n, Cin) the interior of the ``(n+2)^2`` cotangent (that of
    :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_dx_plain`), dring
    (B, 6, 4, n+2, Cin) its raw ring ``[row 0, row n+1, column 0, column
    n+1]``, corners at both ends of the columns."""
    n = dout.shape[2]
    dxp = _dx_frame_plain(dout, k_eq, k_pole)
    dring = torch.stack([dxp[:, :, 0], dxp[:, :, n + 1], dxp[:, :, :, 0], dxp[:, :, :, n + 1]],
                        dim=2)
    return dxp[:, :, 1 : n + 1, 1 : n + 1].contiguous(), dring


def _mma_smem(kind: str, n: int, cin: int, cout: int, h: int) -> int:
    """Shared memory of one block of the npack or im2col kernel (bytes), as
    ``csrc/cs_conv3x3_mma.cu::make_geom`` computes it."""
    kp = -(-cin // 16) * 16
    kps, mp = kp + _PAD, -(-(n + 2) // 16) * 16
    staged = 2 * (h + 2) * mp * kps
    if kind == "im2col":
        m = -(-(h * n) // 16) * 16
        return staged + 2 * (m * (9 * kp + _PAD) + -(-cout // 8) * 8 * kps)
    nb = -(-(3 * cout) // 8) * 8
    return staged + 2 * nb * kps + 4 * (mp * (nb + 8) + h * n * cout)


def _im2col_tiles(n: int, cout: int, h: int) -> int:
    return -(-(h * n) // 16) * -(-cout // 8)


def mma_plan(kind: str, b: int, n: int, cin: int, cout: int, sm_count: int) -> int:
    """Output rows per block of the ``kind`` ("npack" or "im2col") kernel:
    the most (up to 8) whose block fits the card's shared memory (and, for
    im2col, 64 accumulator tiles), lowered until two blocks fit an SM (so
    one stages while the other computes) and the grid holds two blocks per
    SM where the batch is small.  Raises ``ValueError`` where one row does
    not fit."""
    def fits(h):
        ok = _mma_smem(kind, n, cin, cout, h) <= _SMEM_LIMIT
        return ok and (kind == "npack" or _im2col_tiles(n, cout, h) <= _IM_TILES)

    if not fits(1):
        raise ValueError(
            f"cs_conv3x3_{kind}: n={n}, Cin={cin}, Cout={cout} needs more shared memory "
            "(or accumulator tiles) than one block has"
        )
    h = min(n, 8)
    while h > 1 and (not fits(h) or _mma_smem(kind, n, cin, cout, h) > _SMEM_LIMIT // 2
                     or -(-n // h) * 6 * b < 2 * sm_count):
        h -= 1
    return h


class Im2colPlan(NamedTuple):
    """The im2col GEMM kernel's launch: configuration ``cfg`` (a ``bm`` x
    ``bn`` tile of pixels x output channels, ``threads`` a block in ``kg``
    warp groups along K), K windows of ``tpw`` whole taps or of one
    ``bks``-wide slice of a tap (``nsl`` slices a tap; ``nwin`` windows),
    ``mt`` M tiles of each weight group (faces 0-3, faces 4-5, over the
    batch), ``nt`` N tiles, ``smem`` bytes; the grid is ``(mt[0] + mt[1])
    * nt`` blocks, N tiles fastest."""

    cfg: int
    bm: int
    bn: int
    threads: int
    kg: int
    bks: int
    tpw: int
    nsl: int
    nwin: int
    mt: tuple
    nt: int
    smem: int

    @property
    def blocks(self):
        return sum(self.mt) * self.nt


def _granule(nbytes: int) -> int:
    """The widest copy (16, 8 or 4 bytes; 2: plain loads) dividing ``nbytes``."""
    return next(g for g in (16, 8, 4, 2) if nbytes % g == 0)


def im2col_launch(b: int, n: int, cin: int, cout: int, cfg: int, kw: int) -> Im2colPlan:
    """The im2col GEMM kernel's launch in configuration ``cfg`` with K
    windows at most ``kw`` wide: as many whole taps as that holds, else
    equal 16-channel slices of one tap; its shared memory as the kernel
    counts it (the stages, or the epilogue's partial sums and tile)."""
    bm, bn, threads, kg = _IM2_CFGS[cfg]
    kp = -(-cin // 16) * 16
    if kp <= kw:
        bks, tpw = kp, min(9, kw // kp)
    else:
        bks, tpw = -(-kp // -(-kp // kw) // 16) * 16, 1
    nsl = -(-kp // bks)
    mt = tuple(-(-(b * nf * n * n) // bm) for nf in (4, 2))
    stages = _IM2_STAGES * 2 * (bm * (tpw * bks + _PAD) + tpw * bks * (bn + _PAD))
    smem = max(stages, (kg - 1) * bm * bn * 4 + bm * (bn + _PAD) * 2)
    return Im2colPlan(cfg, bm, bn, threads, kg, bks, tpw, nsl, -(-9 // tpw) * nsl, mt,
                      -(-cout // bn), smem)


def im2col_plan(b: int, n: int, cin: int, cout: int, sm_count: int) -> Im2colPlan:
    """The launch of the im2col GEMM kernel.  Of the configurations whose N
    tiles pad Cout least: where the 128-pixel tiles (one warp group) fill a
    wave of ``sm_count`` blocks, the largest of them, with the widest K
    window (at most 128) that keeps two blocks an SM; else (batch 1) the
    64-pixel tile with the most blocks, its k steps shared by two warp
    groups, with the widest K window (up to 256) whose shared memory still
    lets every block be resident at once: each window costs a copy wait
    and a barrier, and at batch 1 that chain is the kernel's time
    (``tools/im2col_phases.py``)."""
    if b < 1 or n < 1 or cin < 1 or cout < 1:
        raise ValueError(f"cs_conv3x3_im2col: b={b}, n={n}, Cin={cin}, Cout={cout}")

    def widest(cfg, kws, resident):
        fits = [p for p in (im2col_launch(b, n, cin, cout, cfg, kw) for kw in kws)
                if p.smem <= min(_SMEM_LIMIT, _SMEM_PER_SM // resident - 1024)]
        return fits[0] if fits else im2col_launch(b, n, cin, cout, cfg, kws[-1])

    tiles = [im2col_launch(b, n, cin, cout, cfg, _IM2_KWS[-1]) for cfg in range(len(_IM2_CFGS))]
    least = min(p.nt * p.bn for p in tiles)
    pool = [p for p in tiles if p.nt * p.bn == least]
    many = [p for p in pool if p.kg == 1 and p.blocks >= sm_count]
    if many:
        best = max(many, key=lambda p: p.bm * p.bn)
        return widest(best.cfg, (128, 64), 2)
    best = max((p for p in pool if p.kg > 1), key=lambda p: p.blocks)
    return widest(best.cfg, _IM2_KWS, -(-best.blocks // sm_count))


def im2col_blocks(plan: Im2colPlan, b: int, n: int, cout: int):
    """What each block of the launch writes, in launch order: ``(group,
    pixels, (c0, c1))``, the flat output pixels ``(item * 6 + face) * n * n
    + i * n + j`` of its M tile and its channels ``c0 .. c1 - 1``, as
    ``csrc/cs_conv3x3_mma.cu::cs_conv3x3_im2col_gemm_kernel`` decodes its
    block and rows."""
    out = []
    for bid in range(plan.blocks):
        nti, mti = bid % plan.nt, bid // plan.nt
        grp = 0 if mti < plan.mt[0] else 1
        nf, f0 = (2, 4) if grp else (4, 0)
        m0 = (mti - plan.mt[0] if grp else mti) * plan.bm
        pixels = []
        for m in range(m0, min(m0 + plan.bm, b * nf * n * n)):
            item, rem = divmod(m, nf * n * n)
            fl, pix = divmod(rem, n * n)
            pixels.append((item * 6 + f0 + fl) * n * n + pix)
        out.append((grp, pixels, (nti * plan.bn, min((nti + 1) * plan.bn, cout))))
    return out


class NpackPlan(NamedTuple):
    """The kn2row tile kernel's launch: tiles of ``h`` output rows x ``bn``
    output channels of one face (``rt`` row tiles, ``ct`` channel tiles a
    face), ``sw`` channels of a dx run of the staged weights and the
    product (``bn``, or Cout where Cout < ``bn``), ``wbufs`` weight
    buffers (2: the next dy slice copied while one multiplies), ``mt`` M
    tiles of a product (``h * (n + 2)`` padded cells over 16), ``cells``
    staged cells, ``smem`` bytes; the grid is ``(rt * ct, 6, B)``,
    ``blocks`` in all."""

    h: int
    bn: int
    sw: int
    wbufs: int
    rt: int
    ct: int
    mt: int
    cells: int
    smem: int
    blocks: int


def npack_launch(b: int, n: int, cin: int, cout: int, h: int, bn: int, wbufs: int) -> NpackPlan:
    """The kn2row tile kernel's launch for tiles of ``h`` rows x ``bn``
    channels with ``wbufs`` weight buffers, its shared memory as
    ``csrc/cs_conv3x3_mma.cu::kn2::smem_bytes`` counts it: the staged cells
    (``(h+2)(n+2)``, Cin rounded up to 16 plus 8 a cell), the weight
    buffers (kp rows of the three dx runs, ``3 sw`` rounded up to 8 = nw,
    plus 8 where nw / 8 is even) and the f32 product (``16 mt`` rows of nw
    + 8)."""
    kp = -(-cin // 16) * 16
    mt = -(-(h * (n + 2)) // 16)
    cells = (h + 2) * (n + 2)
    sw = min(cout, bn)
    nw = -(-(3 * sw) // 8) * 8
    wpitch = nw + (0 if (nw // 8) % 2 else _PAD)
    smem = (2 * (cells * (kp + _PAD) + wbufs * kp * wpitch)
            + 4 * 16 * mt * (nw + _KN2_PADF))
    rt, ct = -(-n // h), -(-cout // bn)
    return NpackPlan(h, bn, sw, wbufs, rt, ct, mt, cells, smem, rt * ct * 6 * b)


def npack_tiles(b: int, n: int, cin: int, cout: int) -> list:
    """Every launch :func:`npack_plan` chooses from: tiles of h <= 8 rows and
    ``bn`` in 8, 16, 32, 64, 128 channels (none past Cout rounded up to 16
    but 8) whose output units fit the block's registers, each with two
    weight buffers where its block fits shared memory, else one."""
    out = []
    for bn in _KN2_BNS:
        if bn > max(-(-cout // 16) * 16, 8):
            continue
        for h in range(1, min(n, 8) + 1):
            if h * n * (bn // 8) > _KN2_UNITS:
                break
            for wbufs in (2, 1):
                p = npack_launch(b, n, cin, cout, h, bn, wbufs)
                if p.smem <= _SMEM_LIMIT:
                    out.append(p)
                    break
    return out


def npack_plan(b: int, n: int, cin: int, cout: int, sm_count: int) -> NpackPlan:
    """The launch of the kn2row tile kernel.  Of :func:`npack_tiles` (16
    channels or more where Cout is wider than 8: each 8-channel tile
    restages the cells), those whose channel tiles pad Cout least; of
    these, where some grid fits the card at once (two blocks an SM where
    the block's shared memory allows; its registers always do), the one
    with the most blocks (then more rows, then more channels): every block
    resident, each a shorter chain; else (many tiles) of those that fit two
    blocks an SM, the one with the fewest product rows x channels in all
    (ragged and padded tiles cost products; then fewer blocks).  The rule
    comes from timing every tile on the card (``tools/npack_phases.py``).
    Raises ``ValueError`` where no tile fits."""
    if b < 1 or n < 1 or cin < 1 or cout < 1:
        raise ValueError(f"cs_conv3x3_npack: b={b}, n={n}, Cin={cin}, Cout={cout}")
    fits = npack_tiles(b, n, cin, cout)
    if not fits:
        raise ValueError(
            f"cs_conv3x3_npack: n={n}, Cin={cin}, Cout={cout} needs more shared memory "
            "than one block has"
        )
    fits = [p for p in fits if p.bn > 8 or cout <= 8] or fits
    least = min(p.ct * p.bn for p in fits)
    pool = [p for p in fits if p.ct * p.bn == least]
    two = [p for p in pool if p.smem <= _SMEM_PER_SM // 2 - 1024]
    wave = [p for p in pool if p.blocks <= sm_count * (2 if p in two else 1)]
    if wave:
        return max(wave, key=lambda p: (p.blocks, p.h, p.bn, p.wbufs))
    return min(two or pool,
               key=lambda p: (p.rt * p.ct * p.mt * p.bn, p.blocks, -p.bn, -p.wbufs))


def npack_blocks(plan: NpackPlan, n: int, cout: int):
    """What each block of one face writes, in ``blockIdx.x`` order: ``(rows,
    (c0, c1))``, its output rows ``r0 .. r1 - 1`` and channels ``c0 .. c1 -
    1``, as ``cs_conv3x3_npack_tiles_kernel`` decodes its block."""
    out = []
    for bid in range(plan.rt * plan.ct):
        rti, cti = divmod(bid, plan.ct)
        r0, c0 = rti * plan.h, cti * plan.bn
        out.append(((r0, min(r0 + plan.h, n)), (c0, min(c0 + plan.bn, cout))))
    return out


_MMA_LIB = CudaLibrary("cs_conv3x3_mma.cu", {
    "cs_conv3x3_npack_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
    "cs_conv3x3_im2col_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
    "cs_conv3x3_im2col_gemm_launch": [I32, I32] + [VP] * 7 + [I32] * 11 + [VP],
    "cs_conv3x3_npack_tiles_launch": [I32, I32] + [VP] * 7 + [I32] * 11 + [VP],
    "cs_conv3x3_npack_tiles_occupancy": [I32, I32, VP],
}, "cs_conv3x3_mma_error_string")


def npack_occupancy(plan: NpackPlan, library=None) -> int:
    """Blocks of the kn2row tile kernel's instance for ``plan`` that one SM
    of the current card holds at once with the plan's shared memory (the
    CUDA occupancy calculator: its registers and shared memory both
    counted)."""
    import ctypes

    lib = (library or _MMA_LIB).build()
    out = ctypes.c_int(0)
    # the narrow instance, as csrc/cs_conv3x3_mma.cu::kn2::narrow picks it
    narrow = plan.sw % 4 or -(-(3 * plan.sw) // 8) % 2
    err = lib.cs_conv3x3_npack_tiles_occupancy(int(plan.smem), int(bool(narrow)),
                                               ctypes.addressof(out))
    if err:
        raise RuntimeError(f"cs_conv3x3_npack_tiles_occupancy: error {err}")
    return out.value


def _copy_granules(x, ext, w_eq, w_pole, cin, cout):
    """The widest copies (bytes) the inputs' rows and addresses allow: of
    the cells of ``x`` and ``ext`` (Cin runs) and of the weights' rows
    (Cout runs)."""
    ga = max(g for g in (2, 4, 8, 16) if g <= _granule(2 * cin)
             and x.data_ptr() % g == 0 and ext.data_ptr() % g == 0)
    gb = max(g for g in (2, 4, 8, 16) if g <= _granule(2 * cout)
             and w_eq.data_ptr() % g == 0 and w_pole.data_ptr() % g == 0)
    return ga, gb


class _MmaConvKernel(KernelWrapper):
    """#3 (``kind`` "npack", weights (Cin, 9*Cout)) or #13 ("im2col",
    weights (9*Cin, Cout)) on bfloat16 CUDA tensors."""

    def __init__(self, name, kind, plain):
        super().__init__(name, _MMA_LIB)
        self.kind, self.plain = kind, plain

    def __call__(self, x, ext, w_eq, w_pole, b_eq, b_pole):
        if x.device.type == "cpu":
            return self.plain(x, ext, w_eq, w_pole, b_eq, b_pole)
        check_faces(self.name, x)
        if x.dtype != torch.bfloat16:
            raise ValueError(
                f"{self.name} takes bfloat16 only, not {x.dtype}: the tensor cores would "
                "round float32 to TF32, and nothing falls back"
            )
        b, _, n, _, cin = x.shape
        cout = w_eq.shape[-1] // 9 if self.kind == "npack" else w_eq.shape[-1]
        wshape = (cin, 9 * cout) if self.kind == "npack" else (9 * cin, cout)
        check_cuda_args(self.name, x, {
            "x": (x, (b, 6, n, n, cin)),
            "ext": (ext, (b, 6, 4, n + 2, cin)),
            "w_eq": (w_eq, wshape),
            "w_pole": (w_pole, wshape),
            "b_eq": (b_eq, (cout,)),
            "b_pole": (b_pole, (cout,)),
        })
        dev = self._device(x)
        out = torch.empty((b, 6, n, n, cout), dtype=x.dtype, device=x.device)
        self._launch_kernel(dev, x, ext, w_eq, w_pole, b_eq, b_pole, out)
        return out

    def _launch_kernel(self, dev, x, ext, w_eq, w_pole, b_eq, b_pole, out):
        b, _, n, _, cin = x.shape
        cout = out.shape[-1]
        h = mma_plan(self.kind, b, n, cin, cout, self._sm_count[dev])
        vec = int(x.data_ptr() % 16 == 0 and ext.data_ptr() % 16 == 0)
        wvec = int(w_eq.data_ptr() % 16 == 0 and w_pole.data_ptr() % 16 == 0)
        self._launch(
            f"cs_conv3x3_{self.kind}_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, w_eq, w_pole, b_eq, b_pole, out)),
            b, n, cin, cout, h, vec, wvec, sizes=7,
        )


class _Im2colGemmKernel(_MmaConvKernel):
    """#13: the im2col GEMM kernel (:func:`im2col_plan`) on bfloat16 CUDA
    tensors, weights (9*Cin, Cout)."""

    def __init__(self, name):
        super().__init__(name, "im2col", cs_conv3x3_im2col_plain)

    def _launch_kernel(self, dev, x, ext, w_eq, w_pole, b_eq, b_pole, out, plan=None):
        b, _, n, _, cin = x.shape
        cout = out.shape[-1]
        p = plan or im2col_plan(b, n, cin, cout, self._sm_count[dev])
        ga, gb = _copy_granules(x, ext, w_eq, w_pole, cin, cout)
        self._launch(
            "cs_conv3x3_im2col_gemm_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, w_eq, w_pole, b_eq, b_pole, out)),
            b, n, cin, cout, p.cfg, p.bks, p.tpw, ga, gb, int(cout % 8 == 0), p.smem, sizes=11,
        )


class _NpackTilesKernel(_MmaConvKernel):
    """#3: the kn2row tile kernel (:func:`npack_plan`) on bfloat16 CUDA
    tensors, taps (Cin, 9*Cout)."""

    def __init__(self, name):
        super().__init__(name, "npack", cs_conv3x3_npack_plain)

    def _launch_kernel(self, dev, x, ext, w_eq, w_pole, b_eq, b_pole, out, plan=None):
        b, _, n, _, cin = x.shape
        cout = out.shape[-1]
        p = plan or npack_plan(b, n, cin, cout, self._sm_count[dev])
        ga, gb = _copy_granules(x, ext, w_eq, w_pole, cin, cout)
        self._launch(
            "cs_conv3x3_npack_tiles_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, w_eq, w_pole, b_eq, b_pole, out)),
            b, n, cin, cout, p.h, p.bn, p.wbufs, ga, gb, int(cout % 8 == 0), p.smem, sizes=11,
        )


class _DxRingKernel(KernelWrapper):
    def __call__(self, dout, k_eq, k_pole):
        """``dout`` (B, 6, n, n, Cout) and HWIO kernels (3, 3, Cin, Cout) of
        its dtype -> ``(dx, dring)``, see :func:`cs_conv3x3_dx_ring_plain`."""
        if dout.device.type == "cpu":
            return cs_conv3x3_dx_ring_plain(dout, k_eq, k_pole)
        check_faces(self.name, dout)
        b, _, n, _, cout = dout.shape
        cin = k_eq.shape[2]
        check_cuda_args(self.name, dout, {
            "dout": (dout, (b, 6, n, n, cout)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
        })
        dev = self._device(dout)
        plan = dx_plan_args(dout.dtype, b, n, cin, cout, self._sm_count[dev])
        dx = torch.empty((b, 6, n, n, cin), dtype=dout.dtype, device=dout.device)
        dring = torch.empty((b, 6, 4, n + 2, cin), dtype=dout.dtype, device=dout.device)
        self._launch(
            "cs_conv3x3_dx_ring_launch", dev, DTYPES[dout.dtype], dev,
            *(t.data_ptr() for t in (dout, k_eq, k_pole, dx, dring)),
            b, n, cin, cout, *plan, sizes=9,
        )
        return dx, dring


class _CudaCoreConvKernel(KernelWrapper):
    def __call__(self, x, ext, k_eq, k_pole, b_eq, b_pole):
        """The CUDA-core forward kernel; arguments and result as
        :data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3`."""
        if x.device.type == "cpu":
            return cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole)
        check_faces(self.name, x)
        b, _, rows, cols, cin = x.shape
        if rows > cols:
            raise ValueError(f"{self.name}: a block of {rows} rows x {cols} columns; H <= W")
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
            "cs_conv3x3_cc_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, k_eq, k_pole, b_eq, b_pole, out)),
            b, rows, cols, cin, cout, h, cs, sizes=7,
        )
        return out


class _CudaCoreDxKernel(KernelWrapper):
    def __call__(self, dout, k_eq, k_pole, raw=False):
        """The CUDA-core dx kernel: ``(dx, d_ext)`` as
        :data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_dx`, or with
        ``raw`` ``(dx, dring)`` as :data:`cs_conv3x3_dx_ring`."""
        if dout.device.type == "cpu":
            plain = cs_conv3x3_dx_ring_plain if raw else cs_conv3x3_dx_plain
            return plain(dout, k_eq, k_pole)
        check_faces(self.name, dout)
        b, _, n, _, cout = dout.shape
        cin = k_eq.shape[2]
        check_cuda_args(self.name, dout, {
            "dout": (dout, (b, 6, n, n, cout)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
        })
        dev = self._device(dout)
        h, cs = tile_plan(b, n + 2, n + 2, cin, self._sm_count[dev], max_cs=_DX_MAX_CS)
        dx = torch.empty((b, 6, n, n, cin), dtype=dout.dtype, device=dout.device)
        ring = torch.empty((b, 6, 4, n + 2, cin), dtype=dout.dtype, device=dout.device)
        self._launch(
            "cs_conv3x3_dx_cc_launch", dev, DTYPES[dout.dtype], dev,
            *(t.data_ptr() for t in (dout, k_eq, k_pole, dx, ring)),
            int(raw), b, n, cin, cout, h, cs, sizes=6,
        )
        return dx, ring


class _CudaCoreDwKernel(_Conv3x3DwKernel):
    """The CUDA-core dw kernel in either dtype: arguments and result as
    :data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_dw`."""

    _cudacore = True


class _RingFixesCudaCore(KernelWrapper):
    def __call__(self, ext, k_eq, k_pole):
        """The CUDA-core fixes kernel; arguments and result as
        :data:`~dlwp_cs_tpu_torch.ops.ring_kernel.ring_fixes`."""
        if ext.device.type == "cpu":
            return ring_fixes_plain(ext, k_eq, k_pole)
        b, n, cin, d, k_eq, k_pole = _strips_shape(self.name, ext, k_eq, k_pole)
        dev = self._device(ext)
        fixes = torch.empty((b, 6, 4, n, d), dtype=ext.dtype, device=ext.device)
        corners = torch.empty((b, 6, 4, d), dtype=ext.dtype, device=ext.device)
        self._launch(
            "cs_ring_fixes_launch", dev, DTYPES[ext.dtype], dev,
            *(t.data_ptr() for t in (ext, k_eq, k_pole, fixes, corners)),
            b, n, cin, d, _RING_TILE, 0,
        )
        return fixes, corners


class _XringApplyCudaCore(KernelWrapper):
    def __call__(self, base_eq, base_po, ext, k_eq, k_pole):
        """The CUDA-core fused apply; arguments and result as
        :data:`~dlwp_cs_tpu_torch.ops.ring_kernel.xring_fused_apply`."""
        if base_eq.device.type == "cpu":
            return xring_fused_apply_plain(base_eq, base_po, ext, k_eq, k_pole)
        b, n, cin, d, k_eq, k_pole = _bases_shape(self.name, base_eq, base_po, ext, k_eq,
                                                  k_pole)
        dev = self._device(ext)
        out = torch.empty_like(base_eq)
        self._launch(
            "cs_xring_apply_launch", dev, DTYPES[ext.dtype], dev,
            *(t.data_ptr() for t in (base_eq, base_po, ext, k_eq, k_pole, out)),
            b, n, cin, d, _RING_TILE, _copy_vec(d, base_eq, base_po, out),
        )
        return out


cs_conv3x3_npack = _NpackTilesKernel("cs_conv3x3_npack")
# the kn2row kernel of the first design (a timing row)
cs_conv3x3_npack_v1 = _MmaConvKernel("cs_conv3x3_npack_v1", "npack", cs_conv3x3_npack_plain)
cs_conv3x3_im2col = _Im2colGemmKernel("cs_conv3x3_im2col")
# the im2col kernel of the first design (a timing row)
cs_conv3x3_im2col_v1 = _MmaConvKernel("cs_conv3x3_im2col_v1", "im2col", cs_conv3x3_im2col_plain)
# kernel #12: kernel #1 on strips computed outside it, counted apart
cs_conv3x3_kernel_only = _Conv3x3Kernel("cs_conv3x3_kernel_only", _FWD_LIB)
cs_conv3x3_dx_ring = _DxRingKernel("cs_conv3x3_dx_ring", _BWD_LIB)
# the CUDA-core tap loops of #1 and #4 in either dtype (a timing row)
cs_conv3x3_cudacore = _CudaCoreConvKernel("cs_conv3x3_cudacore", _FWD_LIB)
cs_conv3x3_dx_cudacore = _CudaCoreDxKernel("cs_conv3x3_dx_cudacore", _BWD_LIB)
cs_conv3x3_dw_cudacore = _CudaCoreDwKernel("cs_conv3x3_dw_cudacore", _BWD_LIB)
# the CUDA-core ring kernels of #6 and #7 (a timing row)
ring_fixes_cudacore = _RingFixesCudaCore("ring_fixes_cudacore", _RING_LIB)
xring_fused_apply_cudacore = _XringApplyCudaCore("xring_fused_apply_cudacore", _RING_LIB)
