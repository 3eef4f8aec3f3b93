"""Other formulations and launches of the fused 3x3 cubed-sphere conv: the
kernels that the reference's kernel tools time beside its production conv.

* :data:`cs_conv3x3_npack`: kn2row on the tensor cores
  (``csrc/cs_conv3x3_mma.cu``), replacing
  ``dlwp_cs_tpu/ops/pallas_conv.py::_kernel_npack``.  Weights tap-packed
  ``(Cin, 9*Cout)`` as :func:`npack_taps` makes them; per dy, one product of
  the padded face's rows with the dy slice, then the dx-shifted adds of its
  three Cout slices.
* :data:`cs_conv3x3_im2col`: im2col on the tensor cores (the same source),
  replacing ``tools/kernel_variants.py::_kernel_im2col`` without its
  batch->lane packing.  Weights ``(9*Cin, Cout)`` as :func:`im2col_taps`
  makes them; one product of the ``(pixels, 9*Cin)`` column tile with them.
* :data:`cs_conv3x3_kernel_only`: the conv kernel of ``csrc/cs_conv3x3.cu``
  (#1) launched on ghost strips the caller computed, counted apart;
  replaces ``tools/conv_micro.py::_kernel_only``.
* :data:`cs_conv3x3_dx_ring`: the input cotangent on the ``(n+2)^2``
  padded grid as the interior ``dx`` and the raw ring ``[row 0, row n+1,
  column 0, column n+1]``, corners at both ends of the W/E columns: the raw
  instance of the dx kernel of ``csrc/cs_conv3x3_bwd.cu`` (#4), replacing
  ``tools/kernel_variants.py::_dx_aligned_kernel``.

#3 and #13 take bfloat16 only, as the tools run them: a float32 CUDA tensor
raises ``ValueError`` (TF32 would change the numbers, and nothing falls
back).  Each wrapper counts its launches in ``launches``; on a CPU tensor it
returns its plain version (:func:`cs_conv3x3_npack_plain`,
:func:`cs_conv3x3_im2col_plain`, :func:`cs_conv3x3_dx_ring_plain`; #12's is
:func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_plain`), which takes any
float dtype and sums in ``torch.promote_types(dtype, float32)``.
"""

from __future__ import annotations

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
    _FWD_LIB,
    _GROUPS,
    _Conv3x3Kernel,
    _dx_frame_plain,
    _padded_faces,
    tile_plan,
)

__all__ = [
    "cs_conv3x3_dx_ring",
    "cs_conv3x3_dx_ring_plain",
    "cs_conv3x3_im2col",
    "cs_conv3x3_im2col_plain",
    "cs_conv3x3_kernel_only",
    "cs_conv3x3_npack",
    "cs_conv3x3_npack_plain",
    "im2col_taps",
    "mma_plan",
    "npack_taps",
]

# csrc/cs_conv3x3_mma.cu: rows after each staged row, the im2col kernel's
# accumulator tiles per block, and the shared memory a block may opt in to
# on an H100 (232,448 bytes)
_PAD, _IM_TILES, _SMEM_LIMIT = 8, 64, 232448


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


_MMA_LIB = CudaLibrary("cs_conv3x3_mma.cu", {
    "cs_conv3x3_npack_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
    "cs_conv3x3_im2col_launch": [I32, I32] + [VP] * 7 + [I32] * 7 + [VP],
}, "cs_conv3x3_mma_error_string")


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
        h = mma_plan(self.kind, b, n, cin, cout, self._sm_count[dev])
        vec = int(x.data_ptr() % 16 == 0 and ext.data_ptr() % 16 == 0)
        wvec = int(w_eq.data_ptr() % 16 == 0 and w_pole.data_ptr() % 16 == 0)
        out = torch.empty((b, 6, n, n, cout), dtype=x.dtype, device=x.device)
        self._launch(
            f"cs_conv3x3_{self.kind}_launch", dev, DTYPES[x.dtype], dev,
            *(t.data_ptr() for t in (x, ext, w_eq, w_pole, b_eq, b_pole, out)),
            b, n, cin, cout, h, vec, wvec, sizes=7,
        )
        return out


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
        h, cs = tile_plan(b, n + 2, n + 2, cin, self._sm_count[dev], max_cs=_DX_MAX_CS)
        dx = torch.empty((b, 6, n, n, cin), dtype=dout.dtype, device=dout.device)
        dring = torch.empty((b, 6, 4, n + 2, cin), dtype=dout.dtype, device=dout.device)
        self._launch(
            "cs_conv3x3_dx_ring_launch", dev, DTYPES[dout.dtype], dev,
            *(t.data_ptr() for t in (dout, k_eq, k_pole, dx, dring)),
            b, n, cin, cout, h, cs,
        )
        return dx, dring


cs_conv3x3_npack = _MmaConvKernel("cs_conv3x3_npack", "npack", cs_conv3x3_npack_plain)
cs_conv3x3_im2col = _MmaConvKernel("cs_conv3x3_im2col", "im2col", cs_conv3x3_im2col_plain)
# kernel #12: kernel #1 on strips computed outside it, counted apart
cs_conv3x3_kernel_only = _Conv3x3Kernel("cs_conv3x3_kernel_only", _FWD_LIB)
cs_conv3x3_dx_ring = _DxRingKernel("cs_conv3x3_dx_ring", _BWD_LIB)
