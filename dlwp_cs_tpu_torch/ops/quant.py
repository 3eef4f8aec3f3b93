"""Quantized int8 cubed-sphere convolution (inference only).

The counterpart of ``dlwp_cs_tpu.ops.quant``, selected by
``conv_backend="int8"`` or ``ForecastService(quantize=True)``:

* the base convs in int8: a per-tensor activation scale (amax / 127, over
  the whole ``(B, 6, n, n, Cin)`` input, so co-batched requests share it),
  per-output-channel symmetric weight scales, zero-padded SAME convs with
  the faces folded into the batch, s8 x s8 -> s32 sums, dequantized as
  ``float(acc) * (sx * sk)`` and rounded to the input's dtype;
* the halo correction (:func:`~dlwp_cs_tpu_torch.ops.ringfix.ring_term`) and
  the bias on the unquantized activations, in the input's dtype.

Weights are quantized at every call from the float parameters; nothing is
stored.  The base term carries no gradient (its rounding and integer
products have none); ``ring_term`` and the bias do.

The base conv is :data:`cs_conv3x3_int8_base`: on a CUDA tensor the
hand-written ``csrc/cs_conv3x3_int8.cu`` (``mma.sync`` m16n8k32 s8 on the
tensor cores; it computes only the weight group each face keeps, one launch
a conv), on a CPU tensor its plain version :func:`cs_conv3x3_int8_plain`.
The integer sums are exact, so the two are bitwise equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.cuda_build import (
    DTYPES,
    I32,
    VP,
    CudaLibrary,
    KernelWrapper,
    check_faces,
)
from dlwp_cs_tpu_torch.ops.ringfix import add_group_bias, ring_term

__all__ = [
    "cs_conv3x3_int8",
    "cs_conv3x3_int8_base",
    "cs_conv3x3_int8_plain",
    "quantize_kernel",
    "quantize_tensor",
]


def quantize_tensor(x):
    """Per-tensor symmetric int8: ``(q, scale)`` with ``q * scale ~= x``
    (float32 arithmetic in the reference's order; ``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel(k):
    """Per-output-channel symmetric int8 for an HWIO kernel:
    ``(q, scales[Cout])``."""
    kf = k.float()
    amax = kf.abs().amax(dim=(0, 1, 2))
    scales = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(kf / scales), -127, 127).to(torch.int8)
    return q, scales


def cs_conv3x3_int8_plain(qx, qk, scale, dtype):
    """The base conv in plain torch: ``qx`` (B, 6, n, n, Cin) int8, ``qk``
    (2, 3, 3, Cin, Cout) int8 HWIO kernels [equatorial, polar], ``scale`` (2,
    Cout) float32 -> ``(B, 6, n, n, Cout)`` of ``dtype``: each group's
    zero-padded SAME conv on its faces (0-3, 4-5) as an ``F.conv2d`` in
    float64 on the int8 values (exact: every product and partial sum is an
    integer below 2**53), cast to int32, then ``float(acc) * scale[g]``
    rounded to ``dtype``."""
    outs = []
    for g, faces in ((0, slice(0, 4)), (1, slice(4, 6))):
        xg = qx[:, faces]
        b, f, n, _, cin = xg.shape
        acc = F.conv2d(xg.reshape(b * f, n, n, cin).permute(0, 3, 1, 2).double(),
                       qk[g].permute(3, 2, 0, 1).double(), padding=1)
        # round(): a float64 conv algorithm that transforms (FFT, Winograd)
        # lands within 1e-6 of the integer; the direct sum is exact
        acc = acc.round().to(torch.int32).permute(0, 2, 3, 1).reshape(b, f, n, n, -1)
        outs.append((acc.float() * scale[g]).to(dtype))
    return torch.cat(outs, dim=1)


_INT8_LIB = CudaLibrary("cs_conv3x3_int8.cu", {
    "cs_conv3x3_int8_launch": [I32, I32, VP, VP, VP, VP, I32, I32, I32, I32, VP],
}, "cs_conv3x3_int8_error_string")


class _Int8ConvKernel(KernelWrapper):
    def __call__(self, qx, qk, scale, dtype):
        """The base conv: ``qx`` (B, 6, n, n, Cin) int8, ``qk`` (2, 3, 3,
        Cin, Cout) int8, ``scale`` (2, Cout) float32 -> ``(B, 6, n, n, Cout)``
        of ``dtype`` (float32 or bfloat16); see :func:`cs_conv3x3_int8_plain`."""
        if qx.device.type == "cpu":
            return cs_conv3x3_int8_plain(qx, qk, scale, dtype)
        check_faces(self.name, qx)
        b, _, n, n2, cin = qx.shape
        cout = qk.shape[-1]
        if n != n2:
            raise ValueError(f"{self.name}: expected square faces, got {tuple(qx.shape)}")
        if dtype not in DTYPES:
            raise ValueError(f"{self.name} writes float32 or bfloat16, not {dtype}")
        for arg, t, want, kind in (("qx", qx, (b, 6, n, n, cin), torch.int8),
                                   ("qk", qk, (2, 3, 3, cin, cout), torch.int8),
                                   ("scale", scale, (2, cout), torch.float32)):
            if tuple(t.shape) != want or t.dtype != kind or t.device != qx.device:
                raise ValueError(f"{arg} must be {kind} {want} on {qx.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name} takes contiguous tensors ({arg} is not)")
        # K (= 9 Cin, the HWIO rows) contiguous per output channel
        wt = qk.reshape(2, 9 * cin, cout).transpose(1, 2).contiguous()
        out = torch.empty((b, 6, n, n, cout), dtype=dtype, device=qx.device)
        dev = self._device(qx)
        self._launch("cs_conv3x3_int8_launch", dev, DTYPES[dtype], dev,
                     *(t.data_ptr() for t in (qx, wt, scale, out)), b, n, cin, cout,
                     sizes=4)
        return out


cs_conv3x3_int8_base = _Int8ConvKernel("cs_conv3x3_int8_base", _INT8_LIB)


def cs_conv3x3_int8(x, k_eq, k_pole, *, bias_eq=None, bias_pole=None):
    """Quantized CS conv, 3x3/stride-1: ``(B, 6, n, n, Cin) -> (..., Cout)``
    in ``x``'s dtype; approximates
    :func:`~dlwp_cs_tpu_torch.ops.ringfix.cs_conv3x3_ringfix` with the base
    convs in int8 (about 1/127 of the activation range per conv)."""
    b, nf, n, n2, _ = x.shape
    if nf != 6 or n != n2:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    with torch.no_grad():
        qx, sx = quantize_tensor(x)
        qke, ske = quantize_kernel(k_eq)
        qkp, skp = quantize_kernel(k_pole)
        # the two scales folded into one multiply per group, formed first
        scale = torch.stack([sx * ske, sx * skp])
        base = cs_conv3x3_int8_base(qx, torch.stack([qke, qkp]), scale, x.dtype)
    # the seam algebra on the unquantized activations
    out = base + ring_term(x, k_eq, k_pole)
    return add_group_bias(out, bias_eq, bias_pole)
