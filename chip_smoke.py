#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels, run its kernel tools, serve and
train the flagship U-Net and the ConvLSTM on one GPU, and serve the U-Net
spatially sharded over 4 ranks that share the GPU, through gloo and through
CUDA IPC.

    python3 chip_smoke.py [--out DIR]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), ``nvcc`` and PyTorch built for CUDA.  Phases:

1. print the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build the kernels from ``dlwp_cs_tpu_torch/csrc``, one ``nvcc`` per
   source, all at once: the fused cubed-sphere conv, its backward (the dx
   and dw kernels), the xring conv's ring-fix kernels (the fixes and the
   fused select + apply), the band-row exchange and the band conv fused
   with it, the conv on the tensor cores (kn2row, im2col) and the probes;
3. at each conv shape of the flagship C48 U-Net (and one n=96 shape with
   many row tiles), at batch 1 and 8, in float32 and bfloat16: hold the
   forward kernel against its plain torch version, and time the kernel, the
   plain version and ``F.conv2d`` (one face-grouped cuDNN call on the padded
   faces) with CUDA events over CUDA-graph replays, beside the least time
   the card could take;
4. the same for the dx and dw kernels at each conv shape at the training
   batch 16, against ``torch.ops.aten.convolution_backward`` of that cuDNN
   conv (its dgrad is the padded-input cotangent, its wgrad summed over each
   face group the kernel gradient);
5. the ring-fix kernels at each distinct conv shape of the flagship U-Net
   and the ConvLSTM's two gate-conv shapes, at batch 1 and 16, in float32
   and bfloat16: both held against their plain versions and timed beside
   their plain versions and bounds; beside them the whole xring conv (two
   cuDNN SAME convs, the ghost strips, the fused kernel, the bias), the
   fused conv kernel and one face-grouped cuDNN call on the same shape;
5b. run the kernel tools' entry points once each (``dlwp_cs_tpu_torch.tools``:
   ``conv_micro``, ``kernel_variants`` and its ``--chain``, ``mosaic_bisect``
   in bfloat16 and float32), the path of kernels #3 and #12-#16, with every
   launch count set to 0 before and read after.  The tools hold each
   kernel's output on their own inputs against its plain version (#12 also
   bitwise against #1, every probe of #16 at the reference scripts' shapes
   with its plain and library times); #12's and #16's lines come from
   these rows.  Then: #3 (kn2row) and #13 (im2col) on the tensor cores,
   bfloat16, at each conv shape of the flagship U-Net at batch 1 and at
   conv_micro's levels and the decoder's shape at batch 16, against their
   plain versions and #1 on the same strips, timed beside #1, the
   face-grouped cuDNN call and the bound; #14 (dx with the raw ring) at
   conv_micro's levels in float32 and bfloat16, its interior and ring
   bitwise equal to #4's, timed beside ``F.conv_transpose2d``; #15 in both
   types bitwise equal to 3·x, timed beside ``x * 3``;
6. serve 14-day forecasts (28 calls of 6 h x 2) through ``ForecastService``
   in bfloat16 and float32 of the flagship C48 U-Net (filters 32/64/128,
   12 -> 8 channels, seeded weights; 280 conv kernel launches per
   forecast) and of the full-width ConvLSTM (filters 32/32, 3x3 gates, 1x1
   head, backend ``xring``; 112 launches of the fused ring kernel): finite
   fields, the first two model calls equal to the plain path on the card, 8
   concurrent submits coalesced into at most 2 dispatches and equal to
   direct forecasts;
7. at each 3x3 shape of the flagship U-Net cut into 4 row bands (h = 12,
   6, 3 at n = 48, 24, 12) and into 2x2 tiles (24^2, 12^2, 6^2), at batch 1
   and 8, in float32 and bfloat16: hold the band and tile launches of the
   forward kernel (#8, #9) against its plain version on the same block and
   ghost strips, and time them beside the plain version, one face-grouped
   cuDNN call on the padded block and the bound;
8. train both models in bfloat16 and float32 at batch 16 with Adam (lr
   1e-3) on MSE: a ``MemoryStore`` of seeded fields -> ``SeriesDataset`` ->
   ``prefetch_to_device`` -> ``Trainer.fit`` for 20 optimizer steps (U-Net:
   10 forward, 10 dw and 9 dx launches a step; ConvLSTM: 4 fused ring
   kernel launches a step and no backward kernel); step 1's gradients
   finite and non-zero for every parameter, equal to the plain path's on
   the card and bitwise repeatable; 20 finite losses; a loss that falls
   when the trainer fits one fixed batch; the step time and the device's
   busy and idle time in one profiled step; for the float32 U-Net, step 1's
   gradients also through the plain path in float64, each float32 path's
   error against them per tensor, and the leaky-ReLU pre-activations whose
   sign differs between the runs;
9. spawn 4 ranks in a gloo group on the card (kernel libraries built
   before) and, in bfloat16 and float32, serve 14-day forecasts of the
   flagship U-Net (the same seeded weights on every rank): at batch 1
   through ``make_spatial_apply`` driven by ``TimeSeriesEstimator`` on a
   (1, 4) mesh with ``band_conv="pallas"`` (280 launches of #8 per rank),
   with ``band_impl="rdma", band_conv="pallas"`` (280 of #10 and 280 of
   #8: the band rows by remote copies into the neighbours' buffers, mapped
   by CUDA IPC) and with ``band_conv="overlap"`` (280 of #11: the band conv
   with the band-row exchange in the launch, nothing else), and on a (1,
   2, 2) mesh (280 of #9), and at batch 3 through
   ``ForecastService(mesh=create_mesh(data=2, spatial=2))`` (the band
   ring-fix conv, data-axis padding, no kernel); each held, on every rank,
   against the one-card forecast in units of the field's std (the kernel
   paths, #11's included, which sums every output in #8's order, to 1e-6
   in float32 and 2**-6 of the value in bfloat16, the service to 1e-3 and
   2**-3), with the wall time of 4 ranks sharing one card and the gloo
   collectives each rank issued; before them, on every rank, #10 and #11
   at each flagship conv shape on 4 bands, batch 1 and 8, both dtypes:
   #10 bitwise against the ``ppermute`` pair, #11 against its plain version
   (and beside #8 on the exchanged strips), their device times per call
   (time slices of the other ranks included), the plain versions' and
   cuDNN's times and the bounds; and the host time of one ghost-strip
   ``all_gather``, of one band and one tile conv with its exchange, of the
   band rows by the ``ppermute`` pair and by #10, of a band conv with #10
   and of a #11 conv; then a group of 2 ranks: #10 at the same rows;
10. print the kernel line (JSON), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, in any rank, so the script exits non-zero and
prints no result.
Details go to ``DIR/chip_smoke.json`` (default ``chip_smoke_out``).  TF32 is
off for cuDNN and matmuls throughout: every float32 result here is compared
(the xring conv's SAME convs run in full float32 whatever the flags say).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from concurrent.futures import ThreadPoolExecutor
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# (n, Cin, Cout) of the 10 3x3 convs of one flagship C48 U-Net call, in order
FLAGSHIP_CONVS = [
    (48, 12, 32), (48, 32, 32),      # enc0
    (24, 32, 64), (24, 64, 64),      # enc1
    (12, 64, 128), (12, 128, 128),   # enc2 (bottleneck)
    (24, 192, 64), (24, 64, 64),     # dec1 (after the skip concat)
    (48, 96, 32), (48, 32, 32),      # dec0
]
EXTRA_SHAPES = [(96, 64, 64)]  # several row tiles per face
# (n, Cin, Cout) of the ConvLSTM's gate convs: [x_t (4 variables +
# insolation + 2 constants), h (32)] -> 4 x 32 gates, then [h1, h2]; one
# model call runs each twice (2 input times)
CONVLSTM_GATES = [(48, 39, 128), (48, 64, 128)]
CONVLSTM_CALL = [CONVLSTM_GATES[0]] * 2 + [CONVLSTM_GATES[1]] * 2
STEPS = 28  # 14 days of 2 x 6 h per call
# sharded forecasts at batch 1: (name, mesh, make_spatial_apply options)
SHARDED_PATHS = [
    ("band", "band", dict(band_conv="pallas")),  # #8, the ppermute pair
    ("tile", "tile", dict(band_conv="pallas")),  # #9
    ("band_rdma", "band", dict(band_impl="rdma", band_conv="pallas")),  # #10 + #8
    ("band_overlap", "band", dict(band_conv="overlap")),  # #11
]
TRAIN_BATCH = 16
TRAIN_STEPS = 20
KERNEL_NAMES = ("cs_conv3x3_kernel", "cs_conv3x3_dx_kernel", "cs_conv3x3_dw_kernel",
                "cs_ring_fixes_kernel", "cs_xring_apply_kernel")
SHARDS = 4  # ranks of the sharded phase: 4 row bands, or 2 x 2 tiles
# the sharded forecasts against the one-card one over 14 days, per point
# |diff| <= rel * |ref| + abs in units of the field's std.  The service's
# band ring-fix conv sums float32 in another order and rounds bfloat16 at
# other points, carried through 28 calls.  Kernels #8, #9 and #11 sum each
# output as #1 does: 1e-6 in float32, and in bfloat16 2**-6 of the value (two
# to four bfloat16 ulps).  (rel, abs) by (path, dtype):
SHARDED_TOL = {("service", "float32"): (0.0, 1e-3), ("service", "bfloat16"): (0.0, 2.0**-3),
               ("kernel", "float32"): (0.0, 1e-6), ("kernel", "bfloat16"): (2.0**-6, 1e-6)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def conv_case(n, cin, cout, b, dtype, gen):
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    ext = ext_strips(x)
    args = (x, ext, *ks, *bs)
    ours = cs_conv3x3(*args)
    ref = cs_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = float((ours.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        tol = "1e-4 abs"
        ok = err <= 1e-4
    else:
        tol = "2**-7*|ref| + 1e-4"
        ok = bf16_excess(ours, ref) <= 1e-4
    # one cuDNN call computing the same function: the padded faces (built
    # outside the timed region) through a conv grouped by face
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    lib = F.conv2d(p, w, bias, groups=6)
    lib = lib.reshape(b, 6, cout, n, n).permute(0, 1, 3, 4, 2)
    lib_err = float((lib.float() - ref.float()).abs().max())
    before = cs_conv3x3.launches
    ms = graph_ms(lambda: cs_conv3x3(*args), 20)
    cs_conv3x3.launches = before  # timing launches are not the main path's
    plain_ms = graph_ms(lambda: cs_conv3x3_plain(*args), 3)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    item = x.element_size()
    nbytes = item * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                     + b * 6 * n * n * cout)
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    return {
        "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "tolerance": tol, "ok": ok, "library_max_abs_err": lib_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes, ops, dtype),
    }


def bwd_case(n, cin, cout, b, dtype, gen):
    """The dx and dw kernels at one conv shape: ``(dx_case, dw_case)``."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        cs_conv3x3_dw,
        cs_conv3x3_dw_plain,
        cs_conv3x3_dx,
        cs_conv3x3_dx_plain,
    )
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import (
        HBM_BYTES_PER_S, PEAK_OPS, bf16_excess, face_grouped, graph_ms)

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    g = torch.randn((b, 6, n, n, cout), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    ext = ext_strips(x)
    launches = (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
    dx, d_ext = cs_conv3x3_dx(g, *ks)
    dw = cs_conv3x3_dw(x, ext, g)
    ref_dx, ref_ext = cs_conv3x3_dx_plain(g, *ks)
    ref_dw = cs_conv3x3_dw_plain(x, ext, g)
    torch.cuda.synchronize()
    dx_err = max(float((a.float() - r.float()).abs().max())
                 for a, r in ((dx, ref_dx), (d_ext, ref_ext)))
    if dtype == torch.float32:
        dx_tol, dx_ok = "1e-4 abs", dx_err <= 1e-4
    else:
        dx_tol = "2**-7*|ref| + 1e-4"
        dx_ok = max(bf16_excess(dx, ref_dx), bf16_excess(d_ext, ref_ext)) <= 1e-4
    # f32 sums over every pixel of a face group, in another order
    dw_err = max(float((a - r).abs().max()) for a, r in zip(dw, ref_dw))
    dw_scale = max(float(r.abs().max()) for r in ref_dw)
    dw_ok = dw_err <= 1e-5 * dw_scale
    # one cuDNN call each: convolution_backward of the face-grouped conv on
    # the padded faces (dgrad = the padded-input cotangent; wgrad per face)
    p, w = face_grouped(cs_pad(x, 1), ks)
    go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
    conv_bwd = torch.ops.aten.convolution_backward

    def lib(mask):
        return conv_bwd(go, p, w, [6 * cout], [1, 1], [0, 0], [1, 1], False, [0, 0], 6, mask)

    lib_dk = lib([False, True, True])[1].reshape(6, cout, cin, 3, 3).permute(0, 3, 4, 2, 1)
    lib_dw_err = float((lib_dk[:4].float().sum(0) - ref_dw[0]).abs().max())
    ms_dx = graph_ms(lambda: cs_conv3x3_dx(g, *ks), 10)
    ms_dw = graph_ms(lambda: cs_conv3x3_dw(x, ext, g), 10)
    cs_conv3x3_dx.launches, cs_conv3x3_dw.launches = launches  # not the main path's
    plain_dx = graph_ms(lambda: cs_conv3x3_dx_plain(g, *ks), 2)
    plain_dw = graph_ms(lambda: cs_conv3x3_dw_plain(x, ext, g), 2)
    lib_dx = graph_ms(lambda: lib([True, False, False]), 10)
    lib_dw = graph_ms(lambda: lib([False, True, True]), 10)
    item = x.element_size()
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    common = {"n": n, "cin": cin, "cout": cout, "batch": b,
              "dtype": str(dtype).split(".")[-1], "ops": ops}
    out = []
    for kind, err, tol, ok, ms, plain_ms, lib_ms, nbytes, extra in (
        ("dx", dx_err, dx_tol, dx_ok, ms_dx, plain_dx, lib_dx,
         item * (g.numel() + 2 * ks[0].numel() + dx.numel() + d_ext.numel()), {}),
        ("dw", dw_err, "1e-5 * max|ref|", dw_ok, ms_dw, plain_dw, lib_dw,
         item * (x.numel() + ext.numel() + g.numel()) + 4 * (2 * ks[0].numel() + 2 * cout),
         {"ref_abs_max": dw_scale, "library_dk_eq_max_abs_err": lib_dw_err}),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(common, kernel=kind, max_abs_err=err, tolerance=tol, ok=ok, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations", **extra))
    return out


def ring_case(n, cin, d, b, dtype, gen):
    """The ring-fix kernels (#6 fixes, #7 fused apply) at one gate-conv
    shape, against their plain versions; the whole xring conv beside the
    fused conv kernel and one face-grouped cuDNN call on the same shape."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
    from dlwp_cs_tpu_torch.ops.ring_kernel import (
        cs_conv3x3_xring,
        ring_fixes,
        ring_fixes_plain,
        xring_fused_apply,
        xring_fused_apply_plain,
    )
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.ops.ringfix import _same_conv
    from dlwp_cs_tpu_torch.tools.timing import (
        HBM_BYTES_PER_S, PEAK_OPS, bf16_excess, face_grouped, graph_ms)

    dev = torch.device("cuda")
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, d), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    ext = ext_strips(x)
    bases = [_same_conv(x, k) for k in ks]
    launches = (ring_fixes.launches, xring_fused_apply.launches, cs_conv3x3.launches)
    fixes, corners = ring_fixes(ext, *ks)
    out = xring_fused_apply(*bases, ext, *ks)
    ref_fixes, ref_corners = ring_fixes_plain(ext, *ks)
    ref_out = xring_fused_apply_plain(*bases, ext, *ks)
    torch.cuda.synchronize()
    pairs6 = ((fixes, ref_fixes), (corners, ref_corners))
    err6 = max(float((a.float() - r.float()).abs().max()) for a, r in pairs6)
    err7 = float((out.float() - ref_out.float()).abs().max())
    if dtype == torch.float32:
        tol, ok6, ok7 = "1e-4 abs", err6 <= 1e-4, err7 <= 1e-4
    else:
        tol = "2**-7*|ref| + 1e-4"
        ok6 = max(bf16_excess(a, r) for a, r in pairs6) <= 1e-4
        ok7 = bf16_excess(out, ref_out) <= 1e-4
    ms6 = graph_ms(lambda: ring_fixes(ext, *ks), 20)
    ms7 = graph_ms(lambda: xring_fused_apply(*bases, ext, *ks), 20)
    plain6 = graph_ms(lambda: ring_fixes_plain(ext, *ks), 3)
    plain7 = graph_ms(lambda: xring_fused_apply_plain(*bases, ext, *ks), 3)
    # the whole xring conv (forward) beside kernel #1 and cuDNN on this shape
    with torch.no_grad():
        xring_ms = graph_ms(lambda: cs_conv3x3_xring(x, *ks, *bs), 10)
    fused_ms = graph_ms(lambda: cs_conv3x3(x, ext, *ks, *bs), 10)
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    cudnn_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    # timing launches are not the main path's
    ring_fixes.launches, xring_fused_apply.launches, cs_conv3x3.launches = launches
    item = x.element_size()
    ops = 2 * b * 6 * (12 * n + 4) * cin * d
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    taps = 2 * 8 * cin * d  # the 8 outer taps of each weight group
    common = {"n": n, "cin": cin, "cout": d, "batch": b,
              "dtype": str(dtype).split(".")[-1], "ops": ops, "tolerance": tol}
    cases = []
    for kind, err, ok, ms, plain_ms, nbytes in (
        ("fixes", err6, ok6, ms6, plain6,
         item * (ext.numel() + taps + fixes.numel() + corners.numel())),
        # one base read (the face's own), the output written
        ("apply", err7, ok7, ms7, plain7,
         item * (2 * out.numel() + ext.numel() + taps)),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        cases.append(dict(common, kernel=kind, max_abs_err=err, ok=ok, ms=ms,
                          plain_ms=plain_ms, library_ms=None, bytes=nbytes,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          xring_conv_ms=xring_ms, fused_conv_ms=fused_ms,
                          cudnn_conv_ms=cudnn_ms))
    return cases


def block_case(kind, n, cin, cout, b, dtype, gen):
    """Kernel #8 (``kind`` band: n/4 rows x n columns) or #9 (tile: n/2 x
    n/2) at one conv shape of the flagship U-Net, against its plain version
    on the same block and ghost strips; beside it one face-grouped cuDNN
    call on the padded block."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        _padded_faces,
        cs_conv3x3_band,
        cs_conv3x3_plain,
        cs_conv3x3_tile,
    )
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    wrapper = cs_conv3x3_band if kind == "band" else cs_conv3x3_tile
    rows, cols = (n // SHARDS, n) if kind == "band" else (n // 2, n // 2)
    dev = torch.device("cuda")
    x = torch.randn((b, 6, rows, cols, cin), generator=gen, device=dev).to(dtype)
    # exchanged ghost strips: S/N rows whole, W/E at positions 1..rows
    ext = torch.randn((b, 6, 4, cols + 2, cin), generator=gen, device=dev)
    ext[:, :, 2:, 0] = 0
    ext[:, :, 2:, rows + 1 :] = 0
    ext = ext.to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    args = (x, ext, *ks, *bs)
    before = wrapper.launches
    ours = wrapper(*args)
    ref = cs_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = float((ours.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        tol, ok = "1e-4 abs", err <= 1e-4
    else:
        tol, ok = "2**-7*|ref| + 1e-4", bf16_excess(ours, ref) <= 1e-4
    p, w = face_grouped(_padded_faces(x, ext), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    ms = graph_ms(lambda: wrapper(*args), 20)
    wrapper.launches = before  # timing launches are not the main path's
    plain_ms = graph_ms(lambda: cs_conv3x3_plain(*args), 3)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    item = x.element_size()
    nbytes = item * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                     + b * 6 * rows * cols * cout)
    ops = 2 * b * 6 * rows * cols * 9 * cin * cout
    return {
        "kernel": kind, "n": n, "rows": rows, "cols": cols, "cin": cin, "cout": cout,
        "batch": b, "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tolerance": tol,
        "ok": ok, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(nbytes, ops, dtype),
    }


def mma_cases(n, cin, cout, b, gen):
    """Kernels #3 (kn2row) and #13 (im2col) at one conv shape in bfloat16
    (the only type they take): each against its plain version and against
    kernel #1 on the same strips, one bf16 ulp of |ref| + 1e-4; each timed
    beside #1, the face-grouped cuDNN call and the bound, which is #1's (the
    same function)."""
    from dlwp_cs_tpu_torch.ops.conv_variants import (
        cs_conv3x3_im2col,
        cs_conv3x3_im2col_plain,
        cs_conv3x3_npack,
        cs_conv3x3_npack_plain,
        im2col_taps,
        npack_taps,
    )
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
    from dlwp_cs_tpu_torch.ops.padding import cs_pad
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev, dtype = torch.device("cuda"), torch.bfloat16
    x = torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype)
    scale = (9 * cin) ** -0.5
    ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale).to(dtype)
          for _ in range(2)]
    bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype) for _ in range(2)]
    ext = ext_strips(x)
    wrappers = (cs_conv3x3, cs_conv3x3_npack, cs_conv3x3_im2col)
    launches = [w.launches for w in wrappers]
    conv1 = cs_conv3x3(x, ext, *ks, *bs)
    conv1_ms = graph_ms(lambda: cs_conv3x3(x, ext, *ks, *bs), 20)
    p, w = face_grouped(cs_pad(x, 1), ks)
    bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
    library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
    nbytes = x.element_size() * (x.numel() + ext.numel() + 2 * ks[0].numel() + 2 * cout
                                 + b * 6 * n * n * cout)
    ops = 2 * b * 6 * n * n * 9 * cin * cout
    cases = []
    for kind, wrapper, plain, taps in (
        ("npack", cs_conv3x3_npack, cs_conv3x3_npack_plain, npack_taps),
        ("im2col", cs_conv3x3_im2col, cs_conv3x3_im2col_plain, im2col_taps),
    ):
        tw = [taps(k) for k in ks]
        ours = wrapper(x, ext, *tw, *bs)
        ref = plain(x, ext, *tw, *bs)
        torch.cuda.synchronize()
        ok = bf16_excess(ours, ref) <= 1e-4 and bf16_excess(ours, conv1) <= 1e-4
        cases.append({
            "kernel": kind, "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": "bfloat16",
            "max_abs_err": float((ours.float() - ref.float()).abs().max()),
            "vs_conv_kernel_max_abs_err": float((ours.float() - conv1.float()).abs().max()),
            "tolerance": "2**-7*|ref| + 1e-4 (plain and #1)", "ok": ok,
            "ms": graph_ms(lambda: wrapper(x, ext, *tw, *bs), 20),
            "plain_ms": graph_ms(lambda: plain(x, ext, *tw, *bs), 3),
            "library_ms": library_ms, "conv_kernel_ms": conv1_ms,
            **bound(nbytes, ops, dtype),
        })
    for wr, count in zip(wrappers, launches):  # timing launches are not the main path's
        wr.launches = count
    return cases


def dx_ring_cases(gen):
    """Kernel #14 at conv_micro's levels, float32 and bfloat16: against its
    plain version (f32 1e-4; bf16 one ulp + 1e-4), its interior bitwise
    equal to #4's dx, its S/N rows and its W/E columns at rows 1..n bitwise
    equal to #4's d_ext; timed beside #4, the plain version, the bound and
    one ``F.conv_transpose2d`` of dout on the face-grouped layout, which
    gives the whole (n+2)^2 cotangent."""
    from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_dx_ring, cs_conv3x3_dx_ring_plain
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_dx
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS
    from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS, bound
    from dlwp_cs_tpu_torch.tools.timing import bf16_excess, bound, face_grouped, graph_ms

    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, cin, cout, b in LEVELS:
            g = torch.randn((b, 6, n, n, cout), generator=gen, device=dev).to(dtype)
            ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                   * (9 * cout) ** -0.5).to(dtype) for _ in range(2)]
            launches = (cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches)
            dx, dring = cs_conv3x3_dx_ring(g, *ks)
            dx4, d_ext = cs_conv3x3_dx(g, *ks)
            ref_dx, ref_ring = cs_conv3x3_dx_ring_plain(g, *ks)
            torch.cuda.synchronize()
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in ((dx, ref_dx), (dring, ref_ring)))
            if dtype == torch.float32:
                tol, close = "1e-4 abs", err <= 1e-4
            else:
                tol = "2**-7*|ref| + 1e-4"
                close = max(bf16_excess(dx, ref_dx), bf16_excess(dring, ref_ring)) <= 1e-4
            same = (torch.equal(dx, dx4) and torch.equal(dring[:, :, :2], d_ext[:, :, :2])
                    and torch.equal(dring[:, :, 2:, 1 : n + 1], d_ext[:, :, 2:, 1 : n + 1]))
            # one cuDNN call: the transposed conv of dout (B, 6*Cout, n, n) by
            # the face-grouped kernels gives the padded cotangent (B, 6*Cin, n+2, n+2)
            go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
            go = go.contiguous(memory_format=torch.channels_last)
            _, w = face_grouped(g.new_zeros((b, 6, 1, 1, cin)), ks)
            frame = F.conv_transpose2d(go, w, groups=6)
            frame = frame.reshape(b, 6, cin, n + 2, n + 2).permute(0, 1, 3, 4, 2)
            lib_err = float((frame[:, :, 1 : n + 1, 1 : n + 1].float() - ref_dx.float())
                            .abs().max())
            nbytes = g.element_size() * (g.numel() + 2 * ks[0].numel() + dx.numel()
                                         + dring.numel())
            ops = 2 * b * 6 * n * n * 9 * cin * cout
            cases.append({
                "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tolerance": tol, "equal_to_dx_kernel": same,
                "library_max_abs_err": lib_err, "ok": close and same,
                "ms": graph_ms(lambda: cs_conv3x3_dx_ring(g, *ks), 10),
                "dx_kernel_ms": graph_ms(lambda: cs_conv3x3_dx(g, *ks), 10),
                "plain_ms": graph_ms(lambda: cs_conv3x3_dx_ring_plain(g, *ks), 2),
                "library_ms": graph_ms(lambda: F.conv_transpose2d(go, w, groups=6), 10),
                **bound(nbytes, ops, dtype),
            })
            cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches = launches
    return cases


def lane_store_cases(gen):
    """Kernel #15 at the kernel_variants tool's shape (16, 6, 48, 48, 32), in
    float32 and bfloat16: bitwise equal to 3·x; timed beside its plain
    version, ``x * 3`` and the bound (x read once, the output written once)."""
    from dlwp_cs_tpu_torch.tools.probes import lane_store, lane_store_plain
    from dlwp_cs_tpu_torch.tools.timing import bound, graph_ms

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((16, 6, 48, 48, 32), generator=gen, device="cuda").to(dtype)
        launches = lane_store.launches
        out = lane_store(x)
        ref = lane_store_plain(x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, 3 * x)) and bool(torch.equal(out, ref))
        nbytes, ops = 2 * x.numel() * x.element_size(), 2 * x.numel()
        cases.append({
            "shape": list(x.shape), "dtype": str(dtype).split(".")[-1], "equal_to_3x": equal,
            "ok": equal, "max_abs_err": float((out.float() - 3 * x.float()).abs().max()),
            "ms": graph_ms(lambda: lane_store(x), 20),
            "plain_ms": graph_ms(lambda: lane_store_plain(x), 5),
            "library_ms": graph_ms(lambda: x * 3, 20),
            **bound(nbytes, ops, dtype),
        })
        lane_store.launches = launches
    return cases


# the kernels of this slice's path (the kernel tools), by wrapper name
TOOL_KERNELS = ("cs_conv3x3_npack", "cs_conv3x3_im2col", "cs_conv3x3_kernel_only",
                "cs_conv3x3_dx_ring", "lane_store", "probe_assemble", "probe_rows_int",
                "probe_rows_slice", "probe_col_int", "probe_col_newaxis", "probe_select",
                "probe_dot", "probe_shifted_dots", "probe_bias", "probe_dw_reshape",
                "probe_dw_batched")
TOOL_RUNS = (("conv_micro", []), ("kernel_variants", []), ("kernel_variants", ["--chain"]),
             ("mosaic_bisect", []), ("mosaic_bisect", ["--dtype", "float32"]))


def tools_main_path():
    """This slice's main path: each kernel tool's entry point run once on
    the card, as ``python -m dlwp_cs_tpu_torch.tools.<name>`` runs it (the
    tools print their rows and raise on a failed check: each kernel's row
    against its plain version on the same inputs, #12 bitwise against #1,
    each probe against its plain version); every count set to 0 before and
    read after.  Counts are wrapper calls, the calls captured into each
    timing CUDA graph included and its replays not.  Returns the launches
    of every kernel, the wall seconds and each run's rows."""
    import importlib

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    results = {}
    for name, argv in TOOL_RUNS:
        print(f"$ python -m dlwp_cs_tpu_torch.tools.{name} {' '.join(argv)}".rstrip(), flush=True)
        mod = importlib.import_module(f"dlwp_cs_tpu_torch.tools.{name}")
        results[" ".join([name, *argv])] = rows = []
        check(mod.main(argv, rows) == 0, f"tools.{name} {argv} returned non-zero")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    idle = [name for name in TOOL_KERNELS if launches[name] == 0]
    check(not idle, f"the kernel tools launched no {idle}")
    return launches, seconds, results


def f64_gradients(cfg, model, trainer, params, xb, yb, grads, plain):
    """Step 1's gradients once more through the plain path in float64, from
    the same parameters and batch cast to float64 (the model's output is
    still cast to float32 at its end, a 6e-8 relative rounding).  The
    leaky ReLU has a kink at 0: a pre-activation within rounding of 0 may
    take the other slope (0.1 or 1) in a float32 run than in float64, which
    moves the gradients of every layer upstream of it by far more than
    rounding.  So three float64 references: with its own kinks, and with
    the kinks (the signs of the pre-activations, by forward hooks on the
    convs) of the float32 kernel run and of the float32 plain run, forced.
    Returns per tensor each float32 path's largest error against each,
    relative to the tensor's largest entry, and per layer the
    pre-activations of another sign between the runs."""
    import dataclasses

    from dlwp_cs_tpu_torch.models import build_model
    from dlwp_cs_tpu_torch.train import model_apply, value_and_grad

    model64 = build_model(dataclasses.replace(cfg.resolved_model(), compute_dtype="float64"),
                          cfg.data.input_channels, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    layers = [name for name in model.convs if name != "head"]
    slope = cfg.resolved_model().activation_slope

    def run(net, vg, *args, kinks=None):
        """(gradients, {layer: pre-activation}) of one step; ``kinks``:
        ``{layer: pre > 0}`` of another run, whose slopes the leaky ReLU
        takes here."""
        pre, order = {}, []

        def record(name, out):  # a forward hook that returns None keeps the output
            pre[name] = out.detach()
            order.append(name)

        hooks = [net.convs[name].register_forward_hook(
            lambda mod, inp, out, name=name: record(name, out)) for name in layers]
        act = net.act
        if kinks is not None:
            net.act = lambda z: z * torch.where(kinks[order[-1]], 1.0, slope).to(z.dtype)
        try:
            out = vg(*args)[1]
        finally:
            for h in hooks:
                h.remove()
            net.act = act
        return out, pre

    vg = value_and_grad(trainer.apply_fn, trainer.loss_fn)
    vg64 = value_and_grad(model_apply(model64), trainer.loss_fn)
    params64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    args64 = (params64, xb.double(), yb.double())
    _, pre_k = run(model, vg, params, xb, yb)
    with plain_convs():
        _, pre_p = run(model, vg, params, xb, yb)
        g64, pre_64 = run(model64, vg64, *args64)
        g64_k, _ = run(model64, vg64, *args64, kinks={n: v > 0 for n, v in pre_k.items()})
        g64_p, _ = run(model64, vg64, *args64, kinks={n: v > 0 for n, v in pre_p.items()})
    torch.cuda.synchronize()

    def rel(a, ref):
        return float((a.double() - ref).abs().max()) / float(ref.abs().max())

    per_tensor = {k: {
        "kernel_vs_f64": rel(grads[k], g64[k]), "plain_vs_f64": rel(plain[k], g64[k]),
        "kernel_vs_f64_same_kinks": rel(grads[k], g64_k[k]),
        "plain_vs_f64_same_kinks": rel(plain[k], g64_p[k]),
        "kernel_vs_plain": float((grads[k] - plain[k]).abs().max() / plain[k].abs().max()),
    } for k in grads}
    flips = {name: {
        "kernel_vs_f64": int(((pre_k[name] > 0) != (pre_64[name] > 0)).sum()),
        "plain_vs_f64": int(((pre_p[name] > 0) != (pre_64[name] > 0)).sum()),
        "kernel_vs_plain": int(((pre_k[name] > 0) != (pre_p[name] > 0)).sum()),
        "values": pre_64[name].numel(),
    } for name in layers}
    return {"per_tensor": per_tensor, "sign_flips": flips}


@contextlib.contextmanager
def plain_convs():
    """Route the models' 3x3 convs through the kernels' plain versions: the
    fused conv (differentiable by autograd, so the U-Net's backward is plain
    too) and the xring conv's fused ring kernel (its backward is torch)."""
    from dlwp_cs_tpu_torch.ops import conv as conv_mod
    from dlwp_cs_tpu_torch.ops import ring_kernel as ring_mod
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain

    saved = conv_mod.cs_conv3x3_fused, ring_mod.xring_fused_apply
    conv_mod.cs_conv3x3_fused = cs_conv3x3_plain
    ring_mod.xring_fused_apply = ring_mod.xring_fused_apply_plain
    try:
        yield
    finally:
        conv_mod.cs_conv3x3_fused, ring_mod.xring_fused_apply = saved


def all_kernels():
    """Every kernel wrapper, by name: the nine of the serving, training and
    sharded paths, then the kernel tools' (``TOOL_KERNELS``)."""
    from dlwp_cs_tpu_torch.ops import conv_variants
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        cs_conv3x3,
        cs_conv3x3_band,
        cs_conv3x3_dw,
        cs_conv3x3_dx,
        cs_conv3x3_tile,
    )
    from dlwp_cs_tpu_torch.ops.ring_kernel import ring_fixes, xring_fused_apply
    from dlwp_cs_tpu_torch.parallel.overlap_band import band_conv3x3_overlap
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_rdma
    from dlwp_cs_tpu_torch.tools import probes

    tools = [getattr(conv_variants, name, None) or getattr(probes, name)
             for name in TOOL_KERNELS]
    return {k.name: k for k in (cs_conv3x3, cs_conv3x3_dx, cs_conv3x3_dw, ring_fixes,
                                xring_fused_apply, cs_conv3x3_band, cs_conv3x3_tile,
                                band_exchange_rdma, band_conv3x3_overlap, *tools)}


def model_config(kind, dtype_name):
    """The full-width model of ``kind``: the flagship U-Net (its kernel
    path) or the ConvLSTM (``ConvLSTMConfig()`` defaults, backend xring)."""
    from dlwp_cs_tpu_torch.models import ConvLSTMConfig, UNetConfig

    if kind == "unet":
        return UNetConfig(compute_dtype=dtype_name)
    return ConvLSTMConfig(compute_dtype=dtype_name, conv_backend="xring")


# launches of each kernel per model call (forecast) and per train step
PER_CALL = {"unet": {"cs_conv3x3": 10}, "convlstm": {"xring_fused_apply": 4}}
PER_STEP = {"unet": {"cs_conv3x3": 10, "cs_conv3x3_dw": 10, "cs_conv3x3_dx": 9},
            "convlstm": {"xring_fused_apply": 4}}


def want_launches(per, count):
    return {name: per.get(name, 0) * count for name in all_kernels()}


def profiled_run_ms(fn):
    """One run of ``fn`` under ``torch.profiler``: ``(wall, busy, kernels,
    n_kernels)``, the run's own host wall clock in ms, the device time of
    all its kernels and that of each of the port's kernels by name
    (``KERNEL_NAMES``) in ms, and the number of kernels the device ran
    (memory copies and sets not counted); all but ``wall`` are None where
    the profiler records no device time.  Only device activity is traced,
    which keeps the profiler's host overhead (in ``wall``) small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    total = 0.0
    count = 0
    ours = dict.fromkeys(KERNEL_NAMES, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only, not the ops launching them
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if not e.key.startswith(("Memcpy", "Memset")):
            count += e.count
        for name in KERNEL_NAMES:
            if name in e.key:
                ours[name] += us / 1e3
    return (wall, total / 1e3, ours, count) if total > 0 else (wall, None, None, None)


def serve_phase(kind, dtype_name, rng):
    """Serve 14-day forecasts of the full-width model of ``kind``."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch import ForecastService

    kernels = all_kernels()
    cfg = ExperimentConfig(data=DataConfig(), model=model_config(kind, dtype_name))
    d = cfg.data
    check((d.grid_n, d.input_channels, d.output_channels) == (48, 12, 8), "flagship shape")
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)  # z500, z1000, tau, t2m
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    est = DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    windows = (rng.normal(size=(8, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(8)  # 2026-06-21 12 UTC onwards
    svc = ForecastService(est, constants=const, max_batch=8, max_wait_ms=200.0)

    svc.forecast(windows[0], t0[0], steps=STEPS)  # warm-up
    for k in kernels.values():
        k.launches = 0
    fc = svc.forecast(windows[0], t0[0], steps=STEPS)
    launches = {name: k.launches for name, k in kernels.items()}
    want = want_launches(PER_CALL[kind], STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    check(fc.fields.shape == (1, 2 * STEPS, 6, 48, 48, 4), f"shape {fc.fields.shape}")
    check(bool(np.isfinite(fc.fields).all()), "non-finite forecast fields")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        svc.forecast(windows[0], t0[0], steps=STEPS)
        times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: svc.forecast(windows[0], t0[0], steps=2))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_kernels = profiled_run_ms(
        lambda: svc.forecast(windows[0], t0[0], steps=STEPS))
    idle = None if busy_ms is None else 1.0 - busy_ms / prof_ms

    # the first two model calls against the plain path on the card
    normed = (windows[:1] - mean) / std
    two = svc.forecast(normed, t0[0], steps=2, normalized=True).fields
    with plain_convs():
        two_plain = svc.forecast(normed, t0[0], steps=2, normalized=True).fields
    err2 = float(np.abs(two - two_plain).max())
    scale = float(np.abs(two_plain).max())
    tol2 = 1e-4 * scale if dtype_name == "float32" else 2.0**-6 * scale
    check(err2 <= tol2, f"first two calls differ from the plain path: {err2} > {tol2}")

    # 8 concurrent single-member requests coalesce and equal direct forecasts
    batches0 = svc.stats.batches
    futs = [svc.submit(windows[i], t0[i], steps=STEPS) for i in range(8)]
    results = [f.result(timeout=300) for f in futs]
    dispatches = svc.stats.batches - batches0
    check(dispatches <= 2, f"8 submits took {dispatches} dispatches")
    sub_err = 0.0
    for i, r in enumerate(results):
        direct = svc.forecast(windows[i], t0[i], steps=STEPS).fields
        sub_err = max(sub_err, float((np.abs(r.fields - direct) / std).max()))
    # the kernels' sums do not depend on the batch or the tile plan; only
    # library calls (the head's matmul, the xring conv's cuDNN SAME convs)
    # may pick another algorithm per batch
    sub_tol = 1e-4 if dtype_name == "float32" else 1e-2
    check(sub_err <= sub_tol, f"coalesced vs direct: {sub_err} std > {sub_tol}")
    svc.close()
    return {
        "model": kind, "dtype": dtype_name, "launches_per_forecast": launches,
        "rollout_ms": times, "rollout_ms_median": statistics.median(times),
        "profiled_rollout_ms": prof_ms, "device_busy_ms": busy_ms,
        "kernel_device_ms": kernel_ms, "device_kernels": n_kernels,
        "device_idle_share": idle, "first_two_calls_max_abs_err": err2, "first_two_calls_tolerance": tol2,
        "submit_dispatches": dispatches, "submit_vs_direct_max_err_in_std": sub_err,
        "submit_tolerance_in_std": sub_tol,
        "field_abs_max": float(np.abs(fc.fields).max()),
    }


def train_phase(kind, dtype_name, rng):
    """Train the full-width model of ``kind`` on the card through the port's
    entry points."""
    from dlwp_cs_tpu_torch.data import MemoryStore, SeriesDataset, prefetch_to_device
    from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
    from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, build_model
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.train import Trainer, value_and_grad

    kernels = all_kernels()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, optimizer="adam", learning_rate=1e-3,
                       loss="mse", max_epochs=1, metrics_every=TRAIN_STEPS)
    cfg = ExperimentConfig(data=DataConfig(), model=model_config(kind, dtype_name),
                           train=tcfg)
    d = cfg.data
    # seeded synthetic fields, 6-hourly, enough windows for 20 batches
    n_times = TRAIN_BATCH * TRAIN_STEPS + d.input_time_steps + d.output_time_steps - 1
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    fields = (rng.standard_normal((n_times, 6, 48, 48, 4), dtype=np.float32) * std + mean)
    store = MemoryStore.from_raw(
        fields, 9000.0 + 0.25 * np.arange(n_times), d.variables,
        constants=rng.standard_normal((6, 48, 48, 2), dtype=np.float32),
        constant_names=d.constants)
    lat, lon = CubedSphere(d.grid_n).cell_latlon
    ds = SeriesDataset(store, d, lat=lat, lon=lon, batch_size=TRAIN_BATCH, shuffle=True)
    check(len(ds) == TRAIN_STEPS, f"{len(ds)} batches, want {TRAIN_STEPS}")
    model = build_model(cfg.resolved_model(), d.input_channels, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg)
    x0, y0 = ds.make_batch(ds._starts[:TRAIN_BATCH])
    xb, yb = torch.from_numpy(x0).cuda(), torch.from_numpy(y0).cuda()
    state0 = trainer.init(x0)

    # step 1's gradients: finite and non-zero everywhere, bitwise repeatable,
    # equal to the plain path's on the card
    vg = value_and_grad(trainer.apply_fn, trainer.loss_fn)
    loss_k, grads = vg(state0.params, xb, yb)
    _, again = vg(state0.params, xb, yb)
    with plain_convs():
        loss_p, plain = vg(state0.params, xb, yb)
    torch.cuda.synchronize()
    for name, gr in grads.items():
        check(bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0,
              f"gradient of {name} is not finite and non-zero")
    repeat = all(torch.equal(grads[k], again[k]) for k in grads)
    check(repeat, "two identical steps gave different gradients")
    # per tensor, relative to its largest entry: f32 sums in another order
    # (f32); bf16 activations whose roundings may flip and carry through
    # the layers (bf16)
    grad_tol = 1e-3 if dtype_name == "float32" else 2.0**-4
    grad_err, worst = max((float((grads[k] - plain[k]).abs().max() / plain[k].abs().max()), k)
                          for k in grads)
    f64 = None
    if kind == "unet" and dtype_name == "float32":
        # A leaky-ReLU pre-activation within rounding of 0 takes the other
        # slope in one float32 run than in the other and moves every
        # gradient upstream of it far past rounding (1.37e-3 of a tensor's
        # largest entry once).  So each float32 path is held against the
        # float64 step with its own kinks forced: rounding, 1e-5 per tensor.
        f64 = f64_gradients(cfg, model, trainer, state0.params, xb, yb, grads, plain)
        flips = {name: (f["kernel_vs_f64"], f["plain_vs_f64"], f["kernel_vs_plain"])
                 for name, f in f64["sign_flips"].items()}
        print("train unet float32 step-1 gradients, max |err| / max |f64 ref| per tensor "
              "(kernel path, plain path; against f64 with the path's own kinks: kernel, "
              "plain): " + ", ".join(
                  f"{k} {v['kernel_vs_f64']:.3g} {v['plain_vs_f64']:.3g} "
                  f"{v['kernel_vs_f64_same_kinks']:.3g} {v['plain_vs_f64_same_kinks']:.3g}"
                  for k, v in f64["per_tensor"].items()), flush=True)
        print("train unet float32 leaky-ReLU pre-activations of another sign per layer "
              f"(kernel vs f64, plain vs f64, kernel vs plain): {flips}", flush=True)
        against, check_tol = "the float64 step with the same kinks", 1e-5
        check_err, check_worst = max(
            (max(v["kernel_vs_f64_same_kinks"], v["plain_vs_f64_same_kinks"]), k)
            for k, v in f64["per_tensor"].items())
    else:
        against, check_tol, check_err, check_worst = "the plain path", grad_tol, grad_err, worst
    check(check_err <= check_tol,
          f"step-1 gradients vs {against}: {check_err} > {check_tol} ({check_worst})")

    # the main path: 20 optimizer steps from the store through the trainer
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    state = trainer.fit(state0, lambda: prefetch_to_device(iter(ds)), verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    want = want_launches(PER_STEP[kind], TRAIN_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    check(state.step == TRAIN_STEPS, f"{state.step} steps")
    losses = [r["loss"] for r in trainer.history.steps]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")

    # the trainer fits one fixed batch: the loss falls
    fixed = Trainer(model, tcfg)
    fixed.fit(fixed.init(x0), [(xb, yb)] * TRAIN_STEPS, verbose=False)
    fit_losses = [r["loss"] for r in fixed.history.steps]
    check(all(np.isfinite(fit_losses)) and np.mean(fit_losses[-5:]) < fit_losses[0],
          f"fixed-batch losses do not fall: {fit_losses}")

    # step time (host clock, synchronised), then one profiled step
    times = []
    for i in range(10):
        t = time.perf_counter()
        state, _ = trainer.train_step(state, xb, yb)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: trainer.train_step(state, xb, yb))  # tracer warm-up
    prof_ms, busy_ms, kernel_ms, n_step = profiled_run_ms(
        lambda: trainer.train_step(state, xb, yb))
    # the step less its forward and backward: the gradient norm and Adam
    n_grad = profiled_run_ms(lambda: vg(state.params, xb, yb))[3]
    n_opt = None if n_step is None or n_grad is None else n_step - n_grad
    return {
        "model": kind, "dtype": dtype_name, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "launches": launches, "fit_seconds": fit_s, "losses": losses,
        "fixed_batch_losses": fit_losses, "step1_loss": float(loss_k),
        "step1_plain_loss": float(loss_p), "grad_vs_plain_rel_err": grad_err,
        "grad_worst_tensor": worst,
        "grad_check": {"against": against, "rel_err": check_err, "tensor": check_worst,
                       "tolerance": check_tol},
        "grads_bitwise_repeatable": repeat, "f64_reference": f64,
        "step_ms": times, "step_ms_median": statistics.median(times),
        "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        "kernel_device_ms": kernel_ms, "device_kernels_per_step": n_step,
        "device_kernels_forward_backward": n_grad, "device_kernels_optimizer": n_opt,
    }


def flagship_estimator(dtype_name):
    """The flagship C48 U-Net's estimator on the card, seeded weights, with
    the serve phases' normalization stats."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig

    cfg = ExperimentConfig(data=DataConfig(), model=model_config("unet", dtype_name))
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    stats = {"mean": mean, "std": std, "insol_mean": 340.0, "insol_std": 420.0}
    return DLWPEstimator(cfg, device="cuda", seed=0).load_state(stats)


def exchange_ms(meshes):
    """Host ms per call, 20 calls after one warm-up, on this rank: one
    ``all_gather`` of a ghost-row strip (1, 6, 1, 48, 32) over the 4 bands,
    and one band and one tile conv (n=48, 32 -> 32, batch 1, bf16) with
    their halo exchanges; the band rows of that band conv by the
    ``ppermute`` pair and by kernel #10; the band conv with #10 as its
    band-row transport; kernel #11 with its seam exchange.  Launches here
    are not the main path's."""
    from dlwp_cs_tpu_torch.parallel.collectives import all_gather
    from dlwp_cs_tpu_torch.parallel.halo import use_band_exchange
    from dlwp_cs_tpu_torch.parallel.hopper_band import make_sharded_pallas_conv3x3
    from dlwp_cs_tpu_torch.parallel.hopper_tile import make_tile_pallas_conv3x3
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, local_block
    from dlwp_cs_tpu_torch.parallel.overlap_band import make_overlap_conv3x3
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 6, 48, 48, 32), generator=gen, device=dev).to(torch.bfloat16)
    w = [(torch.randn((3, 3, 32, 32), generator=gen, device=dev) * 0.06).to(torch.bfloat16)
         for _ in range(2)] + [torch.zeros(32, device=dev, dtype=torch.bfloat16)] * 2

    def per_call(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    strip = x[:, :, :1].contiguous()
    out = {"all_gather_ms": per_call(lambda: all_gather(strip, meshes["band"], SPATIAL_AXIS))}
    for kind, make in (("band", make_sharded_pallas_conv3x3), ("tile", make_tile_pallas_conv3x3)):
        conv, block = make(meshes[kind]), local_block(x, meshes[kind])
        out[f"{kind}_conv_ms"] = per_call(lambda: conv(block, *w))
    # the band rows of one conv: the ppermute pair, kernel #10; the band conv
    # with #10 as its band-row transport, and kernel #11 with its seam exchange
    band = local_block(x, meshes["band"])
    out["ppermute_pair_ms"] = per_call(lambda: band_exchange_plain(band, 1, mesh=meshes["band"]))
    out["rdma_exchange_ms"] = per_call(lambda: band_exchange_rdma(band, 1, mesh=meshes["band"]))
    conv = make_sharded_pallas_conv3x3(meshes["band"])
    with use_band_exchange("rdma"):
        out["rdma_band_conv_ms"] = per_call(lambda: conv(band, *w))
    conv = make_overlap_conv3x3(meshes["band"])
    out["overlap_conv_ms"] = per_call(lambda: conv(band, *w))
    return out


def rank_ms(fn, reps):
    """Device ms per call of ``fn`` on this rank: ``reps`` calls enqueued
    back to back between CUDA events, after one call.  For the kernels that
    wait on the other ranks, whose launches a CUDA graph would freeze (each
    call takes the next epoch)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Host ms per call of ``fn`` ending in a device synchronise, after one
    call (for the paths that stage collectives through the host)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def remote_cases(mesh, b, dtype, convs: bool = True):
    """Kernels #10 and (with ``convs``) #11 on this rank's band at each
    flagship conv shape (batch ``b``): #10 on the conv's input against the
    ``ppermute`` pair
    (equal), #11 against its plain version on the same seam strips and
    received rows (f32 1e-4; bf16 one ulp + 1e-4) and against #8 on the
    exchanged strips; each kernel's device time per call (the 4 ranks
    sharing the card wait out each other's time slices inside it), the
    plain versions' times, one face-grouped cuDNN call on the padded band
    and the bounds.  A collective call; launches here are not the main
    path's."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import _padded_faces
    from dlwp_cs_tpu_torch.parallel.collectives import axis_index, axis_size
    from dlwp_cs_tpu_torch.parallel.halo import halo_pieces
    from dlwp_cs_tpu_torch.parallel.hopper_band import band_conv3x3, band_ext
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS, local_block
    from dlwp_cs_tpu_torch.parallel.overlap_band import (
        _seam_ext,
        band_conv3x3_overlap,
        band_conv3x3_overlap_plain,
    )
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma
    from dlwp_cs_tpu_torch.tools.timing import (
        HBM_BYTES_PER_S, bf16_excess, bound, face_grouped, graph_ms)

    dev = torch.device("cuda")
    s = axis_index(mesh, SPATIAL_AXIS)
    xchg, conv = [], []
    for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
        gen = torch.Generator(device=dev).manual_seed(n * 1000 + cin * 7 + cout)
        x = local_block(torch.randn((b, 6, n, n, cin), generator=gen, device=dev).to(dtype),
                        mesh)
        ks = [(torch.randn((3, 3, cin, cout), generator=gen, device=dev)
               * (9 * cin) ** -0.5).to(dtype) for _ in range(2)]
        bs = [(torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype)
              for _ in range(2)]
        h, item = x.shape[2], x.element_size()
        slab = b * 6 * n * cin * item
        # #10 on this conv's input (width 1)
        ours = band_exchange_rdma(x, 1, mesh=mesh)
        ref = band_exchange_plain(x, 1, mesh=mesh)
        torch.cuda.synchronize()
        err10 = max(float((a.float() - r.float()).abs().max()) for a, r in zip(ours, ref))
        equal10 = all(torch.equal(a, r) for a, r in zip(ours, ref))
        ms10 = rank_ms(lambda: band_exchange_rdma(x, 1, mesh=mesh), 20)
        plain10 = host_ms(lambda: band_exchange_plain(x, 1, mesh=mesh), 5)
        t_bytes = 4 * slab / HBM_BYTES_PER_S * 1e3  # 2 boundary slabs read, 2 written
        xchg.append({
            "n": n, "cin": cin, "cout": cout, "batch": b, "rows": h,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err10, "equal": equal10,
            "ok": equal10, "ms": ms10, "plain_ms": plain10, "library_ms": None,
            "bound_ms": t_bytes, "bound_by": "bytes", "bytes": 4 * slab, "ops": 0})
        if not convs:
            continue
        # #11 on the same band, and #8 on the exchanged strips
        seam, wecols = _seam_ext(x, mesh=mesh)
        below, above = band_exchange_plain(x, 1, mesh=mesh)
        first, last = s == 0, s == axis_size(mesh, SPATIAL_AXIS) - 1
        ref = band_conv3x3_overlap_plain(x, seam, wecols, below, above, *ks, *bs,
                                         first=first, last=last)
        ours = band_conv3x3_overlap.fused(x, seam, wecols, *ks, *bs, mesh=mesh)
        k8 = band_conv3x3(x, *ks, *bs, mesh=mesh)
        torch.cuda.synchronize()
        err = float((ours.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            tol, ok = "1e-4 abs", err <= 1e-4
        else:
            tol, ok = "2**-7*|ref| + 1e-4", bf16_excess(ours, ref) <= 1e-4
        ext = band_ext(*halo_pieces(x, 1, mesh=mesh))
        p, w = face_grouped(_padded_faces(x, ext), ks)
        bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
        ms11 = rank_ms(lambda: band_conv3x3_overlap.fused(x, seam, wecols, *ks, *bs,
                                                           mesh=mesh), 20)
        plain11 = graph_ms(lambda: band_conv3x3_overlap_plain(
            x, seam, wecols, below, above, *ks, *bs, first=first, last=last), 3)
        library_ms = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), 20)
        # the band, the seam strips, the two rows received, weights; the output
        nbytes = item * (x.numel() + seam.numel() + wecols.numel() + 2 * ks[0].numel()
                         + 2 * cout + b * 6 * h * n * cout) + 2 * slab
        ops = 2 * b * 6 * h * n * 9 * cin * cout
        conv.append({
            "n": n, "cin": cin, "cout": cout, "batch": b, "rows": h,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tolerance": tol,
            "ok": ok, "vs_band_kernel_max_abs_err": float((ours.float() - k8.float()).abs().max()),
            "equal_to_band_kernel": bool(torch.equal(ours, k8)),
            "ms": ms11, "plain_ms": plain11, "library_ms": library_ms,
            **bound(nbytes, ops, dtype)})
    return xchg, conv


def sharded_rank(dtype_names, windows, t0, const):
    """One rank of the sharded serve phase (a spawned process of a gloo
    group of ``SHARDS`` ranks sharing the card): per dtype, a 14-day forecast
    at batch 1 through kernel #8 on row bands, through #9 on 2 x 2 tiles,
    through #8 with #10 moving the band rows, and through #11, then the mesh
    service at batch 3; before them kernels #10 and #11 at every flagship
    band shape.  Returns the fields, the launches of every kernel and the
    collectives per forecast, the wall times and the kernel cases."""
    from dlwp_cs_tpu_torch import ForecastService, TimeSeriesEstimator
    from dlwp_cs_tpu_torch.parallel import collectives, create_mesh, make_spatial_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    meshes = {"band": create_mesh(data=1, spatial=SHARDS),
              "tile": create_mesh(data=1, spatial=2, spatial_x=2),
              "service": create_mesh(data=2, spatial=2)}
    out = {"exchange": exchange_ms(meshes), "xchg": [], "overlap": []}
    for b in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            xchg, conv = remote_cases(meshes["band"], b, dtype)
            out["xchg"] += xchg
            out["overlap"] += conv
    for dtype_name in dtype_names:
        est = flagship_estimator(dtype_name)
        lat, lon = est.cs.cell_latlon
        mean, std = est.stats["mean"], est.stats["std"]
        for kind, mesh_kind, opts in SHARDED_PATHS:
            ts = TimeSeriesEstimator(
                model=make_spatial_apply(est.model, meshes[mesh_kind], **opts),
                data_cfg=est.config.data, lat=lat, lon=lon, constants=const,
                insol_mean=est.stats["insol_mean"], insol_std=est.stats["insol_std"],
                device=est.device)
            normed = (windows[:1] - mean) / std
            ts.predict(normed, t0[:1], steps=2)  # warm-up
            for k in kernels.values():
                k.launches = 0
            calls = collectives.calls
            t = time.perf_counter()
            fields = ts.predict(normed, t0[:1], steps=STEPS).fields.cpu().numpy()
            wall = (time.perf_counter() - t) * 1e3
            out[kind, dtype_name] = {
                "fields": fields, "wall_ms": wall, "collectives": collectives.calls - calls,
                "launches": {name: k.launches for name, k in kernels.items()}}
        svc = ForecastService(est, constants=const, mesh=meshes["service"])
        svc.forecast(windows[:3], t0[:3], steps=1)  # warm-up
        padded = svc.stats.padded_mesh
        for k in kernels.values():
            k.launches = 0
        calls = collectives.calls
        t = time.perf_counter()
        fc = svc.forecast(windows[:3], t0[:3], steps=STEPS)
        wall = (time.perf_counter() - t) * 1e3
        out["service", dtype_name] = {
            "fields": fc.fields, "wall_ms": wall, "collectives": collectives.calls - calls,
            "padded_mesh": svc.stats.padded_mesh - padded,
            "launches": {name: k.launches for name, k in kernels.items()}}
    return out


def pair_rank():
    """One rank of a group of 2 sharing the card: kernel #10 at every
    flagship conv input cut into 2 bands (the same rows as on 4), batch 1
    and 8, both dtypes, against the ``ppermute`` pair, with its time."""
    from dlwp_cs_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=1, spatial=2)
    out = []
    for b in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            out += remote_cases(mesh, b, dtype, convs=False)[0]
    return out


def sharded_phase(rng, workdir):
    """Serve the flagship U-Net over ``SHARDS`` ranks sharing the card and
    hold every rank's forecasts against the one-card forecasts."""
    from dlwp_cs_tpu_torch import ForecastService
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    dtype_names = ("bfloat16", "float32")
    const = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    mean = np.asarray([5500.0, 1000.0, 3500.0, 280.0], np.float32)
    std = np.asarray([300.0, 100.0, 150.0, 15.0], np.float32)
    windows = (rng.normal(size=(3, 2, 6, 48, 48, 4)) * std + mean).astype(np.float32)
    t0 = 9668.5 + 0.25 * np.arange(3)
    one_card = {}
    for dtype_name in dtype_names:
        svc = ForecastService(flagship_estimator(dtype_name), constants=const)
        normed = (windows[:1] - mean) / std
        one_card["kernel", dtype_name] = svc.forecast(
            normed, t0[0], steps=STEPS, normalized=True).fields
        one_card["service", dtype_name] = svc.forecast(windows, t0, steps=STEPS).fields
    t = time.perf_counter()
    ranks = spawn_group(sharded_rank, SHARDS, dtype_names, windows, t0, const,
                        workdir=os.path.join(workdir, "four"))
    group_s = time.perf_counter() - t
    pair = spawn_group(pair_rank, 2, workdir=os.path.join(workdir, "two"))
    exchange = [r["exchange"] for r in ranks]
    kernels = all_kernels()
    # kernel launches per model call of each path
    want = {"band": {"cs_conv3x3_band": 10}, "tile": {"cs_conv3x3_tile": 10}, "service": {},
            "band_rdma": {"cs_conv3x3_band": 10, "band_exchange_rdma": 10},
            "band_overlap": {"band_conv3x3_overlap": 10}}
    results = []
    for dtype_name in dtype_names:
        for kind, per_call in want.items():
            path = "kernel" if per_call else "service"
            ref = one_card[path, dtype_name]
            rel, tol = SHARDED_TOL[path, dtype_name]
            errs, excess, walls = [], [], []
            for rank, r in enumerate(ranks):
                got = r[kind, dtype_name]
                launches = {name: per_call.get(name, 0) * STEPS for name in kernels}
                check(got["launches"] == launches,
                      f"rank {rank} {kind} {dtype_name}: launches {got['launches']}, "
                      f"want {launches}")
                check(got["fields"].shape == ref.shape and np.isfinite(got["fields"]).all(),
                      f"rank {rank} {kind} {dtype_name}: fields {got['fields'].shape}")
                scale = 1.0 if per_call else std  # normalized fields have std 1
                diff = np.abs(got["fields"] - ref) / scale
                errs.append(float(diff.max()))
                excess.append(float((diff - rel * np.abs(ref) / scale).max()))
                walls.append(got["wall_ms"])
                if not per_call:
                    check(got["padded_mesh"] == 1, f"padded_mesh {got['padded_mesh']}")
            check(max(excess) <= tol, f"{kind} {dtype_name}: sharded vs one-card "
                  f"|diff| exceeds {rel}*|ref| by {max(excess)} std > {tol}")
            results.append({
                "path": kind, "dtype": dtype_name, "batch": 1 if per_call else 3,
                "launches_per_rank": ranks[0][kind, dtype_name]["launches"],
                "collectives_per_rank": [r[kind, dtype_name]["collectives"] for r in ranks],
                "max_err_in_std": max(errs), "tolerance_in_std": f"{rel:.3g}*|ref| + {tol:.3g}",
                "wall_ms_per_rank": walls,
            })
    remote = {"xchg4": [c for r in ranks for c in r["xchg"]],
              "overlap4": [c for r in ranks for c in r["overlap"]],
              "xchg2": [c for r in pair for c in r]}
    bad = [c for cases in remote.values() for c in cases if not c["ok"]]
    check(not bad, f"kernel #10 or #11 disagrees with its plain version: {bad}")
    # per rank, per shape: #10's case (input rows) and #11's, rank 0 first
    remote["per_rank"] = [{"xchg": r["xchg"], "overlap": r["overlap"]} for r in ranks]
    return results, exchange, group_s, remote


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dlwp_cs_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    libraries = list({id(k.library): k.library for k in all_kernels().values()}.values())
    t = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, at once
        for fut in [pool.submit(lib.build) for lib in libraries]:
            fut.result()
    build_s = time.perf_counter() - t
    regs = {lib.source.name: [ln.strip() for ln in lib.build_log.splitlines()
                              if "registers" in ln or "Function properties" in ln]
            for lib in libraries}
    print(f"build: {build_s:.2f} s; {regs}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    print("n Cin Cout B dtype | max_abs_err (tol) | kernel_ms plain_ms library_ms bound_ms")
    shapes = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index) + EXTRA_SHAPES
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8):
            for n, cin, cout in shapes:
                c = conv_case(n, cin, cout, b, dtype, gen)
                cases.append(c)
                print(f"{n} {cin} {cout} {b} {c['dtype']} | {c['max_abs_err']:.3g} "
                      f"({c['tolerance']}) | {c['ms']:.4f} {c['plain_ms']:.4f} "
                      f"{c['library_ms']:.4f} {c['bound_ms']:.5f} {c['bound_by']}",
                      flush=True)
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")

    bwd = []
    print("backward: kernel n Cin Cout B dtype | max_abs_err (tol) | "
          "kernel_ms plain_ms library_ms bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
            for c in bwd_case(n, cin, cout, TRAIN_BATCH, dtype, gen):
                bwd.append(c)
                print(f"{c['kernel']} {n} {cin} {cout} {TRAIN_BATCH} {c['dtype']} | "
                      f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                      f"{c['plain_ms']:.4f} {c['library_ms']:.4f} {c['bound_ms']:.5f} "
                      f"{c['bound_by']}", flush=True)
    bad = [c for c in bwd if not c["ok"]]
    check(not bad, f"backward kernel disagrees with its plain version: {bad}")

    ring = []
    print("ring: kernel n Cin D B dtype | max_abs_err (tol) | kernel_ms plain_ms bound_ms | "
          "xring conv, fused conv kernel, cuDNN ms")
    ring_shapes = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index) + CONVLSTM_GATES
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, TRAIN_BATCH):
            for n, cin, d in ring_shapes:
                for c in ring_case(n, cin, d, b, dtype, gen):
                    ring.append(c)
                    print(f"{c['kernel']} {n} {cin} {d} {b} {c['dtype']} | "
                          f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                          f"{c['plain_ms']:.4f} {c['bound_ms']:.5f} {c['bound_by']} | "
                          f"{c['xring_conv_ms']:.4f} {c['fused_conv_ms']:.4f} "
                          f"{c['cudnn_conv_ms']:.4f}", flush=True)
    bad = [c for c in ring if not c["ok"]]
    check(not bad, f"ring kernel disagrees with its plain version: {bad}")

    # the kernel tools: their entry points (this slice's main path), then
    # each of their kernels against its plain version, timed
    tool_launches, tools_s, tool_rows = tools_main_path()
    print(f"tools: {len(TOOL_RUNS)} runs in {tools_s:.1f} s; launches "
          f"{ {k: tool_launches[k] for k in TOOL_KERNELS} }", flush=True)
    mma = []
    print("tools: kernel n Cin Cout B | max_abs_err (vs #1) | kernel_ms plain_ms #1_ms "
          "library_ms bound_ms")
    from dlwp_cs_tpu_torch.tools.conv_micro import LEVELS
    from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS, bound
    mma_shapes = ([s + (1,) for s in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index)]
                  + LEVELS + [(48, 96, 32, TRAIN_BATCH)])
    for n, cin, cout, b in mma_shapes:
        for c in mma_cases(n, cin, cout, b, gen):
            mma.append(c)
            print(f"{c['kernel']} {n} {cin} {cout} {b} | {c['max_abs_err']:.3g} "
                  f"({c['vs_conv_kernel_max_abs_err']:.3g}) | {c['ms']:.4f} {c['plain_ms']:.4f} "
                  f"{c['conv_kernel_ms']:.4f} {c['library_ms']:.4f} {c['bound_ms']:.5f}",
                  flush=True)
    # #12 at conv_micro's levels, as the tool's run measured it
    only = [{"ms": r["kernel"], "plain_ms": r["kernel_plain_ms"],
             "library_ms": r["kernel_library_ms"], "max_abs_err": r["kernel_max_abs_err"],
             **bound(r["bytes"], r["ops"], torch.bfloat16)} for r in tool_rows["conv_micro"]]
    for r, c in zip(tool_rows["conv_micro"], only):
        print(f"kernel_only {r['n']} {r['cin']} {r['cout']} {r['batch']} | equal to #1 "
              f"{r['kernel_equals_fused']}, vs plain {c['max_abs_err']:.3g} | ext "
              f"{r['ext']:.4f} kernel {c['ms']:.4f} pallas {r['pallas']:.4f} plain "
              f"{c['plain_ms']:.4f} cuDNN {c['library_ms']:.4f} bound {c['bound_ms']:.5f}",
              flush=True)
    ring_dx = dx_ring_cases(gen)
    for c in ring_dx:
        print(f"dx_ring {c['n']} {c['cin']} {c['cout']} {c['batch']} {c['dtype']} | "
              f"{c['max_abs_err']:.3g} ({c['tolerance']}), equal to #4 {c['equal_to_dx_kernel']} "
              f"| {c['ms']:.4f} (#4 {c['dx_kernel_ms']:.4f}) {c['plain_ms']:.4f} "
              f"{c['library_ms']:.4f} {c['bound_ms']:.5f}", flush=True)
    stores = lane_store_cases(gen)
    # #16 at the reference scripts' shapes in bfloat16, as the probe tool's
    # run measured and checked them
    probe_rows = [dict(r, **bound(r["bytes"], r["ops"], torch.bfloat16))
                  for r in tool_rows["mosaic_bisect"]]
    for c in stores + probe_rows:
        print(f"{c.get('name', 'lane_store')} {c.get('shapes', c.get('shape'))} {c['dtype']} | "
              f"{c['max_abs_err']:.3g} | {c['ms']:.4f} {c['plain_ms']:.4f} "
              f"{c['library_ms']:.4f} {c['bound_ms']:.5f}", flush=True)
    bad = [c for c in mma + ring_dx + stores if not c["ok"]]
    check(not bad, f"a kernel of the tools disagrees with its plain version: {bad}")

    blocks = []
    print("block: kernel n rows x cols Cin Cout B dtype | max_abs_err (tol) | kernel_ms "
          "plain_ms library_ms bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8):
            for kind in ("band", "tile"):
                for n, cin, cout in sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index):
                    c = block_case(kind, n, cin, cout, b, dtype, gen)
                    blocks.append(c)
                    print(f"{kind} {n} {c['rows']}x{c['cols']} {cin} {cout} {b} {c['dtype']} | "
                          f"{c['max_abs_err']:.3g} ({c['tolerance']}) | {c['ms']:.4f} "
                          f"{c['plain_ms']:.4f} {c['library_ms']:.4f} {c['bound_ms']:.5f} "
                          f"{c['bound_by']}", flush=True)
    bad = [c for c in blocks if not c["ok"]]
    check(not bad, f"band or tile kernel disagrees with its plain version: {bad}")

    # one generator per model, drawn in the same order for each: serve
    # bf16, f32, then train bf16, f32 (the U-Net's draws are PR 2's)
    serve, train = {}, {}
    for kind, seed in (("unet", 0), ("convlstm", 1)):
        rng = np.random.default_rng(seed)
        for dtype_name in ("bfloat16", "float32"):
            s = serve_phase(kind, dtype_name, rng)
            serve[kind, dtype_name] = s
            print(f"serve {kind} {dtype_name}: 14-day rollout {s['rollout_ms_median']:.2f} ms "
                  f"(runs {['%.2f' % t for t in s['rollout_ms']]}); profiled rollout "
                  f"{s['profiled_rollout_ms']:.2f} ms: device busy {s['device_busy_ms']} ms "
                  f"(idle share {s['device_idle_share']}), kernels "
                  f"{s['kernel_device_ms']} ms; device kernels {s['device_kernels']}; "
                  f"{s['launches_per_forecast']} launches, first two calls vs plain "
                  f"{s['first_two_calls_max_abs_err']:.3g} "
                  f"(tol {s['first_two_calls_tolerance']:.3g}), "
                  f"8 submits in {s['submit_dispatches']} dispatches, vs direct "
                  f"{s['submit_vs_direct_max_err_in_std']:.3g} std", flush=True)
        for dtype_name in ("bfloat16", "float32"):
            r = train_phase(kind, dtype_name, rng)
            train[kind, dtype_name] = r
            print(f"train {kind} {dtype_name}: batch {r['batch']}, {r['steps']} steps in "
                  f"{r['fit_seconds']:.2f} s; step {r['step_ms_median']:.2f} ms median "
                  f"(runs {['%.2f' % t for t in r['step_ms']]}); profiled step "
                  f"{r['profiled_step_ms']:.2f} ms: device busy {r['device_busy_ms']} ms "
                  f"(idle share {r['device_idle_share']}), kernels {r['kernel_device_ms']} ms; "
                  f"device kernels per step {r['device_kernels_per_step']} (forward+backward "
                  f"{r['device_kernels_forward_backward']}, norm+optimizer "
                  f"{r['device_kernels_optimizer']}); "
                  f"launches {r['launches']}; loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
                  f"fixed batch {r['fixed_batch_losses'][0]:.4f} -> "
                  f"{np.mean(r['fixed_batch_losses'][-5:]):.4f}; step-1 grads vs plain "
                  f"{r['grad_vs_plain_rel_err']:.3g} of max in {r['grad_worst_tensor']}; "
                  f"checked against {r['grad_check']['against']}: "
                  f"{r['grad_check']['rel_err']:.3g} in {r['grad_check']['tensor']} (tol "
                  f"{r['grad_check']['tolerance']:.3g}), "
                  f"bitwise repeatable {r['grads_bitwise_repeatable']}", flush=True)

    with tempfile.TemporaryDirectory() as workdir:  # the groups' FileStores
        sharded, exchange, group_s, remote = sharded_phase(np.random.default_rng(2), workdir)
    print("remote: kernel ranks n rows Cin Cout B dtype | max_abs_err | kernel_ms plain_ms "
          "library_ms bound_ms (rank 0; #11: max |#11 - #8|)")
    for key, name, ranks_n in (("xchg2", "#10", 2), ("xchg4", "#10", 4), ("overlap4", "#11", 4)):
        for c in remote[key][: len(remote[key]) // ranks_n]:  # rank 0's
            extra = (f" | vs #8 {c['vs_band_kernel_max_abs_err']:.3g}"
                     if "vs_band_kernel_max_abs_err" in c else "")
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            print(f"{name} {ranks_n} {c['n']} {c['rows']} {c['cin']} {c['cout']} {c['batch']} "
                  f"{c['dtype']} | {c['max_abs_err']:.3g} | {c['ms']:.4f} {c['plain_ms']:.4f} "
                  f"{lib} {c['bound_ms']:.5f}{extra}", flush=True)
    for r in sharded:
        print(f"sharded {r['path']} {r['dtype']} batch {r['batch']}: vs one card "
              f"{r['max_err_in_std']:.3g} std (tol {r['tolerance_in_std']}); 14-day "
              f"forecast {max(r['wall_ms_per_rank']):.1f} ms wall, 4 ranks sharing one card "
              f"over gloo + CUDA IPC; launches per rank {r['launches_per_rank']}; gloo "
              f"collectives per rank {r['collectives_per_rank']}", flush=True)
    print(f"sharded group: {group_s:.1f} s from spawn to the last rank's exit; per rank, "
          f"ms per all_gather of one ghost strip, per band and per tile conv with its "
          f"exchange, per band-row exchange (ppermute pair, #10), per band conv with #10 "
          f"and per #11 conv (4 ranks sharing one card over gloo + CUDA IPC): {exchange}",
          flush=True)

    def line(name, source, replaces, launches, per_path, errs):
        """One kernel's entry: times summed over the convs of one model call
        (forward) or one train step (backward) in bfloat16."""
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": sum(c["ms"] for c in per_path),
            "plain_ms": sum(c["plain_ms"] for c in per_path),
            "bound_ms": sum(c["bound_ms"] for c in per_path),
            "bound_by": "bytes" if sum(c["bytes"] / HBM_BYTES_PER_S for c in per_path)
            >= sum(c["ops"] / PEAK_OPS[torch.bfloat16] for c in per_path) else "operations",
            "library_ms": None if any(c["library_ms"] is None for c in per_path)
            else sum(c["library_ms"] for c in per_path),
        }

    # forward: one model call (its 10 convs) at the serving batch 1;
    # launches are the bfloat16 forecast's
    fwd = {(c["n"], c["cin"], c["cout"]): c for c in cases
           if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    # backward: one train step at batch 16 (dw on all 10 convs, dx on the 9
    # whose input is not data); launches are the bfloat16 training run's
    back = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in bwd
            if c["dtype"] == "bfloat16"}
    # ring kernels: the 4 gate convs of one ConvLSTM model call at batch 1;
    # launches are the bfloat16 ConvLSTM forecast's (#6 is not on its path)
    gates = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in ring
             if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    unet_fc = serve["unet", "bfloat16"]["launches_per_forecast"]
    lstm_fc = serve["convlstm", "bfloat16"]["launches_per_forecast"]
    unet_tr = train["unet", "bfloat16"]["launches"]
    src_bwd = "dlwp_cs_tpu_torch/csrc/cs_conv3x3_bwd.cu"
    src_ring = "dlwp_cs_tpu_torch/csrc/cs_ring.cu"
    kernels = [
        line("cs_conv3x3", "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu",
             "dlwp_cs_tpu/ops/pallas_conv.py:131", unet_fc["cs_conv3x3"],
             [fwd[s] for s in FLAGSHIP_CONVS], [c["max_abs_err"] for c in cases]),
        line("cs_conv3x3_dx", src_bwd, "dlwp_cs_tpu/ops/pallas_conv.py:628",
             unet_tr["cs_conv3x3_dx"],
             [back[("dx",) + s] for s in FLAGSHIP_CONVS[1:]],
             [c["max_abs_err"] for c in bwd if c["kernel"] == "dx"]),
        line("cs_conv3x3_dw", src_bwd, "dlwp_cs_tpu/ops/pallas_conv.py:656",
             unet_tr["cs_conv3x3_dw"],
             [back[("dw",) + s] for s in FLAGSHIP_CONVS],
             [c["max_abs_err"] for c in bwd if c["kernel"] == "dw"]),
        line("ring_fixes", src_ring, "dlwp_cs_tpu/ops/ring_kernel.py:54",
             lstm_fc["ring_fixes"], [gates[("fixes",) + s] for s in CONVLSTM_CALL],
             [c["max_abs_err"] for c in ring if c["kernel"] == "fixes"]),
        line("xring_fused_apply", src_ring, "dlwp_cs_tpu/ops/ring_kernel.py:187",
             lstm_fc["xring_fused_apply"], [gates[("apply",) + s] for s in CONVLSTM_CALL],
             [c["max_abs_err"] for c in ring if c["kernel"] == "apply"]),
    ]
    # bands and tiles: one model call's 10 convs on one rank's block at the
    # serving batch 1 in bfloat16; launches per rank of the bf16 forecasts
    blk = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in blocks
           if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    per_rank = {(r["path"], r["dtype"]): r["launches_per_rank"] for r in sharded}
    for kind, name, replaces in (
        ("band", "cs_conv3x3_band", "dlwp_cs_tpu/parallel/pallas_band.py:111"),
        ("tile", "cs_conv3x3_tile", "dlwp_cs_tpu/parallel/pallas_tile.py:92"),
    ):
        kernels.append(line(name, "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu", replaces,
                            per_rank[kind, "bfloat16"][name],
                            [blk[(kind,) + s] for s in FLAGSHIP_CONVS],
                            [c["max_abs_err"] for c in blocks if c["kernel"] == kind]))
    # #10 and #11: one model call's 10 convs on rank 0's band of 4, batch 1,
    # bfloat16 (#10 moves each conv's input rows); times include the other
    # ranks' time slices; launches per rank of the bf16 forecasts
    rank0 = remote["per_rank"][0]
    for key, name, src, replaces, path in (
        ("xchg", "band_exchange_rdma", "dlwp_cs_tpu_torch/csrc/cs_band_xchg.cu",
         "dlwp_cs_tpu/parallel/rdma_halo.py:49", "band_rdma"),
        ("overlap", "band_conv3x3_overlap", "dlwp_cs_tpu_torch/csrc/cs_band_overlap.cu",
         "dlwp_cs_tpu/parallel/overlap_band.py:110", "band_overlap"),
    ):
        per_shape = {(c["n"], c["cin"], c["cout"]): c for c in rank0[key]
                     if c["batch"] == 1 and c["dtype"] == "bfloat16"}
        errs = [c["max_abs_err"] for k in (("xchg2", "xchg4") if key == "xchg" else ("overlap4",))
                for c in remote[k]]
        kernels.append(line(name, src, replaces, per_rank[path, "bfloat16"][name],
                            [per_shape[s] for s in FLAGSHIP_CONVS], errs))
    # the kernel tools' kernels; launches per run of the tools (TOOL_RUNS):
    # wrapper calls, those captured into a timing CUDA graph included, its
    # replays not.
    # #3 and #13: one model call's 10 convs at batch 1, as #1's line
    per_conv = {(c["kernel"], c["n"], c["cin"], c["cout"]): c for c in mma if c["batch"] == 1}
    for kind, name, replaces in (
        ("npack", "cs_conv3x3_npack", "dlwp_cs_tpu/ops/pallas_conv.py:213"),
        ("im2col", "cs_conv3x3_im2col", "tools/kernel_variants.py:194"),
    ):
        kernels.append(line(name, "dlwp_cs_tpu_torch/csrc/cs_conv3x3_mma.cu", replaces,
                            tool_launches[name], [per_conv[(kind,) + s] for s in FLAGSHIP_CONVS],
                            [c["max_abs_err"] for c in mma if c["kernel"] == kind]))
    # #12 and #14: conv_micro's three levels at batch 16 (bf16); #15: one call
    kernels.append(line("cs_conv3x3_kernel_only", "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu",
                        "tools/conv_micro.py:143", tool_launches["cs_conv3x3_kernel_only"], only,
                        [c["max_abs_err"] for c in only]))
    kernels.append(line("cs_conv3x3_dx_ring", src_bwd, "tools/kernel_variants.py:345",
                        tool_launches["cs_conv3x3_dx_ring"],
                        [c for c in ring_dx if c["dtype"] == "bfloat16"],
                        [c["max_abs_err"] for c in ring_dx]))
    src_probes = "dlwp_cs_tpu_torch/csrc/cs_probes.cu"
    kernels.append(line("lane_store", src_probes, "tools/kernel_variants.py:427",
                        tool_launches["lane_store"],
                        [c for c in stores if c["dtype"] == "bfloat16"],
                        [c["max_abs_err"] for c in stores]))
    # #16: each probe at the reference scripts' shapes (bisect3's three dw
    # shapes summed)
    for name, replaces in (
        ("probe_assemble", "tools/mosaic_bisect.py:27"),
        ("probe_select", "tools/mosaic_bisect.py:43"),
        ("probe_dot", "tools/mosaic_bisect.py:54"),
        ("probe_shifted_dots", "tools/mosaic_bisect.py:66"),
        ("probe_bias", "tools/mosaic_bisect.py:85"),
        ("probe_rows_int", "tools/mosaic_bisect2.py:24"),
        ("probe_rows_slice", "tools/mosaic_bisect2.py:24"),
        ("probe_col_int", "tools/mosaic_bisect2.py:24"),
        ("probe_col_newaxis", "tools/mosaic_bisect2.py:24"),
        ("probe_dw_reshape", "tools/mosaic_bisect3.py:23"),
        ("probe_dw_batched", "tools/mosaic_bisect3.py:35"),
    ):
        rows = [c for c in probe_rows if c["probe"] == name]
        kernels.append(line(name, src_probes, replaces, tool_launches[name], rows,
                            [c["max_abs_err"] for c in rows]))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_seconds": build_s, "registers": regs, "conv_cases": cases,
                   "bwd_cases": bwd, "ring_cases": ring, "block_cases": blocks,
                   "serve": list(serve.values()), "train": list(train.values()),
                   "sharded": sharded, "sharded_exchange_ms": exchange,
                   "sharded_group_seconds": group_s, "remote_cases": remote,
                   "tool_launches": tool_launches, "tools_seconds": tools_s,
                   "tool_rows": tool_rows, "mma_cases": mma,
                   "kernel_only_cases": only, "dx_ring_cases": ring_dx,
                   "lane_store_cases": stores, "probe_cases": probe_rows,
                   "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
