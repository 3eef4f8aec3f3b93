#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels, serve and train the flagship U-Net
and the ConvLSTM on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), ``nvcc`` and PyTorch built for CUDA.  Phases:

1. print the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build the kernels from ``dlwp_cs_tpu_torch/csrc``, one ``nvcc`` per
   source, all at once: the fused cubed-sphere conv, its backward (the dx
   and dw kernels) and the xring conv's ring-fix kernels (the fixes and the
   fused select + apply);
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
6. serve 14-day forecasts (28 calls of 6 h x 2) through ``ForecastService``
   in bfloat16 and float32 of the flagship C48 U-Net (filters 32/64/128,
   12 -> 8 channels, seeded weights; 280 conv kernel launches per
   forecast) and of the full-width ConvLSTM (filters 32/32, 3x3 gates, 1x1
   head, backend ``xring``; 112 launches of the fused ring kernel): finite
   fields, the first two model calls equal to the plain path on the card, 8
   concurrent submits coalesced into at most 2 dispatches and equal to
   direct forecasts;
7. train both models in bfloat16 and float32 at batch 16 with Adam (lr
   1e-3) on MSE: a ``MemoryStore`` of seeded fields -> ``SeriesDataset`` ->
   ``prefetch_to_device`` -> ``Trainer.fit`` for 20 optimizer steps (U-Net:
   10 forward, 10 dw and 9 dx launches a step; ConvLSTM: 4 fused ring
   kernel launches a step and no backward kernel); step 1's gradients
   finite and non-zero for every parameter, equal to the plain path's on
   the card and bitwise repeatable; 20 finite losses; a loss that falls
   when the trainer fits one fixed batch; the step time and the device's
   busy and idle time in one profiled step;
8. print the kernel line (JSON), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
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
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s
# and the operation rate for the kernel's input type (bf16 tensor-core rate,
# float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
TRAIN_BATCH = 16
TRAIN_STEPS = 20
KERNEL_NAMES = ("cs_conv3x3_kernel", "cs_conv3x3_dx_kernel", "cs_conv3x3_dw_kernel",
                "cs_ring_fixes_kernel", "cs_xring_apply_kernel")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bf16_excess(ours, ref):
    """How far |ours - ref| exceeds one bf16 ulp of |ref| (2**-7 relative)."""
    d = (ours.float() - ref.float()).abs() - ref.float().abs() * 2.0**-7
    return float(d.max())


def graph_ms(fn, reps):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in a
    CUDA graph (so host launch overhead is not counted), replayed 5 times
    between CUDA events; the median replay over ``reps``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del g
    return statistics.median(times)


def face_grouped(x, ks):
    """The padded faces ``(B, 6*Cin, n+2, n+2)`` (channels-last in memory)
    and kernels ``(6*Cout, Cin, 3, 3)`` of one face-grouped cuDNN conv that
    computes the CS conv of ``x`` with ``ks = (k_eq, k_pole)``."""
    from dlwp_cs_tpu_torch.ops.padding import cs_pad

    b, _, n, _, cin = x.shape
    p = cs_pad(x, 1).permute(0, 2, 3, 1, 4).reshape(b, n + 2, n + 2, 6 * cin).permute(0, 3, 1, 2)
    w = torch.cat([ks[0].permute(3, 2, 0, 1)] * 4 + [ks[1].permute(3, 2, 0, 1)] * 2)
    return p, w.contiguous(memory_format=torch.channels_last)


def conv_case(n, cin, cout, b, dtype, gen):
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain

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
    p, w = face_grouped(x, ks)
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return {
        "n": n, "cin": cin, "cout": cout, "batch": b, "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "tolerance": tol, "ok": ok, "library_max_abs_err": lib_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops,
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
    p, w = face_grouped(x, ks)
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
    from dlwp_cs_tpu_torch.ops.ringfix import _same_conv

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
    p, w = face_grouped(x, ks)
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
    """The five kernel wrappers, by name."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_dw, cs_conv3x3_dx
    from dlwp_cs_tpu_torch.ops.ring_kernel import ring_fixes, xring_fused_apply

    return {k.name: k for k in (cs_conv3x3, cs_conv3x3_dx, cs_conv3x3_dw, ring_fixes,
                                xring_fused_apply)}


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
    check(grad_err <= grad_tol, f"kernel vs plain gradients {grad_err} > {grad_tol} ({worst})")

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
        "grad_tolerance": grad_tol, "grads_bitwise_repeatable": repeat,
        "step_ms": times, "step_ms_median": statistics.median(times),
        "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        "kernel_device_ms": kernel_ms, "device_kernels_per_step": n_step,
        "device_kernels_forward_backward": n_grad, "device_kernels_optimizer": n_opt,
    }


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
                  f"{r['grad_vs_plain_rel_err']:.3g} of max in {r['grad_worst_tensor']} "
                  f"(tol {r['grad_tolerance']:.3g}), "
                  f"bitwise repeatable {r['grads_bitwise_repeatable']}", flush=True)

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
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_seconds": build_s, "registers": regs, "conv_cases": cases,
                   "bwd_cases": bwd, "ring_cases": ring, "serve": list(serve.values()),
                   "train": list(train.values()), "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
