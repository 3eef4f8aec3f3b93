#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and serve the flagship model on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), ``nvcc`` and PyTorch built for CUDA.  Phases:

1. print the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build the fused cubed-sphere conv kernel from ``dlwp_cs_tpu_torch/csrc``;
3. at each conv shape of the flagship C48 U-Net (and one n=96 shape with
   many row tiles), at batch 1 and 8, in float32 and bfloat16: hold the
   kernel against its plain torch version, and time the kernel, the plain
   version and ``F.conv2d`` (one face-grouped cuDNN call on the padded faces)
   with CUDA events over CUDA-graph replays, beside the least time the card
   could take;
4. serve 14-day forecasts (28 calls of 6 h x 2) of the flagship C48 U-Net
   (filters 32/64/128, 12 -> 8 channels, seeded weights) through
   ``ForecastService`` in bfloat16 and float32: 280 kernel launches per
   forecast, finite fields, the first two model calls equal to the plain
   path on the card, 8 concurrent submits coalesced into at most 2
   dispatches and equal to direct forecasts;
5. print the kernel line (JSON), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Details go to ``DIR/chip_smoke.json`` (default ``chip_smoke_out``).  TF32 is
off for cuDNN and matmuls throughout: every float32 result here is compared.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
STEPS = 28  # 14 days of 2 x 6 h per call


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


def conv_case(n, cin, cout, b, dtype, gen):
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain
    from dlwp_cs_tpu_torch.ops.padding import cs_pad

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
    p = cs_pad(x, 1).permute(0, 2, 3, 1, 4).reshape(b, n + 2, n + 2, 6 * cin)
    p = p.permute(0, 3, 1, 2)  # (B, 6*Cin, n+2, n+2), channels-last in memory
    w = torch.cat([ks[0].permute(3, 2, 0, 1)] * 4 + [ks[1].permute(3, 2, 0, 1)] * 2)
    w = w.contiguous(memory_format=torch.channels_last)
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


@contextlib.contextmanager
def plain_convs():
    """Route the model's 3x3 convs through the kernel's plain version."""
    from dlwp_cs_tpu_torch.ops import conv as conv_mod
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain

    saved = conv_mod.cs_conv3x3
    conv_mod.cs_conv3x3 = cs_conv3x3_plain
    try:
        yield
    finally:
        conv_mod.cs_conv3x3 = saved


def profiled_run_ms(fn):
    """One run of ``fn`` under ``torch.profiler``: ``(wall, busy, conv)`` in
    ms, the run's own host wall clock, the device time of all its kernels
    and that of the conv kernel; ``busy`` and ``conv`` are None where the
    profiler records no device time.  Only device activity is traced, which
    keeps the profiler's host overhead (in ``wall``) small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    total = conv = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only, not the ops launching them
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if "cs_conv3x3_kernel" in e.key:
            conv += us
    return (wall, total / 1e3, conv / 1e3) if total > 0 else (wall, None, None)


def serve_phase(dtype_name, rng):
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig, UNetConfig
    from dlwp_cs_tpu_torch import ForecastService
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3

    cfg = ExperimentConfig(data=DataConfig(),
                           model=UNetConfig(compute_dtype=dtype_name))
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
    cs_conv3x3.launches = 0
    fc = svc.forecast(windows[0], t0[0], steps=STEPS)
    launches = cs_conv3x3.launches
    check(launches == 10 * STEPS, f"{launches} kernel launches, want {10 * STEPS}")
    check(fc.fields.shape == (1, 2 * STEPS, 6, 48, 48, 4), f"shape {fc.fields.shape}")
    check(bool(np.isfinite(fc.fields).all()), "non-finite forecast fields")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        svc.forecast(windows[0], t0[0], steps=STEPS)
        times.append((time.perf_counter() - t) * 1e3)
    profiled_run_ms(lambda: svc.forecast(windows[0], t0[0], steps=2))  # tracer warm-up
    prof_ms, busy_ms, conv_ms = profiled_run_ms(
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
    # the kernel's sums do not depend on the batch or the tile plan; only
    # library calls (the head's matmul) may pick another algorithm per batch
    sub_tol = 1e-4 if dtype_name == "float32" else 1e-2
    check(sub_err <= sub_tol, f"coalesced vs direct: {sub_err} std > {sub_tol}")
    svc.close()
    return {
        "dtype": dtype_name, "launches_per_forecast": launches,
        "rollout_ms": times, "rollout_ms_median": statistics.median(times),
        "profiled_rollout_ms": prof_ms, "device_busy_ms": busy_ms,
        "conv_kernel_device_ms": conv_ms, "device_idle_share": idle,
        "first_two_calls_max_abs_err": err2, "first_two_calls_tolerance": tol2,
        "submit_dispatches": dispatches, "submit_vs_direct_max_err_in_std": sub_err,
        "submit_tolerance_in_std": sub_tol,
        "field_abs_max": float(np.abs(fc.fields).max()),
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
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    cs_conv3x3.build()
    regs = [ln.strip() for ln in cs_conv3x3.build_log.splitlines() if "registers" in ln]
    print(f"build: {cs_conv3x3.build_seconds:.2f} s; {regs}", flush=True)

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

    rng = np.random.default_rng(0)
    serve = []
    for dtype_name in ("bfloat16", "float32"):
        s = serve_phase(dtype_name, rng)
        serve.append(s)
        print(f"serve {dtype_name}: 14-day rollout {s['rollout_ms_median']:.2f} ms "
              f"(runs {['%.2f' % t for t in s['rollout_ms']]}); profiled rollout "
              f"{s['profiled_rollout_ms']:.2f} ms: device busy {s['device_busy_ms']} ms "
              f"(idle share {s['device_idle_share']}) of which conv kernel "
              f"{s['conv_kernel_device_ms']} ms; "
              f"{s['launches_per_forecast']} launches, first two calls vs plain "
              f"{s['first_two_calls_max_abs_err']:.3g} (tol {s['first_two_calls_tolerance']:.3g}), "
              f"8 submits in {s['submit_dispatches']} dispatches, vs direct "
              f"{s['submit_vs_direct_max_err_in_std']:.3g} std", flush=True)

    # the kernel line: one flagship model call's worth (its 10 convs) at the
    # serving batch 1 in bfloat16; launches are the bfloat16 forecast's
    main = {(c["n"], c["cin"], c["cout"]): c for c in cases
            if c["batch"] == 1 and c["dtype"] == "bfloat16"}
    per_call = [main[s] for s in FLAGSHIP_CONVS]
    kernel = {
        "name": "cs_conv3x3",
        "route": "cuda",
        "source": "dlwp_cs_tpu_torch/csrc/cs_conv3x3.cu",
        "replaces": "dlwp_cs_tpu/ops/pallas_conv.py:131",
        "launches": serve[0]["launches_per_forecast"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["ms"] for c in per_call),
        "plain_ms": sum(c["plain_ms"] for c in per_call),
        "bound_ms": sum(c["bound_ms"] for c in per_call),
        "bound_by": "bytes" if sum(c["bytes"] / HBM_BYTES_PER_S for c in per_call)
        >= sum(c["ops"] / PEAK_OPS[torch.bfloat16] for c in per_call) else "operations",
        "library_ms": sum(c["library_ms"] for c in per_call),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_seconds": cs_conv3x3.build_seconds, "registers": regs,
                   "conv_cases": cases, "serve": serve, "kernel": kernel}, f, indent=1)
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
