"""Device timing, bounds and checks shared by the kernel tools and
``chip_smoke.py``.

The counterpart of the reference's ``tools/_timing.py`` and of its tools'
chained-scan ``time_chain`` functions: a call's device time, with host
launch overhead kept out by a CUDA graph, and with a cold L2
(:func:`cold_ms`) for a pass that would otherwise fit in it.  On the CPU nothing is timed
(:func:`device_ms` returns ``None``): a tool never reports the plain path's
CPU time as if it were the card's.  Beside it: the least time the H100
could take for a call (:func:`bound`), the bfloat16 check every kernel is
held to against its plain version (:func:`bf16_excess`) and the layout of
the one cuDNN call that computes the cubed-sphere conv (:func:`face_grouped`).
The measurement tools time whole steps and rollouts on the host clock
(:func:`wall_ms`) and name the card beside every time (:func:`card`).
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_OPS", "TF32_OPS", "add_device_args", "bf16_excess",
           "bound", "card", "check_close", "cold_ms", "device_ms", "face_grouped", "graph_ms",
           "tool_device", "wall_ms"]

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s
# and the fastest rate of float32-accurate work for the kernel's input type.
# bf16: the tensor cores' 989 TFLOP/s.  float32: the tensor cores as 3xTF32,
# three TF32 products (495 TFLOP/s each) per float32 product, which beats
# the CUDA cores' 67 TFLOP/s.  int8: the tensor cores' 1979 TOP/s
HBM_BYTES_PER_S = 3.35e12
TF32_OPS = 495e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: TF32_OPS / 3, torch.int8: 1979e12}


def bound(nbytes, ops, dtype):
    """The least time the card could take for ``nbytes`` moved and ``ops``
    operations of ``dtype`` (the larger of the two), and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes, "ops": ops}


def bf16_excess(ours, ref):
    """How far |ours - ref| exceeds one bf16 ulp of |ref| (2**-7 relative);
    ``ours`` and ``ref`` may be tensors or tuples of tensors."""
    if isinstance(ours, (tuple, list)):
        return max(bf16_excess(a, r) for a, r in zip(ours, ref))
    d = (ours.float() - ref.float()).abs() - ref.float().abs() * 2.0**-7
    return float(d.max())


def check_close(name, ours, ref):
    """Max |ours - ref| (tensors or tuples of tensors); raises beyond one
    bf16 ulp of |ref| + 1e-4 for bfloat16, beyond 1e-4 for float32."""
    ours, ref = (ours, ref) if isinstance(ours, (tuple, list)) else ((ours,), (ref,))
    err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(ours, ref))
    if (bf16_excess(ours, ref) if ref[0].dtype == torch.bfloat16 else err) > 1e-4:
        raise RuntimeError(f"{name} disagrees with its plain version: max |diff| {err}")
    return err


def face_grouped(padded, ks):
    """The padded faces or blocks ``(B, 6*Cin, H+2, W+2)`` (channels-last
    in memory) and kernels ``(6*Cout, Cin, 3, 3)`` of one face-grouped cuDNN
    conv that computes the CS conv whose halo-padded input is ``padded``
    ``(B, 6, H+2, W+2, Cin)``, with ``ks = (k_eq, k_pole)``."""
    b, _, hp, wp, cin = padded.shape
    p = padded.permute(0, 2, 3, 1, 4).reshape(b, hp, wp, 6 * cin).permute(0, 3, 1, 2)
    w = torch.cat([ks[0].permute(3, 2, 0, 1)] * 4 + [ks[1].permute(3, 2, 0, 1)] * 2)
    return p, w.contiguous(memory_format=torch.channels_last)


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


def cold_ms(fn, reps, flush_bytes=1 << 28):
    """Device milliseconds per call of ``fn`` with its inputs out of the
    L2: before each of ``reps`` calls a ``flush_bytes`` buffer (256 MB,
    five times an H100's 50 MB L2) is read, which leaves the L2 holding
    clean lines of it (a write would leave dirty lines whose write-back
    the timed call would pay for), and CUDA events bracket the call alone,
    whose launch the host issues while the read still runs; the median
    call."""
    flush = torch.zeros(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.max()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, device):
    """:func:`graph_ms` of ``fn`` on a CUDA ``device``; ``None`` on the CPU."""
    return None if torch.device(device).type == "cpu" else graph_ms(fn, reps)


def wall_ms(fn, calls, repeats, device):
    """``(median, spread)`` in milliseconds per call of ``fn``: the host
    clock around ``calls`` calls that end in ``torch.cuda.synchronize()``,
    over ``repeats`` runs after one untimed call (the median run and the
    slowest less the fastest, both divided by ``calls``).  ``(None,
    None)`` on the CPU, after the one call: a tool never reports a CPU time
    as the card's."""
    fn()
    if torch.device(device).type == "cpu":
        return None, None
    torch.cuda.synchronize(device)
    runs = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
        runs.append((time.perf_counter() - t) * 1e3 / calls)
    return statistics.median(runs), max(runs) - min(runs)


@functools.lru_cache(maxsize=None)
def _nvidia_smi_card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; on the CPU ``"cpu (no
    times)"``."""
    return "cpu (no times)" if torch.device(device).type == "cpu" else _nvidia_smi_card()


def add_device_args(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their plain versions)")
    ap.add_argument("--small", action="store_true",
                    help="small sizes (required on the CPU)")


def tool_device(args) -> torch.device:
    """The device a tool runs on: the card unless ``--device cpu`` (which
    needs ``--small``); raises without a card."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass --device cpu --small to run the plain "
                               "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type == "cpu":
        if not args.small:
            raise ValueError("on the CPU the tools run the plain versions at --small sizes only")
    else:
        raise ValueError(f"--device must be cuda or cpu, not {args.device}")
    return dev
