"""Profiling helpers: ``torch.profiler`` traces and roofline accounting.

The counterpart of ``dlwp_cs_tpu.utils.profiling``: a Chrome/Perfetto
trace around training or rollout steps (:func:`trace`), a wall clock
(:class:`Timer`) and the speed-of-light estimate of one cubed-sphere conv
(:func:`conv_roofline`), whose default peaks are the H100's of
``tools/timing.py`` (the one copy of those constants).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS

__all__ = ["trace", "Timer", "conv_roofline"]


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed code with ``torch.profiler`` (CPU activity,
    and CUDA's where a card is present) and write a Chrome/Perfetto trace
    JSON into ``logdir``; yields that file's path.

    Usage::

        with trace("profile"):
            state, _ = trainer.train_step(state, x, y)
            torch.cuda.synchronize()
    """
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"{os.getpid()}-{time.time_ns()}.trace.json"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


def _cuda_devices(out, found: set):
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


def _wait_for(out):
    """Synchronize every CUDA device that a tensor of ``out`` (a tensor or
    nested tuples, lists and dicts of them) lives on."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Plain wall-clock timer: it does NOT synchronize the device.

    CUDA launches return before the device finishes: end the timed region
    with ``torch.cuda.synchronize()`` yourself, or use :meth:`time_fn`,
    which synchronizes."""

    elapsed: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @staticmethod
    def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
        """Mean seconds per call of ``fn(*args)`` over ``iters`` calls after
        ``warmup`` calls; before each clock read it synchronizes the CUDA
        devices that the last call's outputs live on."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        _wait_for(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _wait_for(out)
        return (time.perf_counter() - t0) / iters


def conv_roofline(
    *,
    batch: int,
    n: int,
    cin: int,
    cout: int,
    kernel: int = 3,
    dtype_bytes: int = 4,
    # NVIDIA H100 80GB HBM3 at 700 W: bf16 tensor-core peak and HBM bytes/s
    peak_flops: float = PEAK_OPS[torch.bfloat16],
    hbm_bw: float = HBM_BYTES_PER_S,
) -> dict:
    """Roofline estimate for one cubed-sphere conv (forward), the
    reference's formula: FLOPs over all six faces, bytes of the activations
    read, the result written and both weight groups.

    Returns flops, bytes, arithmetic intensity and the compute and
    bandwidth bound times: the yardstick for judging a kernel against
    measured step times (speed-of-light accounting).
    """
    cells = batch * 6 * n * n
    flops = 2.0 * cells * kernel * kernel * cin * cout
    bytes_accessed = (
        cells * cin * dtype_bytes  # read activations
        + cells * cout * dtype_bytes  # write result
        + 2 * kernel * kernel * cin * cout * dtype_bytes  # weights
    )
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / hbm_bw
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "intensity": flops / bytes_accessed,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "bound": "compute" if t_compute > t_memory else "memory",
        "t_light_s": max(t_compute, t_memory),
    }
