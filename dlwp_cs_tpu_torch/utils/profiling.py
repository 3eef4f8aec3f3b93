"""Profiling helpers: ``torch.profiler`` traces, the program's spans and
roofline accounting.

The counterpart of ``dlwp_cs_tpu.utils.profiling``: a Chrome/Perfetto
trace around training or rollout steps (:func:`trace`), a wall clock
(:class:`Timer`) and the speed-of-light estimate of one cubed-sphere conv
(:func:`conv_roofline`), whose default peaks are the H100's of
``tools/timing.py`` (the one copy of those constants).

The port's own addition is its span recorder: :func:`span` marks a piece
of host work at a layer boundary (the service, the rollout), and
:func:`record_spans` collects the spans made while it is open, on the
wall clock that ``torch.profiler`` stamps its events with, so that a span
and the device trace of the same seconds line up.  Recording is off by
default; :func:`span` then costs one test and returns :data:`NO_SPAN`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS

__all__ = ["trace", "Timer", "conv_roofline", "Span", "span", "record_spans", "NO_SPAN"]


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


class Span(NamedTuple):
    """One recorded span.  ``start_ns`` / ``end_ns``: ns since the epoch, the
    clock of ``torch.profiler``'s events; ``thread``: the thread's ident;
    ``id``: unique within its recording (each counts from 1);
    ``parent``: the enclosing span's ``id`` on the same thread (``None`` for
    a root); ``request``: the root's ``id``, shared by every span of one
    request; ``attrs``: the keywords given to :func:`span`."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    request: int
    attrs: dict


class _NoSpan:
    """The context :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Recording:
    """The state of one :func:`record_spans`: finished spans as raw tuples
    on the monotonic clock, the id counter and each thread's open spans."""

    def __init__(self):
        self.done: list[tuple] = []  # list.append is atomic: threads share it
        self.ids = itertools.count(1)
        self.local = threading.local()


_recording: _Recording | None = None


class _OpenSpan:
    __slots__ = ("rec", "name", "attrs", "start", "id", "parent", "request")

    def __init__(self, rec: _Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        local = self.rec.local
        stack = local.__dict__.setdefault("stack", [])
        self.id = next(self.rec.ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec.local.stack.pop()
        self.rec.done.append((self.name, self.start, end, threading.get_ident(), self.id,
                              self.parent, self.request, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` over the enclosed code while
    :func:`record_spans` is open, as a child of the thread's innermost open
    span.  Otherwise it returns :data:`NO_SPAN`: no clock is read.

    Usage::

        with span("service.prepare"):
            window = (window - mean) / std
    """
    rec = _recording
    if rec is None:
        return NO_SPAN
    return _OpenSpan(rec, name, attrs)


@contextlib.contextmanager
def record_spans():
    """Record the spans of every thread while open; yields a list that
    holds them as :class:`Span` once the block ends (spans still open then
    are left out).  Spans are timed on the monotonic clock and moved onto
    the wall clock (``time.time_ns``, the clock ``torch.profiler`` stamps
    its events with) by one anchor read when recording starts.  One
    recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec, out = _Recording(), []
    m0 = time.perf_counter_ns()
    wall = time.time_ns()
    m1 = time.perf_counter_ns()
    offset = wall - (m0 + m1) // 2
    _recording = rec
    try:
        yield out
    finally:
        _recording = None
        out.extend(Span(name, a + offset, b + offset, *rest)
                   for name, a, b, *rest in rec.done[:])


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
