"""The device trace of a window: ``torch.profiler`` over the measured
window, reduced to the numbers the per-layer metrics read.

On a card :class:`Tracer` records the device activity and the CUDA API
calls (CUPTI) and no host ops, which would cost every op some
microseconds and slow a host-bound window; on the CPU it records host ops.
:meth:`Tracer.summary` keeps the device intervals inside the window
(marked on the wall clock, the profiler's own): busy seconds (the union of
every kernel, copy and set), kernel counts and times by name, the time of
the kernels named in ``kernels/*.json`` (the 3x3 convs), and the longest
idle gaps named by the innermost CUDA call running at their middle.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict

import numpy as np

def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list (the last
    bracketed group, which may follow ``(anonymous namespace)::``)."""
    name = re.sub(r"^void ", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:120]


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime")


def busy_segments(starts, ends, w0: int, w1: int):
    """The union of the intervals ``[starts, ends)`` clipped to ``[w0,
    w1]``, as sorted disjoint ``(segment starts, segment ends)``."""
    s = np.clip(np.asarray(starts, np.int64), w0, w1)
    e = np.clip(np.asarray(ends, np.int64), w0, w1)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    seg_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return s[new], seg_end


class Tracer:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self.w0 = self.w1 = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def window(self):
        """Marks the measured window on the profiler's clock (ns since
        the epoch)."""
        self.w0 = time.time_ns()
        try:
            yield
        finally:
            self.w1 = time.time_ns()

    def summary(self, conv_patterns: list[str]) -> dict:
        events = self._prof.profiler.kineto_results.events()
        w0, w1 = self.w0, self.w1
        if w0 is None or w1 is None:
            raise RuntimeError("no window was marked")
        dev = []        # (start, end, name, is_kernel)
        host = []       # (start, end, name)
        for ev in events:
            start = ev.start_ns()
            end, name = start + ev.duration_ns(), ev.name()
            # torch's event has ``activity_type`` in newer releases only
            kind = ev.activity_type() if hasattr(ev, "activity_type") else None
            if not str(ev.device_type()).endswith("CPU"):
                if kind is None or kind in DEVICE_KINDS:
                    is_kernel = kind == "kernel" if kind is not None else \
                        not name.startswith(("Memcpy", "Memset"))
                    dev.append((start, end, name, is_kernel))
            elif kind is None or kind in HOST_KINDS:
                host.append((start, end, name))
        dev = [d for d in dev if d[1] > w0 and d[0] < w1]
        out = {"window_s": (w1 - w0) / 1e9, "busy_s": 0.0, "kernels": 0, "device_ops": 0,
               "conv_s": 0.0, "conv_kernels": 0, "other_s": 0.0, "by_name": {},
               "idle_gaps": []}
        if not dev:
            return out
        seg_start, seg_end = busy_segments([d[0] for d in dev], [d[1] for d in dev], w0, w1)
        out["busy_s"] = float((seg_end - seg_start).sum()) / 1e9
        per = defaultdict(lambda: [0, 0.0, False])   # raw name -> count, seconds, kernel
        for (a, b, name, is_kernel) in dev:
            rec = per[name]
            rec[0] += 1
            rec[1] += (min(b, w1) - max(a, w0)) / 1e9
            rec[2] = is_kernel
        conv = re.compile("|".join(re.escape(p) for p in conv_patterns)) if conv_patterns else None
        by_name = defaultdict(float)
        for name, (count, dur, is_kernel) in per.items():
            by_name[short_name(name)] += dur
            out["device_ops"] += count
            if is_kernel:
                out["kernels"] += count
            if is_kernel and conv is not None and conv.search(name):
                out["conv_s"] += dur
                out["conv_kernels"] += count
            else:
                out["other_s"] += dur
        out["by_name"] = dict(by_name)
        # idle gaps: before the first op, between segments, after the last
        gs = np.concatenate([[w0], seg_end])
        ge = np.concatenate([seg_start, [w1]])
        gaps = ge - gs
        keep = np.argsort(gaps)[::-1][:500]
        keep = keep[gaps[keep] > 0]
        if len(keep) and host:
            hs = np.array([h[0] for h in host], np.int64)
            he = np.array([h[1] for h in host], np.int64)
            hd = he - hs
            names = [h[2] for h in host]
            spent = defaultdict(float)
            for k in keep:
                mid = (gs[k] + ge[k]) // 2
                cover = np.flatnonzero((hs <= mid) & (he >= mid))
                label = names[cover[np.argmin(hd[cover])]] if len(cover) else "host, no CUDA call"
                spent[label] += gaps[k] / 1e9
            out["idle_gaps"] = sorted(spent.items(), key=lambda kv: -kv[1])[:10]
        return out


@contextlib.contextmanager
def traced_window(enabled: bool):
    """Around the measured window: a :class:`Tracer` (its window marked)
    when ``enabled``, else ``None``."""
    if not enabled:
        yield None
        return
    with Tracer() as tr, tr.window():
        yield tr
