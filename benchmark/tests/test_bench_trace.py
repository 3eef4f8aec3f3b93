"""The trace's reduction: the union of device intervals inside the
window, and a traced CPU window's summary."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.trace import Tracer, busy_segments, short_name


def test_busy_segments_merge_and_clip():
    s, e = busy_segments([5, 0, 12, 30, 14], [10, 3, 20, 40, 16], 2, 35)
    assert s.tolist() == [2, 5, 12, 30] and e.tolist() == [3, 10, 20, 35]
    assert int((e - s).sum()) == 1 + 5 + 8 + 5


def test_short_names():
    assert short_name("void cs_conv3x3_tc_kernel<float, 4>(float const*, int)") == \
        "cs_conv3x3_tc_kernel<float, 4>"


def test_traced_cpu_window_has_a_marker_and_no_device_time():
    with Tracer() as tr:
        with tr.window():
            x = torch.randn(64, 64)
            for _ in range(3):
                x = x @ x
    out = tr.summary(["cs_conv3x3"])
    assert out["window_s"] > 0 and out["busy_s"] == 0.0 and out["kernels"] == 0
    assert np.isfinite(out["window_s"])


class _Event:
    """A profiler event as older torch releases give it: no
    ``activity_type``."""

    def __init__(self, name, start, dur, device):
        self._v = (name, start, dur, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_summary_of_events_without_activity_types():
    from types import SimpleNamespace

    evs = [_Event("void (anonymous namespace)::cs_conv3x3_tc_kernel<float, 4>(float*)", 100, 50,
                  "DeviceType.CUDA"),
           _Event("at::native::add_kernel(int)", 160, 20, "DeviceType.CUDA"),
           _Event("Memcpy DtoH (Device -> Pageable)", 190, 10, "DeviceType.CUDA"),
           _Event("cudaLaunchKernel", 150, 40, "DeviceType.CPU")]
    tr = Tracer.__new__(Tracer)
    tr._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    tr.w0, tr.w1 = 90, 210
    out = tr.summary(["cs_conv3x3"])
    assert out["kernels"] == 2 and out["device_ops"] == 3 and out["conv_kernels"] == 1
    assert (out["busy_s"], out["conv_s"], out["other_s"]) == pytest.approx((80e-9, 50e-9, 30e-9))
    # gaps 90-100, 150-160, 180-190, 200-210: the middle two under the launch call
    assert dict(out["idle_gaps"]) == pytest.approx({"cudaLaunchKernel": 20e-9,
                                                    "host, no CUDA call": 20e-9})
