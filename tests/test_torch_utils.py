"""The port's ``utils/`` against the JAX package's: the misc helpers, the
checkpoint wait, the conv roofline, the profiler trace and the timer.

The misc helpers and ``conv_roofline`` are exact (the same numpy and
Python arithmetic on both sides): equal results, no tolerance.
"""

import datetime as dt
import json
import time

import numpy as np
import pytest
import torch

from dlwp_cs_tpu.utils import misc as jmisc
from dlwp_cs_tpu.utils import profiling as jprofiling
from dlwp_cs_tpu_torch import utils
from dlwp_cs_tpu_torch.tools.timing import HBM_BYTES_PER_S, PEAK_OPS
from dlwp_cs_tpu_torch.utils import misc, profiling

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)


def test_utils_exports_the_reference_names():
    import dlwp_cs_tpu.utils as jutils

    assert sorted(utils.__all__) == sorted(jutils.__all__)
    for name in ("day_of_year", "train_test_split_ind", "delete_nan_samples"):
        assert getattr(utils, name) is getattr(misc, name)
    assert utils.conv_roofline is profiling.conv_roofline


@pytest.mark.parametrize("days", [0.0, 59.75, 9668.5, -0.25, [0.0, 31.0, 365.9, 366.0, 9668.5]])
def test_day_of_year_matches_reference(days):
    ours, ref = misc.day_of_year(days), jmisc.day_of_year(days)
    np.testing.assert_array_equal(ours, ref)
    assert type(ours) is type(ref)


@pytest.mark.parametrize("method", ["last", "first", "random"])
@pytest.mark.parametrize("n,test_size", [(10, 3), (37, 0.25), (37, 0.5), (100, 1)])
def test_train_test_split_matches_reference(n, test_size, method):
    ours = misc.train_test_split_ind(n, test_size, method=method)
    ref = jmisc.train_test_split_ind(n, test_size, method=method)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
        assert o.dtype == r.dtype
    assert sorted(np.concatenate(ours).tolist()) == list(range(n))


@pytest.mark.parametrize("args,kwargs", [((10, 0), {}), ((10, 10), {}), ((10, 0.0), {}),
                                         ((10, 1.0), {}), ((10, 3), {"method": "middle"})])
def test_train_test_split_errors_match_reference(args, kwargs):
    with pytest.raises(ValueError) as ref:
        jmisc.train_test_split_ind(*args, **kwargs)
    with pytest.raises(ValueError) as ours:
        misc.train_test_split_ind(*args, **kwargs)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_delete_nan_samples_matches_reference(axis):
    x = np.random.default_rng(axis).normal(size=(5, 6, 4))
    samples = np.moveaxis(x, axis, 0)  # a view: samples 1 and 3 get a NaN
    samples[1, 0, 0] = samples[3, -1, -1] = np.nan
    ours, kept = misc.delete_nan_samples(x, axis=axis)
    ref, ref_kept = jmisc.delete_nan_samples(x, axis=axis)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(kept, ref_kept)
    assert not np.isnan(ours).any() and ours.shape[axis] == x.shape[axis] - 2


def test_wait_for_checkpoints_after_a_save(tmp_path):
    from dlwp_cs_tpu_torch.train.train_step import TrainState

    state = TrainState({"w": torch.arange(6.0).reshape(2, 3)}, {"count": torch.tensor(1)}, 3)
    path = utils.save_checkpoint(tmp_path, state, step=3, extras={"a": 1})
    t0 = time.perf_counter()
    assert utils.wait_for_checkpoints() is None
    assert time.perf_counter() - t0 < 1.0  # synchronous saves: nothing to wait for
    assert path.is_dir() and utils.latest_step(tmp_path) == 3
    restored, extras = utils.restore_checkpoint(tmp_path, state)
    assert extras == {"a": 1}
    torch.testing.assert_close(restored.params["w"], state.params["w"], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 48, 12, 32, 3, 4), (16, 24, 64, 64, 3, 2),
                                   (8, 12, 128, 128, 1, 4)])
def test_conv_roofline_matches_reference(shape):
    batch, n, cin, cout, kernel, dtype_bytes = shape
    kw = dict(batch=batch, n=n, cin=cin, cout=cout, kernel=kernel, dtype_bytes=dtype_bytes)
    for peaks in ({"peak_flops": 197e12, "hbm_bw": 8.1e11},
                  {"peak_flops": PEAK_OPS[torch.bfloat16], "hbm_bw": HBM_BYTES_PER_S}):
        assert profiling.conv_roofline(**kw, **peaks) == jprofiling.conv_roofline(**kw, **peaks)
    # the defaults are the H100's, from the one copy in tools/timing.py
    assert profiling.conv_roofline(**kw) == jprofiling.conv_roofline(
        **kw, peak_flops=PEAK_OPS[torch.bfloat16], hbm_bw=HBM_BYTES_PER_S)
    assert (PEAK_OPS[torch.bfloat16], HBM_BYTES_PER_S) == (989e12, 3.35e12)


def test_trace_writes_a_readable_chrome_trace(tmp_path):
    a = torch.randn(16, 16)
    with profiling.trace(tmp_path / "prof") as path:
        torch.mm(a, a)
    assert path.parent == tmp_path / "prof" and path.name.endswith(".trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with profiling.trace(tmp_path / "prof") as second:
        torch.mm(a, a)
    assert second != path and sorted((tmp_path / "prof").iterdir()) == sorted([path, second])


def test_timer_and_time_fn():
    with profiling.Timer() as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 1.0
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.002)
        return {"y": (x + 1, [x * 2])}

    mean = profiling.Timer.time_fn(fn, torch.ones(3), iters=4, warmup=3)
    assert len(calls) == 7
    assert 0.002 <= mean < 0.5


def test_time_fn_synchronizes_the_outputs_cuda_devices(monkeypatch):
    """Before each clock read ``time_fn`` waits for every CUDA device its
    outputs live on (found through nested tuples, lists and dicts), and for
    no device when they hold none."""

    class OnCard(torch.Tensor):  # a host tensor that says it lives on cuda:1
        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return torch.device("cuda", 1)

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    profiling.Timer.time_fn(lambda: (torch.ones(1), [2]), iters=2, warmup=1)
    assert synced == []
    card = torch.ones(2).as_subclass(OnCard)
    profiling.Timer.time_fn(lambda: {"a": [torch.ones(1)], "b": (card, 3)}, iters=2, warmup=1)
    assert synced == [torch.device("cuda", 1)] * 2


def test_day_of_year_and_converters_agree():
    day = misc.datetime_to_days(dt.datetime(2026, 6, 21, 12))
    assert misc.day_of_year(day) == 172.0
