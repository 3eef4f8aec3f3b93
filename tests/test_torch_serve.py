"""The port's forecast service against the JAX package.

A JAX estimator is given flax parameters and normalization stats (no
training needed); the port's estimator takes the same tree through
``load_jax_params``.  The service's denormalized forecast is held against
the JAX ``TimeSeriesEstimator.predict`` plus denormalization at 1e-4
(float32 fields of order 1-10 after denormalization; rollout measured to
~1e-6 in normalized units).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import ExperimentConfig as JExperimentConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.rollout import TimeSeriesEstimator as JTimeSeriesEstimator
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.serve import ForecastService, ServiceOverloaded

N = 8
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}


@pytest.fixture(scope="module")
def served():
    jcfg = JExperimentConfig(data=JDataConfig(**DATA), model=JUNetConfig(filters=(4, 8)))
    jest = JEstimator(jcfg)
    x0 = jnp.zeros((1, 6, N, N, jcfg.data.input_channels))
    params = jax.jit(jest.model.init)(jax.random.PRNGKey(1), x0)
    jest.state = types.SimpleNamespace(params=params)
    jest.stats = STATS
    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4, 8)))
    est = DLWPEstimator(cfg, device="cpu").load_state(
        STATS, jax.tree_util.tree_map(np.array, params))
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(4, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    return jest, est, const, windows


def test_forecast_matches_reference(served):
    jest, est, const, windows = served
    svc = ForecastService(est, constants=const)
    t0 = np.asarray([9668.5, 9700.25])
    fc = svc.forecast(windows[:2], t0, steps=3)
    mean, std = svc._mean, svc._std
    lat, lon = jest.cs.cell_latlon
    ref = JTimeSeriesEstimator(
        apply_fn=jest.model.apply, params=jest.state.params, data_cfg=jest.config.data,
        lat=lat, lon=lon, constants=jnp.asarray(const),
        insol_mean=STATS["insol_mean"], insol_std=STATS["insol_std"],
    ).predict(jnp.asarray((windows[:2] - mean) / std), t0, steps=3)
    want = np.asarray(ref.fields) * std + mean
    assert isinstance(fc.fields, np.ndarray) and fc.fields.shape == want.shape
    np.testing.assert_allclose(fc.fields, want, rtol=0, atol=1e-4 * float(std.max()))
    np.testing.assert_array_equal(fc.init_times, t0)
    assert svc.stats.requests == 2 and svc.stats.batches == 1
    normed = svc.forecast((windows[:2] - mean) / std, t0, steps=3, normalized=True)
    np.testing.assert_allclose(normed.fields, np.asarray(ref.fields), rtol=0, atol=1e-5)
    assert svc.info()["grid_n"] == N and svc.info()["quantized"] is False


def test_submit_coalesces_and_equals_direct(served):
    _, est, const, windows = served
    svc = ForecastService(est, constants=const, max_batch=8, max_wait_ms=300.0)
    t0 = [9668.5, 9669.0, 9669.5, 9670.0]
    futs = [svc.submit(windows[i], t0[i], steps=2) for i in range(4)]
    results = [f.result(timeout=120) for f in futs]
    assert svc.stats.requests == 4 and svc.stats.batches < 4
    for i, fc in enumerate(results):
        direct = svc.forecast(windows[i], t0[i], steps=2)
        assert fc.fields.shape == (1, 4, 6, N, N, 2)
        np.testing.assert_allclose(fc.fields, direct.fields, rtol=0, atol=1e-3)
        np.testing.assert_allclose(fc.init_times, [t0[i]])
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(windows[0], t0[0], steps=2)


def test_steps_cap_and_bad_requests(served):
    _, est, const, windows = served
    svc = ForecastService(est, constants=const, max_steps=4)
    with pytest.raises(ValueError, match="steps"):
        svc.forecast(windows[0], 0.0, steps=5)
    with pytest.raises(ValueError, match="steps"):
        svc.submit(windows[0], 0.0, steps=0)
    with pytest.raises(ValueError, match="window"):
        svc.forecast(np.zeros((3, 6, N, N, 2), np.float32), 0.0, steps=1)
    with pytest.raises(ValueError, match="one member"):
        svc.submit(windows[:2], 0.0, steps=1)
    with pytest.raises(ValueError, match="constant"):
        ForecastService(est)


def test_full_queue_raises_overloaded(served):
    _, est, const, windows = served
    svc = ForecastService(est, constants=const, max_queue=1, max_wait_ms=0.0)
    gate = threading.Event()
    slow = svc._forecast_batch

    def held(*args, **kwargs):
        gate.wait(timeout=60)
        return slow(*args, **kwargs)

    svc._forecast_batch = held
    first = svc.submit(windows[0], 0.0, steps=1)  # the worker takes it, then waits
    for _ in range(1000):
        if svc._queue.empty():
            break
        time.sleep(0.01)
    second = svc.submit(windows[1], 0.0, steps=1)  # fills the one-slot queue
    with pytest.raises(ServiceOverloaded):
        svc.submit(windows[2], 0.0, steps=1)
    gate.set()
    assert first.result(timeout=120).fields.shape == (1, 2, 6, N, N, 2)
    assert second.result(timeout=120).fields.shape == (1, 2, 6, N, N, 2)
    svc.close()


def test_unported_options_raise(served):
    """No option raises any more: ``quantize=True`` serves and reports
    ``quantized`` (``tests/test_torch_quant.py`` holds it against the
    reference); the mesh front end's calls refuse a service without a
    mesh."""
    _, est, const, windows = served
    quantized = ForecastService(est, constants=const, quantize=True)
    assert quantized.quantized and quantized.info()["quantized"] is True
    fc = quantized.forecast(windows[0], 0.0, steps=1)
    assert fc.fields.shape == (1, 2, 6, N, N, 2) and np.isfinite(fc.fields).all()
    quantized.close()
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= is tests/test_torch_parallel.py's
        ForecastService(est, constants=const, mesh=object())
    svc = ForecastService(est, constants=const)
    with pytest.raises(RuntimeError, match="follow"):
        svc.follow()
    fc = svc.forecast_ensemble(windows[0], 0.0, steps=1, members=2)
    assert fc.mean.shape == (1, 2, 6, N, N, 2) and svc.stats.padded_mesh == 0
    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4,)))
    with pytest.raises(RuntimeError, match="state"):
        ForecastService(DLWPEstimator(cfg, device="cpu"), constants=const)
    with pytest.raises(KeyError, match="stats"):
        DLWPEstimator(cfg, device="cpu").load_state({"mean": [0.0]})


def test_load_from_checkpoint(served, tmp_path, monkeypatch):
    """``ForecastService.load`` of a saved estimator serves what the
    estimator's service serves (equal: the same weights and operations); it
    runs on the GPU unless a device is named."""
    _, est, const, windows = served
    est.save(tmp_path / "model")
    svc = ForecastService.load(tmp_path / "model", device="cpu", constants=const, max_steps=4)
    assert svc.device.type == "cpu" and svc.max_steps == 4
    fc = svc.forecast(windows[0], 9668.5, steps=2)
    direct = ForecastService(est, constants=const).forecast(windows[0], 9668.5, steps=2)
    np.testing.assert_array_equal(fc.fields, direct.fields)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForecastService.load(tmp_path / "model", constants=const)
