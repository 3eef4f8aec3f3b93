"""The port's HTTP front end (``dlwp_cs_tpu_torch.serve.http``) against the
JAX package's.

The HTTP cases of ``tests/test_serve.py`` on the CPU at n = 8 (filters (4,
8)): the JAX estimator gets seeded flax parameters and normalization
stats, the port's estimator the same tree through ``load_jax_params``.
Tolerances:

* ``/forecast`` against the JAX server's response on the same weights:
  2e-5 of the largest std on denormalized fields (float32 sums in another
  order);
* a response against a direct call of the same service: equal (the same
  operations; a coalesced batch runs them at another batch size, where the
  plain convs' sums keep their order per output: 1e-4 of the largest std,
  as ``tests/test_torch_serve.py``);
* ``/ensemble`` with a seed against ``forecast_ensemble`` with a CPU
  generator seeded alike: equal.
"""

import http.client
import json
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
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.serve import (
    ForecastHTTPServer,
    ForecastService,
    ensemble_request,
    forecast_request,
    serve_forever,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}
STD_MAX = 300.0


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
    t0 = np.asarray([9668.5, 9700.25, 9701.0, 10123.75])
    return jest, est, const, windows, t0


@pytest.fixture()
def server(served):
    _, est, const, _, _ = served
    svc = ForecastService(est, constants=const, max_wait_ms=50.0)
    srv = ForecastHTTPServer(svc, port=0).start()
    yield srv
    srv.stop()


def test_health_and_info(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read()) == {"status": "ok"}
    conn.request("GET", "/info")
    info = json.loads(conn.getresponse().read())
    assert info["grid_n"] == N
    assert info["variables"] == ["z500", "t2m"]
    assert info["constants"] == ["topography"]
    assert info["quantized"] is False
    assert set(info["stats"]) == {"requests", "batches", "mean_batch", "padded_members",
                                  "padded_mesh", "device_seconds"}
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    conn.close()


def test_forecast_round_trip_matches_reference_server(served, server):
    """``/forecast`` of the port against the JAX package's server on the
    same weights, and against a direct call."""
    from dlwp_cs_tpu.serve import ForecastHTTPServer as JForecastHTTPServer
    from dlwp_cs_tpu.serve import ForecastService as JForecastService
    from dlwp_cs_tpu.serve import forecast_request as j_forecast_request

    jest, _, const, windows, t0 = served
    fields, lead, init = forecast_request("127.0.0.1", server.port, windows[1], t0[1], 2)
    jsrv = JForecastHTTPServer(JForecastService(jest, constants=const), port=0).start()
    try:
        jfields, jlead, jinit = j_forecast_request("127.0.0.1", jsrv.port, windows[1], t0[1], 2)
    finally:
        jsrv.stop()
    assert fields.shape == jfields.shape == (1, 4, 6, N, N, 2)
    assert fields.dtype == np.float32
    np.testing.assert_allclose(fields, jfields, rtol=0, atol=2e-5 * STD_MAX)
    np.testing.assert_array_equal(lead, jlead)
    np.testing.assert_array_equal(init, jinit)
    direct = server.service.forecast(windows[1], t0[1], steps=2)
    np.testing.assert_array_equal(fields, direct.fields)
    # normalized mode over the wire
    normed = (windows[1] - np.float32(STATS["mean"])) / np.float32(STATS["std"])
    f_n, _, _ = forecast_request("127.0.0.1", server.port, normed, t0[1], 2, normalized=True)
    np.testing.assert_array_equal(
        f_n, server.service.forecast(normed, t0[1], steps=2, normalized=True).fields)


def test_concurrent_requests_coalesce(served, server):
    _, _, _, windows, t0 = served
    results = {}

    def call(i):
        results[i] = forecast_request("127.0.0.1", server.port, windows[i], t0[i], 2)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert set(results) == {0, 1, 2}
    assert server.service.stats.requests == 3
    for i, (fields, _, init) in results.items():
        direct = server.service.forecast(windows[i], t0[i], steps=2)
        np.testing.assert_allclose(fields, direct.fields, rtol=0, atol=1e-4 * STD_MAX)
        np.testing.assert_array_equal(init, [t0[i]])


def test_malformed_post_rejected(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/forecast", body=b"not-an-npz",
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/elsewhere", body=b"x")
    assert conn.getresponse().status == 404
    conn.close()


def test_ensemble_with_a_seed(served, server):
    """``/ensemble`` through the batcher (one window) and as a direct
    dispatch (a batch of windows), each against ``forecast_ensemble`` with
    a CPU generator seeded from the request's ``seed``."""
    _, _, _, windows, t0 = served
    got = ensemble_request("127.0.0.1", server.port, windows[0], t0[0], 2, 3,
                           amplitude=0.1, seed=7, keep_members=True)
    want = server.service.forecast_ensemble(
        windows[0], t0[0], steps=2, members=3, amplitude=0.1,
        generator=torch.Generator().manual_seed(7), keep_members=True)
    assert set(got) == {"mean", "spread", "members", "lead_hours", "init_times"}
    assert got["mean"].shape == (1, 4, 6, N, N, 2) and got["members"].shape[1] == 3
    for k in ("mean", "spread", "members"):
        np.testing.assert_array_equal(got[k], getattr(want, k))
    np.testing.assert_array_equal(got["init_times"], [t0[0]])
    batch = ensemble_request("127.0.0.1", server.port, windows[:2], t0[0], 2, 2, seed=3)
    want = server.service.forecast_ensemble(windows[:2], t0[0], steps=2, members=2,
                                            generator=torch.Generator().manual_seed(3))
    assert "members" not in batch
    np.testing.assert_array_equal(batch["mean"], want.mean)
    np.testing.assert_array_equal(batch["spread"], want.spread)


def test_caps_rejected_over_http(served):
    _, est, const, windows, t0 = served
    svc = ForecastService(est, constants=const, max_members=4, max_steps=3)
    srv = ForecastHTTPServer(svc, port=0).start()
    try:
        with pytest.raises(RuntimeError, match="400"):
            ensemble_request("127.0.0.1", srv.port, windows[0], t0[0], 2, 99)
        with pytest.raises(RuntimeError, match="400.*server-side cap"):
            forecast_request("127.0.0.1", srv.port, windows[0], t0[0], 4)
        with pytest.raises(RuntimeError, match="400.*window must be"):
            forecast_request("127.0.0.1", srv.port, windows[0][..., :1], t0[0], 1)
    finally:
        srv.stop()


def _held(svc):
    """Make ``svc``'s forecast dispatch wait for the returned event."""
    gate = threading.Event()
    slow = svc._forecast_batch

    def held(*args, **kwargs):
        gate.wait(timeout=60)
        return slow(*args, **kwargs)

    svc._forecast_batch = held
    return gate


def _wait_until(cond):
    for _ in range(2000):
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached")


def _post_in_thread(port, window, t0, out, key):
    def run():
        try:
            out[key] = forecast_request("127.0.0.1", port, window, t0, 1)
        except RuntimeError as e:
            out[key] = e

    t = threading.Thread(target=run)
    t.start()
    return t


def test_full_queue_is_503(served):
    _, est, const, windows, t0 = served
    svc = ForecastService(est, constants=const, max_queue=1, max_wait_ms=0.0)
    gate = _held(svc)
    srv = ForecastHTTPServer(svc, port=0).start()
    out = {}
    try:
        first = _post_in_thread(srv.port, windows[0], t0[0], out, "first")
        _wait_until(lambda: svc._worker is not None and svc._queue.empty())
        second = _post_in_thread(srv.port, windows[1], t0[1], out, "second")
        _wait_until(lambda: svc._queue.full())
        with pytest.raises(RuntimeError, match="503.*queue full"):
            forecast_request("127.0.0.1", srv.port, windows[2], t0[2], 1)
        gate.set()
        first.join(timeout=120)
        second.join(timeout=120)
        assert not first.is_alive() and not second.is_alive()
        assert out["first"][0].shape == out["second"][0].shape == (1, 2, 6, N, N, 2)
    finally:
        gate.set()
        srv.stop()


def test_expired_request_is_504(served):
    _, est, const, windows, t0 = served
    svc = ForecastService(est, constants=const, max_wait_ms=0.0, request_timeout_s=0.5)
    gate = _held(svc)
    srv = ForecastHTTPServer(svc, port=0).start()
    out = {}
    try:
        first = _post_in_thread(srv.port, windows[0], t0[0], out, "first")
        _wait_until(lambda: svc._worker is not None and svc._queue.empty())
        stale = _post_in_thread(srv.port, windows[1], t0[1], out, "stale")
        _wait_until(lambda: not svc._queue.empty())
        time.sleep(0.8)  # the queued request's deadline passes
        gate.set()
        first.join(timeout=120)
        stale.join(timeout=120)
        assert not first.is_alive() and not stale.is_alive()
        assert out["first"][0].shape == (1, 2, 6, N, N, 2)
        assert isinstance(out["stale"], RuntimeError) and "504" in str(out["stale"])
        assert "expired" in str(out["stale"])
    finally:
        gate.set()
        srv.stop()


def test_serve_forever_blocks_until_interrupted(served, monkeypatch, capsys):
    """The blocking entry point binds, answers and closes the service on
    its way out (a ``KeyboardInterrupt`` from its loop)."""
    from dlwp_cs_tpu_torch.serve import http as http_mod

    _, est, const, _, _ = served
    svc = ForecastService(est, constants=const)
    seen = {}

    def interrupted(self, poll_interval=0.5):
        seen["port"] = self.server_address[1]
        raise KeyboardInterrupt

    monkeypatch.setattr(http_mod.ThreadingHTTPServer, "serve_forever", interrupted)
    serve_forever(svc, host="127.0.0.1", port=0, verbose=False)
    assert "listening on 127.0.0.1:" in capsys.readouterr().out
    assert seen["port"] > 0
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((2, 6, N, N, 2), np.float32), 0.0, steps=1)
