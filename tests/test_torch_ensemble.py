"""The port's ensembles, ensemble serving and estimator facade against the
JAX package.

A C8 U-Net of narrow widths (filters 4, 8) gets the same flax parameters in
both packages (``load_jax_params``).  The reference draws its perturbations
from a JAX key inside its rollout; the port draws them from a
``torch.Generator``, so the parity tests hand the reference's perturbations
(``dlwp_cs_tpu.rollout.ic_perturbations`` on the same key) to the port.
Tolerances, as ``ROADMAP.md`` records for models: float32 2e-5 in
normalized units (fields of order 1, sums in another order, carried over
2-3 steps), bfloat16 2**-6 of the largest output (for an ensemble's mean
and spread, of its largest member: their errors are the members'); the
float32 bound scales by the largest std for denormalized fields.
"""

import dataclasses
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
from dlwp_cs_tpu.rollout import EnsembleForecaster as JEnsembleForecaster
from dlwp_cs_tpu.rollout import ic_perturbations as j_ic_perturbations
from dlwp_cs_tpu.rollout import make_ensemble_rollout as j_make_ensemble_rollout
from dlwp_cs_tpu.rollout import make_lagged_rollout as j_make_lagged_rollout
from dlwp_cs_tpu.rollout import make_multimodel_rollout as j_make_multimodel_rollout
from dlwp_cs_tpu.rollout import stack_params as j_stack_params
from dlwp_cs_tpu.serve.service import ForecastService as JForecastService
from dlwp_cs_tpu_torch.data import MemoryStore
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.models import load_jax_params
from dlwp_cs_tpu_torch.rollout import (
    EnsembleForecast,
    EnsembleForecaster,
    ic_perturbations,
    make_ensemble_rollout,
    make_lagged_rollout,
    make_multimodel_rollout,
    stack_params,
)
from dlwp_cs_tpu_torch.serve import ForecastService

N = 8
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}
F32 = 2e-5


def _pair(dtype="float32", seed=1):
    """The JAX estimator and the port's (on the CPU) with one flax tree."""
    jcfg = JExperimentConfig(data=JDataConfig(**DATA),
                             model=JUNetConfig(filters=(4, 8), compute_dtype=dtype))
    jest = JEstimator(jcfg)
    x0 = jnp.zeros((1, 6, N, N, jcfg.data.input_channels))
    params = jax.jit(jest.model.init)(jax.random.PRNGKey(seed), x0)
    jest.state = types.SimpleNamespace(params=params)
    jest.stats = STATS
    cfg = ExperimentConfig(data=DataConfig(**DATA),
                           model=UNetConfig(filters=(4, 8), compute_dtype=dtype))
    est = DLWPEstimator(cfg, device="cpu").load_state(
        STATS, jax.tree_util.tree_map(np.array, params))
    return jest, est


@pytest.fixture(scope="module")
def pairs():
    return {d: _pair(d) for d in ("float32", "bfloat16")}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    windows = rng.normal(size=(3, 2, 6, N, N, 2)).astype(np.float32)  # normalized
    return const, windows


def _kw(est, const):
    lat, lon = est.cs.cell_latlon
    return dict(lat=lat, lon=lon, constants=const, insol_mean=STATS["insol_mean"],
                insol_std=STATS["insol_std"])


def _close(ours, ref, dtype, scale=1.0, largest=None):
    """float32: ``F32 * scale``; bfloat16: 2**-6 of the largest model
    output (``largest``: the members' largest |value|, for a mean or a
    spread, whose errors are the members'; default: ``ref``'s)."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    largest = float(np.abs(ref).max()) if largest is None else largest
    tol = F32 * scale if dtype == "float32" else 2.0**-6 * largest
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


def _close_ensemble(ours, ref, dtype, scale=1.0):
    """Members, mean and spread; in bfloat16 each to 2**-6 of the largest
    member."""
    largest = float(np.abs(np.asarray(ref.members)).max())
    for name in ("members", "mean", "spread"):
        _close(getattr(ours, name), getattr(ref, name), dtype, scale, largest)


# ---- ic_perturbations ------------------------------------------------------

@pytest.mark.parametrize("members,antithetic", [(1, True), (4, True), (5, True), (5, False),
                                                (2, False)])
def test_ic_perturbations_structure_matches_reference(members, antithetic):
    """Both packages: member 0 zero, the others unit Gaussian in antithetic
    pairs (the last unpaired when members - 1 is odd), mean zero over the
    members for odd counts; the port's draws repeat with the seed and land
    on the requested device."""
    shape = (2, 2, 6, N, N, 3)
    ours = ic_perturbations(torch.Generator().manual_seed(3), shape, members,
                            antithetic=antithetic, device="cpu")
    ref = np.asarray(j_ic_perturbations(jax.random.PRNGKey(3), shape, members,
                                        antithetic=antithetic))
    again = ic_perturbations(torch.Generator().manual_seed(3), shape, members,
                             antithetic=antithetic)
    assert torch.equal(ours, again) and ours.device.type == "cpu"
    for p in (ours.numpy(), ref):
        assert p.shape == (2, members) + shape[1:] and p.dtype == np.float32
        assert not p[:, 0].any()
        npert = members - 1
        if antithetic and npert:
            half = (npert + 1) // 2
            np.testing.assert_array_equal(p[:, 1 + half : members], -p[:, 1 : 1 + npert - half])
            if members % 2:
                np.testing.assert_allclose(p.mean(axis=1), 0.0, atol=1e-6)
        if npert:
            assert 0.8 < float(p[:, 1:].std()) < 1.2
    with pytest.raises(ValueError, match="members"):
        ic_perturbations(torch.Generator(), shape, 0)


# ---- the rollouts ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ensemble_rollout_matches_reference(pairs, data, dtype):
    """Members folded into one rollout's batch, with the reference's
    perturbations: mean, spread (ddof=1) and every member."""
    jest, est = pairs[dtype]
    const, windows = data
    members, steps, amp = 3, 2, np.asarray([0.1, 0.05], np.float32)
    t0 = np.asarray([123.25, 1400.75], np.float32)
    kw = _kw(est, const)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(j_make_ensemble_rollout(
        jest.model.apply, jest.config.data, steps=steps, members=members, keep_members=True,
        **kw))(jest.state.params, jnp.asarray(windows[:2]), jnp.asarray(t0), key, amp)
    pert = np.array(j_ic_perturbations(key, windows[:2].shape, members))
    ours = make_ensemble_rollout(est.model, est.config.data, steps=steps, members=members,
                                 keep_members=True, device="cpu", **kw)(
        windows[:2], t0, pert, amp)
    assert isinstance(ours, EnsembleForecast)
    assert tuple(ours.members.shape) == (2, members, steps * 2, 6, N, N, 2)
    _close_ensemble(ours, ref, dtype)
    np.testing.assert_array_equal(ours.lead_hours.numpy(), np.asarray(ref.lead_hours))
    short = make_ensemble_rollout(est.model, est.config.data, steps=1, members=1,
                                  device="cpu", **kw)
    one = short(windows[:1], 5.0, np.zeros((1, 1) + windows.shape[1:], np.float32), 0.1)
    assert one.members is None and not one.spread.any()
    with pytest.raises(ValueError, match="perturbations"):
        short(windows[:1], 5.0, pert, 0.1)


def test_multimodel_rollout_matches_reference(pairs, data):
    """Two models of one architecture (two seeds): the reference vmaps over
    the stacked flax trees, the port rolls each model's slice of the
    stacked parameters out in turn."""
    const, windows = data
    (jest, est), (jest2, est2) = pairs["float32"], _pair(seed=2)
    kw = _kw(est, const)
    t0 = np.asarray([50.5, 900.0], np.float32)
    ref = jax.jit(j_make_multimodel_rollout(
        jest.model.apply, jest.config.data, steps=2, keep_members=True, **kw))(
        j_stack_params([jest.state.params, jest2.state.params]), jnp.asarray(windows[:2]),
        jnp.asarray(t0))
    stack = stack_params([dict(est.model.named_parameters()),
                          dict(est2.model.named_parameters())])
    model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(4, 8)),
                           est.config.data.input_channels, device="cpu")
    ours = make_multimodel_rollout(model, est.config.data, steps=2, keep_members=True,
                                   device="cpu", **kw)(stack, windows[:2], t0)
    _close_ensemble(ours, ref, "float32")
    with pytest.raises(ValueError, match="structure"):
        stack_params([dict(est.model.named_parameters()), {"x": torch.zeros(1)}])


def test_lagged_rollout_matches_reference(pairs, data):
    """Members started 0, 1 and 3 steps before the control, aligned by
    valid time."""
    jest, est = pairs["float32"]
    const, windows = data
    kw = _kw(est, const)
    lags = (0, 1, 3)
    rng = np.random.default_rng(4)
    stack = rng.normal(size=(2, 3, 2, 6, N, N, 2)).astype(np.float32)
    t0 = np.asarray([300.0, 301.5], np.float32)
    ref = jax.jit(j_make_lagged_rollout(jest.model.apply, jest.config.data, steps=2, lags=lags,
                                        keep_members=True, **kw))(
        jest.state.params, jnp.asarray(stack), jnp.asarray(t0))
    ours = make_lagged_rollout(est.model, est.config.data, steps=2, lags=lags,
                               keep_members=True, device="cpu", **kw)(stack, t0)
    _close_ensemble(ours, ref, "float32")
    np.testing.assert_array_equal(ours.lead_hours.numpy(), np.asarray(ref.lead_hours))
    with pytest.raises(ValueError, match="lags"):
        make_lagged_rollout(est.model, est.config.data, steps=1, lags=(1, 2), device="cpu",
                            **kw)


def test_ensemble_forecaster_matches_reference(pairs, data):
    """``predict`` with a present-day float64 init (reduced modulo the
    insolation period before the float32 clock) and the reference's
    perturbations; one configuration cached at a time; a seeded generator
    by default."""
    jest, est = pairs["float32"]
    const, windows = data
    kw = _kw(est, const)
    t0 = np.asarray([9668.5 + 1461.0 * 3, 9700.25])
    key = jax.random.PRNGKey(11)
    ref = JEnsembleForecaster(jest.model.apply, jest.state.params, jest.config.data,
                              **kw).predict(jnp.asarray(windows[:2]), t0, steps=2, members=4,
                                            key=key, amplitude=0.2, keep_members=True)
    fc = EnsembleForecaster(est.model, est.config.data, device="cpu", **kw)
    pert = np.array(j_ic_perturbations(key, windows[:2].shape, 4))
    ours = fc.predict(windows[:2], t0, steps=2, members=4, amplitude=0.2, keep_members=True,
                      perturbations=pert)
    _close_ensemble(ours, ref, "float32")
    np.testing.assert_array_equal(ours.init_times, t0)
    assert ours.variables == ("z500", "t2m")
    first = fc._cached[1]
    fc.predict(windows[:2], t0, steps=2, members=4, keep_members=True)
    assert fc._cached[1] is first
    a = fc.predict(windows[:1], 0.0, steps=1, members=3)
    assert fc._cached[0] == (1, 3, False) and a.members is None
    b = fc.predict(windows[:1], 0.0, steps=1, members=3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.mean, b.mean) and torch.equal(a.spread, b.spread)


# ---- serving -----------------------------------------------------------------

def _raw(windows):
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    return (windows * std + mean).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_ensemble_matches_reference_service(pairs, data, dtype):
    """``forecast_ensemble`` against the JAX service's, raw units in and
    out: the mean and members denormalized, the spread only scaled; and in
    normalized units."""
    jest, est = pairs[dtype]
    const, windows = data
    raw = _raw(windows[:2])
    t0 = np.asarray([9668.5, 9700.25])
    key = jax.random.PRNGKey(5)
    jsvc = JForecastService(jest, constants=const)
    svc = ForecastService(est, constants=const)
    std = np.asarray(STATS["std"], np.float32)
    ref = jsvc.forecast_ensemble(raw, t0, steps=2, members=3, amplitude=0.1, key=key,
                                 keep_members=True)
    pert = np.array(j_ic_perturbations(key, raw.shape, 3))
    ours = svc.forecast_ensemble(raw, t0, steps=2, members=3, amplitude=0.1, keep_members=True,
                                 perturbations=pert)
    assert all(isinstance(getattr(ours, k), np.ndarray) for k in ("members", "mean", "spread"))
    _close_ensemble(ours, ref, dtype, scale=float(std.max()))
    np.testing.assert_array_equal(ours.init_times, t0)
    assert svc.stats.requests == 2 and svc.stats.batches == 1
    # the same normalized inputs in normalized units: the raw call's mean and
    # members are these denormalized, its spread only scaled
    mean = np.asarray(STATS["mean"], np.float32)
    normed = svc.forecast_ensemble((raw - mean) / std, t0, steps=2, members=3, amplitude=0.1,
                                   keep_members=True, perturbations=pert, normalized=True)
    np.testing.assert_array_equal(ours.spread, normed.spread * std)
    np.testing.assert_array_equal(ours.mean, normed.mean * std + mean)
    np.testing.assert_array_equal(ours.members, normed.members * std + mean)
    jsvc.close()
    svc.close()


def _keys(service):
    """The coalescing keys of the requests ``service`` enqueues."""
    seen = []
    enqueue = service._enqueue

    def spy(req):
        seen.append(req.key)
        return enqueue(req)

    service._enqueue = spy
    return seen


def test_submit_ensemble_coalesces_and_equals_the_stacked_dispatch(pairs, data):
    """Three concurrent requests with one key coalesce into one dispatch
    (padded to a bucket of 4) and equal ``forecast_ensemble`` of the three
    stacked windows with the same seed; the key is the reference's; other
    seeds do not coalesce with them."""
    jest, est = pairs["float32"]
    const, windows = data
    raw = _raw(windows)
    t0 = [9668.5, 9669.0, 9669.5]
    svc = ForecastService(est, constants=const, max_batch=8, max_wait_ms=500.0)
    jsvc = JForecastService(jest, constants=const, max_batch=8, max_wait_ms=1.0)
    keys, jkeys = _keys(svc), _keys(jsvc)
    args = dict(steps=2, members=3, amplitude=np.asarray([0.1, 0.2]), seed=4,
                keep_members=True)
    futs = [svc.submit_ensemble(raw[i], t0[i], **args) for i in range(3)]
    got = [f.result(timeout=120) for f in futs]
    assert svc.stats.requests == 3 and svc.stats.batches == 1
    assert svc.stats.padded_members == 1
    direct = svc.forecast_ensemble(raw, np.asarray(t0), steps=2, members=3,
                                   amplitude=np.asarray([0.1, 0.2]), keep_members=True,
                                   generator=torch.Generator().manual_seed(4))
    std = float(np.asarray(STATS["std"]).max())
    for i, fc in enumerate(got):
        assert fc.mean.shape == (1, 4, 6, N, N, 2) and fc.members.shape[:2] == (1, 3)
        np.testing.assert_array_equal(fc.init_times, [t0[i]])
        for name in ("members", "mean", "spread"):
            np.testing.assert_allclose(getattr(fc, name), getattr(direct, name)[i : i + 1],
                                       rtol=0, atol=1e-5 * std)
    jsvc.submit_ensemble(raw[0], t0[0], **args).result(timeout=300)
    assert keys[0] == jkeys[0] == ("ens", 2, 3, (0.10000000149011612, 0.20000000298023224), 4,
                                   True, True, False)
    other = svc.submit_ensemble(raw[0], t0[0], **dict(args, seed=5))
    same = svc.submit_ensemble(raw[1], t0[1], **args)
    other.result(timeout=120)
    same.result(timeout=120)
    assert svc.stats.batches == 4  # the direct call, and one per seed
    svc.close()
    jsvc.close()


def test_ensemble_caps_and_mesh(pairs, data):
    """The members cap (``max_members``) as the reference's, on both calls."""
    jest, est = pairs["float32"]
    const, windows = data
    svc = ForecastService(est, constants=const, max_members=4)
    jsvc = JForecastService(jest, constants=const, max_members=4)
    for service in (svc, jsvc):
        with pytest.raises(ValueError, match="members=5 outside"):
            service.forecast_ensemble(_raw(windows[0]), 0.0, steps=1, members=5)
        with pytest.raises(ValueError, match="members=0 outside"):
            service.submit_ensemble(_raw(windows[0]), 0.0, steps=1, members=0)
        with pytest.raises(ValueError, match="one window"):
            service.submit_ensemble(_raw(windows[:2]), 0.0, steps=1, members=2)
    svc.close()
    jsvc.close()


# ---- the estimator's facade --------------------------------------------------

@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(9)
    mean, std = np.asarray(STATS["mean"]), np.asarray(STATS["std"])
    fields = (rng.normal(size=(8, 6, N, N, 2)) * std + mean).astype(np.float32)
    times = 9000.0 + 0.25 * np.arange(8)
    const = rng.normal(size=(6, N, N, 2)).astype(np.float32)
    return MemoryStore.from_raw(fields, times, ("z500", "t2m"), constants=const,
                                constant_names=("lsm", "topography"))


def test_estimator_forecast_matches_reference(pairs, store):
    """``forecast`` from a store's samples (per-init float64 times, the
    store's constants by name) against the JAX estimator's on the same
    store; a store marked normalized is not normalized again."""
    jest, est = pairs["float32"]
    ref = jest.forecast(store, init_indices=[1, 5], steps=2)
    ours = est.forecast(store, init_indices=[1, 5], steps=2)
    _close(ours.fields, ref.fields, "float32")
    np.testing.assert_array_equal(ours.init_times, ref.init_times)
    assert ours.variables == ref.variables
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    pre = dataclasses.replace(store, fields=(store.fields - mean) / std,
                              attrs={**store.attrs, "normalized": True})
    again = est.forecast(pre, init_indices=[1, 5], steps=2)
    np.testing.assert_allclose(again.fields.numpy(), ours.fields.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="preceding"):
        est.forecast(store, init_indices=[0], steps=1)


def test_estimator_forecast_lagged_matches_reference(pairs, store):
    jest, est = pairs["float32"]
    ref = jest.forecast_lagged(store, init_indices=[4, 6], steps=2, lags=(0, 2),
                               keep_members=True)
    ours = est.forecast_lagged(store, init_indices=[4, 6], steps=2, lags=(0, 2),
                               keep_members=True)
    _close_ensemble(ours, ref, "float32")
    np.testing.assert_array_equal(ours.init_times, ref.init_times)
    assert ours.variables == ref.variables
    again = est.forecast_lagged(store, init_indices=[4, 6], steps=2, lags=(0, 2),
                                keep_members=True)
    torch.testing.assert_close(again.members, ours.members, rtol=0, atol=0)
    with pytest.raises(ValueError, match="max lag"):
        est.forecast_lagged(store, init_indices=[2], steps=1, lags=(0, 2))


def test_estimator_denormalize_and_replace_config(pairs, store):
    jest, est = pairs["float32"]
    x = np.random.default_rng(2).normal(size=(2, 3, 6, N, N, 2)).astype(np.float32)
    np.testing.assert_allclose(est.denormalize(x), jest.denormalize(x), rtol=1e-6)
    np.testing.assert_allclose(est.denormalize(torch.from_numpy(x)), jest.denormalize(x),
                               rtol=1e-6)
    other = est.replace_config(train=dataclasses.replace(est.config.train, batch_size=3))
    jother = jest.replace_config(train=dataclasses.replace(jest.config.train, batch_size=3))
    assert other.config.train.batch_size == jother.config.train.batch_size == 3
    assert other.config.data == est.config.data and other.state is None
    assert other.device == est.device and other is not est
