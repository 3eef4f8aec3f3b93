"""The port's rollout and channel conventions against the JAX package.

The same flax parameters (carried across with ``load_jax_params``), window,
constants and init times go to both.  Tolerances: the channel transforms
are exact; the rollout is float32 end to end with sums in another order,
so fields agree to 1e-5 (the golden test's own probe tolerance) and the
insolation channels to the geometry test's 2e-3 W/m^2, normalized here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.data import channels as jchannels
from dlwp_cs_tpu.geometry import CubedSphere as JCubedSphere
from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.rollout import make_rollout_fn as j_make_rollout_fn
from dlwp_cs_tpu_torch.data import channels
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.models import (
    CubeSphereUNet,
    DataConfig,
    UNetConfig,
    load_jax_params,
)
from dlwp_cs_tpu_torch.rollout import TimeSeriesEstimator, make_rollout_fn
from tests.test_golden_rollout import GOLDEN_MEAN, GOLDEN_PROBES, GOLDEN_STD

N = 8


def _models(dcfg_kwargs, seed):
    jd, td = JDataConfig(**dcfg_kwargs), DataConfig(**dcfg_kwargs)
    jm = JUNet(JUNetConfig(output_channels=jd.output_channels, filters=(4, 8)))
    x0 = jnp.zeros((1, 6, N, N, jd.input_channels))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), x0)
    tm = CubeSphereUNet(UNetConfig(output_channels=td.output_channels, filters=(4, 8)),
                        td.input_channels, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.array, params))
    return jd, td, jm, params, tm


def test_rollout_reproduces_golden_values():
    dcfg = dict(grid_n=N, variables=("a", "b"), constants=())
    _, td, _, _, tm = _models(dcfg, seed=7)
    lat, lon = CubedSphere(N).cell_latlon
    rng = np.random.default_rng(42)
    window = rng.normal(size=(1, 2, 6, N, N, 2)).astype(np.float32)
    roll = make_rollout_fn(tm, td, lat=lat, lon=lon, insol_mean=300.0,
                           insol_std=400.0, steps=4, device="cpu")
    f = roll(torch.from_numpy(window), 123.25).fields.numpy()
    assert f.shape == (1, 8, 6, N, N, 2)
    assert float(f.mean()) == pytest.approx(GOLDEN_MEAN, abs=1e-6)
    assert float(f.std()) == pytest.approx(GOLDEN_STD, abs=1e-6)
    for (lead, face, ch), expect in GOLDEN_PROBES.items():
        assert float(f[0, lead, face, 3, 4, ch]) == pytest.approx(
            expect, abs=1e-5
        ), (lead, face, ch)


def test_rollout_matches_reference_with_constants_and_batch_times():
    dcfg = dict(grid_n=N, variables=("a", "b"), constants=("c",))
    jd, td, jm, params, tm = _models(dcfg, seed=3)
    lat, lon = CubedSphere(N).cell_latlon
    rng = np.random.default_rng(5)
    window = rng.normal(size=(2, 2, 6, N, N, 2)).astype(np.float32)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    t0 = np.asarray([123.25, 1400.75], np.float32)
    kw = dict(lat=lat, lon=lon, constants=const, insol_mean=300.0,
              insol_std=400.0, steps=3)
    ref = jax.jit(j_make_rollout_fn(jm.apply, jd, **kw))(
        params, jnp.asarray(window), jnp.asarray(t0))
    ours = make_rollout_fn(tm, td, device="cpu", **kw)(window, t0)
    assert tuple(ours.fields.shape) == ref.fields.shape == (2, 6, 6, N, N, 2)
    np.testing.assert_allclose(ours.fields.numpy(), np.asarray(ref.fields),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.lead_hours.numpy(), np.asarray(ref.lead_hours))
    with pytest.raises(ValueError, match="window"):
        make_rollout_fn(tm, td, device="cpu", **kw)(window[:, :1], t0)
    with pytest.raises(ValueError, match="t0_days"):
        make_rollout_fn(tm, td, device="cpu", **kw)(window, t0[:1].repeat(3))


def test_estimator_reduces_init_time_in_float64():
    """predict() reduces present-day epoch days mod 1461 in float64 before
    the float32 clock, and keeps the original init times."""
    dcfg = dict(grid_n=N, variables=("a", "b"), constants=())
    _, td, _, _, tm = _models(dcfg, seed=7)
    lat, lon = CubedSphere(N).cell_latlon
    window = np.random.default_rng(42).normal(size=(1, 2, 6, N, N, 2))
    est = TimeSeriesEstimator(tm, td, lat, lon, insol_mean=300.0,
                              insol_std=400.0, device="cpu")
    t0 = 123.25 + 7 * 1461.0
    fc = est.predict(window.astype(np.float32), t0, steps=4)
    f = fc.fields.numpy()
    assert float(f.mean()) == pytest.approx(GOLDEN_MEAN, abs=1e-6)
    assert fc.init_times == t0 and fc.variables == ("a", "b")
    np.testing.assert_allclose(fc.valid_times()[0, :2], t0 + np.asarray([0.25, 0.5]))


def test_channel_conventions_match_reference():
    rng = np.random.default_rng(9)
    jd = JDataConfig(grid_n=N, variables=("a", "b", "c"))
    td = DataConfig(grid_n=N, variables=("a", "b", "c"))
    window = rng.normal(size=(2, 2, 6, N, N, 3)).astype(np.float32)
    insol = rng.normal(size=(2, 6, N, N)).astype(np.float32)
    const = rng.normal(size=(6, N, N, 2)).astype(np.float32)
    packed = channels.pack_inputs(*map(torch.from_numpy, (window, insol, const)))
    ref = jchannels.pack_inputs(*map(jnp.asarray, (window, insol, const)))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    assert packed.shape[-1] == td.input_channels == jd.input_channels
    out = rng.normal(size=(2, 6, N, N, 6)).astype(np.float32)
    nw, ow = channels.advance_window(torch.from_numpy(window), torch.from_numpy(out), 2)
    rnw, row = jchannels.advance_window(jnp.asarray(window), jnp.asarray(out), 2)
    np.testing.assert_array_equal(nw.numpy(), np.asarray(rnw))
    np.testing.assert_array_equal(ow.numpy(), np.asarray(row))
    back = channels.unfold_time(channels.fold_time(torch.from_numpy(window)), 2)
    np.testing.assert_array_equal(back.numpy(), window)
    with pytest.raises(ValueError):
        channels.unfold_time(torch.zeros(1, 6, N, N, 5), 2)
    # insolation channels for a (B,) clock
    lat, lon = (a.astype(np.float32) for a in JCubedSphere(N).cell_latlon)
    t = np.asarray([10.125, 777.5], np.float32)
    ours = channels.make_input_insolation(
        td, torch.from_numpy(lat), torch.from_numpy(lon), 300.0, 400.0
    )(torch.from_numpy(t))
    ref = jchannels.make_input_insolation(jd, lat, lon, 300.0, 400.0)(jnp.asarray(t))
    assert tuple(ours.shape) == (2, 2, 6, N, N)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=2e-3 / 400.0)
