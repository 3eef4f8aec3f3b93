"""The port's ConvLSTM family against the JAX package.

Flax modules are initialised, their parameter trees carried across with
``load_jax_params`` (the nested ``convlstm{i}/cell/gates`` scopes of
``nn.scan``), and both run on the same numpy inputs.  The port runs the
``xring`` conv backend (its plain versions on the CPU); the reference runs
``xring_interpret`` (Pallas interpret mode) for the whole network and the
pad path (``xla``, the same map, pinned equal by its own tests) for the
cell, the layer and the gradients, where interpret mode would only add
time.  Tolerances, relative to the largest entry of the reference:

* float32: 2e-5 (convs summed in another order; the gate math in f32 on
  both sides); gradients 1e-4 (through two recurrent layers, sums over
  every pixel);
* bfloat16 network: 2**-6 (two bf16 ulps: a rounding flip in one gate conv
  carries through the recurrence);
* the forecast: 1e-4 of the variables' std after denormalisation (float32).
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
from dlwp_cs_tpu.models import ConvLSTMConfig as JConvLSTMConfig
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import ExperimentConfig as JExperimentConfig
from dlwp_cs_tpu.models.convlstm import CubeSphereConvLSTM as JLayer
from dlwp_cs_tpu.models.convlstm import CubeSphereConvLSTMCell as JCell
from dlwp_cs_tpu.models.convlstm import CubeSphereConvLSTMNet as JNet
from dlwp_cs_tpu.rollout import TimeSeriesEstimator as JTimeSeriesEstimator
from dlwp_cs_tpu_torch import DLWPEstimator, ForecastService
from dlwp_cs_tpu_torch.data import MemoryStore
from dlwp_cs_tpu_torch.models import (
    ConvLSTMConfig,
    CubeSphereConvLSTM,
    CubeSphereConvLSTMCell,
    CubeSphereConvLSTMNet,
    DataConfig,
    ExperimentConfig,
    LatLonConvLSTMCell,
    TrainConfig,
    load_jax_params,
)
from dlwp_cs_tpu_torch.ops.ring_kernel import xring_fused_apply
from dlwp_cs_tpu_torch.train import model_apply, value_and_grad

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _assert_close(ours, ref, tol):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * float(np.abs(ref).max()))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_cell_matches_flax(dtype):
    """One step from a non-zero carry; a bf16 cell keeps an f32 input's
    output dtype and each carry's own dtype."""
    x, h, c = _rand(2, 6, N, N, 3, seed=1), _rand(2, 6, N, N, 4, seed=2), _rand(2, 6, N, N, 4, seed=3)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    jcell = JCell(features=4, backend="xla", dtype=jdt)
    carry_j = (jnp.asarray(h).astype(jdt or jnp.float32), jnp.asarray(c))
    params = jax.jit(jcell.init)(jax.random.PRNGKey(0), carry_j, jnp.asarray(x))
    (hj, cj), oj = jax.jit(jcell.apply)(params, carry_j, jnp.asarray(x))
    cell = load_jax_params(CubeSphereConvLSTMCell(3, 4, backend="xring", dtype=tdt), _np(params))
    carry_t = (torch.from_numpy(h).to(tdt or torch.float32), torch.from_numpy(c))
    (ht, ct), ot = cell(carry_t, torch.from_numpy(x))
    assert (ht.dtype, ct.dtype, ot.dtype) == (tdt or torch.float32, torch.float32, torch.float32)
    tol = 2e-5 if dtype is None else 2.0**-6
    for ours, ref in ((ht, hj), (ct, cj), (ot, oj)):
        _assert_close(ours, ref, tol)


def test_layer_with_carry_passed_back_matches_flax():
    """A sequence split in two, the carry of the first part passed back in,
    equals the reference's; and the whole sequence in one call."""
    xs = _rand(2, 4, 6, N, N, 3, seed=4)
    jlayer = JLayer(features=4, return_sequences=True, cell_kwargs=dict(backend="xla"))
    params = jax.jit(jlayer.init)(jax.random.PRNGKey(1), jnp.asarray(xs))
    apply = jax.jit(functools.partial(jlayer.apply, return_carry=True))
    first_j, carry_j = apply(params, jnp.asarray(xs[:, :2]))
    second_j, _ = apply(params, jnp.asarray(xs[:, 2:]), carry_j)
    layer = load_jax_params(CubeSphereConvLSTM(3, 4, return_sequences=True, backend="xring"),
                            _np(params))
    first, carry = layer(torch.from_numpy(xs[:, :2]), return_carry=True)
    second = layer(torch.from_numpy(xs[:, 2:]), carry)
    for ours, ref in ((first, first_j), (carry[0], carry_j[0]), (carry[1], carry_j[1]),
                      (second, second_j)):
        _assert_close(ours, ref, 2e-5)
    whole = layer(torch.from_numpy(xs))
    torch.testing.assert_close(whole[:, 2:], second, rtol=0, atol=1e-6)


def _configs(dtype="float32", backend="xring"):
    jcfg = JExperimentConfig(data=JDataConfig(**DATA),
                             model=JConvLSTMConfig(filters=(4, 4), compute_dtype=dtype,
                                                   conv_backend=backend))
    cfg = ExperimentConfig(data=DataConfig(**DATA),
                           model=ConvLSTMConfig(filters=(4, 4), compute_dtype=dtype,
                                                conv_backend="xring"))
    return jcfg, cfg


@functools.lru_cache(maxsize=1)
def _flax_init():
    jcfg, _ = _configs(backend="xla")
    x = np.zeros((1, 6, N, N, jcfg.data.input_channels), np.float32)
    return _np(jax.jit(JNet(jcfg.resolved_model()).init)(jax.random.PRNGKey(2), x))


def _flax_params():
    """A copy of the reference net's parameter tree, which depends on neither
    the conv backend nor the compute dtype (initialised once, through XLA)."""
    return jax.tree_util.tree_map(np.copy, _flax_init())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net_matches_flax(dtype):
    jcfg, cfg = _configs(dtype, backend="xring_interpret")
    x = _rand(2, 6, N, N, cfg.data.input_channels, seed=5)
    params = _flax_params()
    ref = jax.jit(JNet(jcfg.resolved_model()).apply)(params, jnp.asarray(x))
    net = CubeSphereConvLSTMNet(cfg.resolved_model(), cfg.data.input_channels, device="cpu")
    load_jax_params(net, params)
    with torch.no_grad():
        ours = net(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    _assert_close(ours, ref, 2e-5 if dtype == "float32" else 2.0**-6)


def test_net_grads_match_flax():
    """The loss gradient through the whole network (both recurrent layers,
    the xring conv's split VJP) against ``jax.grad``."""
    jcfg, cfg = _configs(backend="xla")
    x = _rand(2, 6, N, N, cfg.data.input_channels, seed=6)
    y = _rand(2, 6, N, N, 4, seed=7)
    params = _flax_params()
    jnet = JNet(jcfg.resolved_model())

    def j_loss(p):
        return jnp.mean(jnp.square(jnet.apply(p, jnp.asarray(x)) - jnp.asarray(y)))

    ref = jax.jit(jax.grad(j_loss))(params)["params"]
    net = CubeSphereConvLSTMNet(cfg.resolved_model(), cfg.data.input_channels, device="cpu")
    load_jax_params(net, params)
    vg = value_and_grad(model_apply(net), lambda p, t: torch.mean(torch.square(p - t)))
    _, grads = vg(dict(net.named_parameters()), torch.from_numpy(x), torch.from_numpy(y))
    for name, g in grads.items():  # convlstm0.cell.gates.kernel_eq, head.bias_pole, ...
        node = ref
        for part in name.split("."):
            node = node[part]
        _assert_close(g, node, 1e-4)


def test_load_jax_params_is_strict_on_the_nested_tree():
    _, cfg = _configs()
    net = CubeSphereConvLSTMNet(cfg.resolved_model(), cfg.data.input_channels, device="cpu")
    params = _flax_params()
    assert sorted(net.jax_scopes()) == ["convlstm0/cell/gates", "convlstm1/cell/gates", "head"]

    def bad(mutate):
        tree = jax.tree_util.tree_map(lambda a: a, params)  # a fresh copy of the dicts
        mutate(tree["params"])
        return tree

    load_jax_params(net, bad(lambda t: None))
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(net, bad(lambda t: t.pop("convlstm1")))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(net, bad(lambda t: t["convlstm0"]["cell"].update(extra={})))
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(net, bad(lambda t: t["convlstm1"]["cell"]["gates"].pop("bias_eq")))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(net, bad(lambda t: t["convlstm0"]["cell"].update(scale=np.ones(2))))
    with pytest.raises(KeyError, match="missing"):  # the U-Net's flat layout
        load_jax_params(net, {"params": {"gates": params["params"]["head"]}})
    before = net.head.kernel_eq.detach().clone()
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net, bad(lambda t: t["head"].update(kernel_eq=np.zeros((1, 1, 4, 3)))))
    torch.testing.assert_close(net.head.kernel_eq.detach(), before, rtol=0, atol=0)


def test_estimator_fits_saves_and_loads_a_convlstm(tmp_path):
    rng = np.random.default_rng(8)
    fields = (rng.normal(size=(10, 6, N, N, 2)) * [300.0, 20.0] + [5400.0, 280.0])
    times = 9000.0 + 0.25 * np.arange(10)
    store = MemoryStore.from_raw(fields.astype(np.float32), times, DATA["variables"],
                                 constants=rng.normal(size=(6, N, N, 1)).astype(np.float32),
                                 constant_names=DATA["constants"])
    _, cfg = _configs()
    cfg = dataclasses.replace(cfg, train=TrainConfig(batch_size=2, max_epochs=1,
                                                     learning_rate=1e-2))
    est = DLWPEstimator(cfg, device="cpu").fit(store, verbose=False)
    assert isinstance(est.model, CubeSphereConvLSTMNet) and est.state.step == 3
    losses = [r["loss"] for r in est._last_history.steps]
    assert len(losses) == 3 and np.isfinite(losses).all()
    est.save(tmp_path / "model")
    back = DLWPEstimator.load(tmp_path / "model", device="cpu")
    assert back.config == est.config and isinstance(back.model, CubeSphereConvLSTMNet)
    for name, p in back.model.named_parameters():
        torch.testing.assert_close(p, est.state.params[name].detach(), rtol=0, atol=0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    window = fields[:2].astype(np.float32)
    a = ForecastService(est, constants=const).forecast(window, times[1], steps=2)
    b = ForecastService(back, constants=const).forecast(window, times[1], steps=2)
    np.testing.assert_array_equal(a.fields, b.fields)
    assert a.fields.shape == (1, 4, 6, N, N, 2) and np.isfinite(a.fields).all()


def test_forecast_matches_reference_rollout():
    """ForecastService on the port's ConvLSTM (xring) against the JAX
    TimeSeriesEstimator on the same parameter tree (pad path)."""
    jcfg, cfg = _configs(backend="xla")
    jest = JEstimator(jcfg)
    params = _flax_params()
    jest.state = types.SimpleNamespace(params=params)
    est = DLWPEstimator(cfg, device="cpu").load_state(STATS, params)
    rng = np.random.default_rng(9)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(2, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    t0 = np.asarray([9668.5, 9700.25])
    before = xring_fused_apply.launches
    fc = ForecastService(est, constants=const).forecast(windows, t0, steps=3)
    assert xring_fused_apply.launches == before  # CPU tensors: the plain version
    lat, lon = jest.cs.cell_latlon
    ref = JTimeSeriesEstimator(
        apply_fn=jest.model.apply, params=params, data_cfg=jest.config.data,
        lat=lat, lon=lon, constants=jnp.asarray(const),
        insol_mean=STATS["insol_mean"], insol_std=STATS["insol_std"],
    ).predict(jnp.asarray((windows - mean) / std), t0, steps=3)
    want = np.asarray(ref.fields) * std + mean
    assert fc.fields.shape == want.shape
    np.testing.assert_allclose(fc.fields, want, rtol=0, atol=1e-4 * float(std.max()))


def test_latlon_cell_is_not_ported():
    """The lat-lon cell is ported (``tests/test_torch_latlon.py`` holds it
    against the reference): it builds, and one step keeps the grid and
    gives ``features`` channels, ``h`` in the cell dtype and ``c`` in
    float32."""
    cell = LatLonConvLSTMCell(3, 4, dtype=torch.bfloat16)
    x = torch.from_numpy(_rand(2, 8, 16, 3, seed=9))
    (h, c), out = cell(cell.initialize_carry(x), x)
    assert tuple(h.shape) == tuple(c.shape) == tuple(out.shape) == (2, 8, 16, 4)
    assert (h.dtype, c.dtype, out.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    assert tuple(cell.gates.kernel.shape) == (3, 3, 7, 16)
