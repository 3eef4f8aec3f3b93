"""The port's int8 path (``ops/quant.py``, ``conv_backend="int8"``,
``ForecastService(quantize=True)``) against the JAX package's.

Tolerances, and why:

* the quantizers and the base conv's integer sums: bitwise (the same float32
  arithmetic in the same order; exact integer products);
* one quantized conv: 2e-5 of the largest |output| (the base terms are
  bitwise equal; the float32 ring term sums in another order);
* a whole quantized model: one activation quantum (the layer input's amax
  / 127) flips where the previous layer's float32 sums, taken in another
  order, put a value within an ulp of a rounding midpoint; such a flip moves
  the outputs it reaches by about a quantum times the taps it meets, some
  1e-3 of the largest |output| at these sizes.  The tests hold 5e-3 (no
  flip showed in 12 seeds: 4e-7 at worst), and the reference's own bound
  (relative error < 0.1 against float32) as well.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
from dlwp_cs_tpu.models import ConvLSTMConfig as JConvLSTMConfig
from dlwp_cs_tpu.models import CubeSphereConvLSTMNet as JNet
from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import ExperimentConfig as JExperimentConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.ops import quant as jquant
from dlwp_cs_tpu.serve import ForecastService as JForecastService
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import (
    ConvLSTMConfig,
    CubeSphereConvLSTMNet,
    CubeSphereUNet,
    DataConfig,
    ExperimentConfig,
    UNetConfig,
    load_jax_params,
)
from dlwp_cs_tpu_torch.ops import quant
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.serve import ForecastService

N = 8
MODEL_TOL = 5e-3
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flax_params(model):
    """The port model's parameters as the reference's flax tree (scopes as
    ``model.jax_scopes()`` names them), so no flax ``init`` is traced."""
    tree = {}
    for scope, module in model.jax_scopes().items():
        node = tree
        for part in scope.split("/"):
            node = node.setdefault(part, {})
        node.update({k: jnp.asarray(p.detach().numpy()) for k, p in module.named_parameters()})
    return {"params": tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero", [False, True])
def test_quantizers_bitwise_equal_reference(dtype, zero):
    x = _rand(2, 6, N, N, 5, seed=1, scale=3.0) * (0.0 if zero else 1.0)
    k = _rand(3, 3, 5, 7, seed=2) * (0.0 if zero else 1.0)
    k[..., 3] *= 100.0  # one channel's scale far above the others
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for ours, ref in ((quant.quantize_tensor(torch.from_numpy(x).to(tdt)),
                       jquant.quantize_tensor(jnp.asarray(x).astype(jdt))),
                      (quant.quantize_kernel(torch.from_numpy(k).to(tdt)),
                       jquant.quantize_kernel(jnp.asarray(k).astype(jdt)))):
        assert ours[0].dtype == torch.int8 and ours[1].dtype == torch.float32
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


def test_plain_sums_bitwise_equal_reference_int8_conv():
    """The plain base conv's s32 sums are the reference's ``_same_conv_int8``
    on each face's group (read through a unit scale: float32 holds these
    sums, below 2**24, exactly); its epilogue is ``float(acc) * scale``
    rounded to the dtype."""
    rng = np.random.default_rng(3)
    qx = rng.integers(-127, 128, size=(2, 6, N, N, 5)).astype(np.int8)
    qk = rng.integers(-127, 128, size=(2, 3, 3, 5, 6)).astype(np.int8)
    sums = quant.cs_conv3x3_int8_plain(torch.from_numpy(qx), torch.from_numpy(qk),
                                       torch.ones(2, 6), torch.float32)
    eq, po = (np.asarray(jquant._same_conv_int8(jnp.asarray(qx), jnp.asarray(qk[g])))
              for g in (0, 1))
    assert eq.dtype == np.int32
    ref = np.concatenate([eq[:, :4], po[:, 4:]], axis=1)
    np.testing.assert_array_equal(sums.numpy(), ref.astype(np.float32))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, size=(2, 6)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        out = quant.cs_conv3x3_int8_base(torch.from_numpy(qx), torch.from_numpy(qk), scale,
                                         dtype)
        want = torch.cat([torch.from_numpy(ref[:, :4]).float() * scale[0],
                          torch.from_numpy(ref[:, 4:]).float() * scale[1]], dim=1).to(dtype)
        assert out.dtype == dtype
        torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_matches_reference(dtype):
    x = _rand(2, 6, N, N, 8, seed=4)
    k_eq, k_po = _rand(3, 3, 8, 6, seed=5, scale=0.2), _rand(3, 3, 8, 6, seed=6, scale=0.2)
    b_eq, b_po = _rand(6, seed=7), _rand(6, seed=8)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = np.asarray(jax.jit(
        lambda x, ke, kp, be, bp: jquant.cs_conv3x3_int8(x, ke, kp, bias_eq=be, bias_pole=bp)
    )(*(jnp.asarray(a).astype(jdt) for a in (x, k_eq, k_po, b_eq, b_po))).astype(np.float32))
    tx, tke, tkp, tbe, tbp = (torch.from_numpy(a).to(tdt) for a in (x, k_eq, k_po, b_eq, b_po))
    ours = cs_conv(tx, tke, tkp, bias_eq=tbe, bias_pole=tbp, backend="int8")
    assert ours.dtype == tdt
    # bfloat16: the ring term and the bias round at other points (one ulp)
    tol = 2e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_int8_conv_exact_on_integer_data():
    """Activations and weights that quantize losslessly (integers, amax
    pinned to 127): the int8 conv equals the float32 ring-fix conv."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=(2, 6, N, N, 3)).astype(np.float32)
    x[0, 0, 0, 0, 0] = 127.0
    k_eq = rng.integers(-127, 128, size=(3, 3, 3, 4)).astype(np.float32)
    k_po = rng.integers(-127, 128, size=(3, 3, 3, 4)).astype(np.float32)
    k_eq[0, 0, 0, :] = k_po[0, 0, 0, :] = 127.0
    args = [torch.from_numpy(a) for a in (x, k_eq, k_po)]
    got = quant.cs_conv3x3_int8(*args)
    want = cs_conv(*args, backend="ringfix")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-2)


def test_int8_gradients_skip_the_base_term():
    """The base term carries no gradient; the ring term and the bias do."""
    x = torch.from_numpy(_rand(1, 6, N, N, 3, seed=9)).requires_grad_()
    k = torch.from_numpy(_rand(3, 3, 3, 4, seed=10)).requires_grad_()
    b = torch.zeros(4, requires_grad=True)
    out = cs_conv(x, k, k, bias_eq=b, bias_pole=b, backend="int8")
    g = torch.from_numpy(_rand(*out.shape, seed=11))
    dx, dk, db = torch.autograd.grad((out * g).sum(), (x, k, b))
    rx, rk = torch.autograd.grad((quant.ring_term(x, k, k) * g).sum(), (x, k))
    torch.testing.assert_close(dx, rx, rtol=0, atol=0)
    torch.testing.assert_close(dk, rk, rtol=0, atol=0)
    torch.testing.assert_close(db, g.sum(dim=(0, 1, 2, 3)), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["unet", "convlstm"])
def test_int8_models_match_reference(kind):
    """The quantized U-Net and ConvLSTM against the reference's on the same
    parameters (``MODEL_TOL`` of the largest output), and the reference's
    own bound against the unquantized model."""
    if kind == "unet":
        kw = dict(output_channels=2, filters=(4, 8))
        x = _rand(2, 6, N, N, 3, seed=12)
        jmodel = JUNet(JUNetConfig(**kw, conv_backend="int8"))
        make = lambda backend: CubeSphereUNet(UNetConfig(**kw, conv_backend=backend), 3,
                                              device="cpu")
    else:
        kw = dict(output_channels=4, filters=(4, 4), input_time_steps=2,
                  variable_channels=2, add_insolation=True)
        x = _rand(2, 6, N, N, 2 * 2 + 2 + 1, seed=13)
        jmodel = JNet(JConvLSTMConfig(**kw, conv_backend="int8"))
        make = lambda backend: CubeSphereConvLSTMNet(
            ConvLSTMConfig(**kw, conv_backend=backend), x.shape[-1], device="cpu")
    ours_q = make("int8")
    ours_f = load_jax_params(make("ringfix"), _np(_flax_params(ours_q)))
    ref = np.asarray(jax.jit(jmodel.apply)(_flax_params(ours_q), jnp.asarray(x)))
    with torch.no_grad():
        got = ours_q(torch.from_numpy(x)).numpy()
        full = ours_f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_TOL * float(np.abs(ref).max()))
    assert np.linalg.norm(got - full) / np.linalg.norm(full) < 0.1


@pytest.fixture(scope="module")
def served():
    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4, 8)))
    est = DLWPEstimator(cfg, device="cpu", seed=1).load_state(STATS)
    jest = JEstimator(JExperimentConfig(data=JDataConfig(**DATA),
                                        model=JUNetConfig(filters=(4, 8))))
    jest.state = types.SimpleNamespace(params=_flax_params(est.model))
    jest.stats = STATS
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(2, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    return jest, est, const, windows


def test_quantized_service_matches_reference(served):
    jest, est, const, windows = served
    t0 = np.asarray([9668.5, 9700.25])
    svc = ForecastService(est, constants=const, quantize=True)
    assert svc.quantized and svc.info()["quantized"] is True
    fc = svc.forecast(windows, t0, steps=3)
    ref = JForecastService(jest, constants=const, quantize=True).forecast(windows, t0, steps=3)
    want = np.asarray(ref.fields)
    std = np.asarray(STATS["std"], np.float32)
    assert fc.fields.shape == want.shape
    err = np.abs(fc.fields - want) / std
    assert float(err.max()) <= MODEL_TOL * float((np.abs(want - np.asarray(STATS["mean"]))
                                                  / std).max()), float(err.max())
    plain = ForecastService(est, constants=const).forecast(windows, t0, steps=3)
    assert np.linalg.norm(fc.fields - plain.fields) / np.linalg.norm(plain.fields) < 0.2
    ens = svc.forecast_ensemble(windows[0], t0[0], steps=1, members=2)
    assert ens.mean.shape == (1, 2, 6, N, N, 2) and np.isfinite(ens.mean).all()
    svc.close()


def test_quantize_with_mesh_raises(served):
    _, est, const, _ = served
    with pytest.raises(ValueError, match="incompatible with mesh"):
        ForecastService(est, constants=const, quantize=True, mesh=object())
