"""The port's lat-lon ops and models (``ops/latlon.py``,
``models/latlon_unet.py``, ``LatLonConvLSTMCell``) against the JAX
package's.

The port's models are built with their own seeded parameters, which are
handed to the reference as its flax tree.  Tolerances, relative to the
largest |value| of the reference: the padding bitwise (the same copies);
float32 convs and models 1e-5 (sums in another order); their gradients
1e-4 (sums over every pixel); bfloat16 models 2**-6 (a rounding flip in one
conv carries through the rest, two bf16 ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.models import LatLonUNet as JLatLonUNet
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.models.convlstm import CubeSphereConvLSTM as JLayer
from dlwp_cs_tpu.models.convlstm import LatLonConvLSTMCell as JLatLonCell
from dlwp_cs_tpu.ops import latlon as jlatlon
from dlwp_cs_tpu_torch.models import (
    CubeSphereConvLSTM,
    LatLonConv2D,
    LatLonConvLSTMCell,
    LatLonUNet,
    UNetConfig,
    load_jax_params,
)
from dlwp_cs_tpu_torch.ops import latlon
from tests.test_torch_quant import _flax_params, _np

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("lat_mode", ["symmetric", "reflect", "polar", "zero"])
@pytest.mark.parametrize("width", [1, 2, (2, 3), (0, 2), (3, 0)])
def test_periodic_pad_bitwise_equal_reference(lat_mode, width):
    x = _rand(2, 6, 8, 3, seed=1)
    ours = latlon.periodic_pad(torch.from_numpy(x), width, lat_mode=lat_mode)
    ref = np.asarray(jlatlon.periodic_pad(jnp.asarray(x), width, lat_mode=lat_mode))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_periodic_pad_errors():
    x = torch.zeros(1, 4, 5, 1)
    for width, mode, match in (((0, 0), "symmetric", "invalid"), (-1, "zero", "invalid"),
                               (1, "wrap", "unknown"), ((0, 1), "wrap", "unknown"),
                               (1, "polar", "even")):
        with pytest.raises(ValueError, match=match):
            latlon.periodic_pad(x, width, lat_mode=mode)
    with pytest.raises(ValueError, match="odd"):
        latlon.latlon_conv(x, torch.zeros(2, 3, 1, 1))


@pytest.mark.parametrize("kshape,stride,lat_mode", [
    ((3, 3), 1, "symmetric"), ((3, 5), 1, "polar"), ((5, 1), 1, "zero"),
    ((3, 3), 2, "symmetric"), ((1, 1), 2, "zero"),
])
def test_latlon_conv_matches_reference(kshape, stride, lat_mode):
    x, k, b = _rand(2, 8, 16, 3, seed=2), _rand(*kshape, 3, 5, seed=3), _rand(5, seed=4)
    ours = latlon.latlon_conv(torch.from_numpy(x), torch.from_numpy(k),
                              bias=torch.from_numpy(b), stride=stride, lat_mode=lat_mode)
    ref = jlatlon.latlon_conv(jnp.asarray(x), jnp.asarray(k), bias=jnp.asarray(b),
                              stride=stride, lat_mode=lat_mode)
    assert ours.shape == ref.shape
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("upsample,dtype", [("nearest", "float32"), ("bilinear", "float32"),
                                            ("nearest", "bfloat16")])
def test_latlon_unet_matches_reference(upsample, dtype):
    kw = dict(output_channels=3, filters=(4, 8), upsample=upsample, compute_dtype=dtype)
    model = LatLonUNet(UNetConfig(**kw), 5, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    jmodel = JLatLonUNet(JUNetConfig(**kw))
    params = _flax_params(model)
    x = _rand(2, 8, 16, 5, seed=5)
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    ours = model(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 8, 16, 3)
    _close(ours, ref, 1e-5 if dtype == "float32" else 2.0**-6)
    # the reference's tree loads back by name
    again = load_jax_params(LatLonUNet(UNetConfig(**kw), 5, device="cpu"), _np(params))
    torch.testing.assert_close(again(torch.from_numpy(x)), ours, rtol=0, atol=0)
    if dtype == "bfloat16" or upsample == "bilinear":
        return
    # gradients of a squared loss, every parameter and the input
    xt = torch.from_numpy(x).requires_grad_()
    loss = (model(xt) ** 2).sum()
    grads = torch.autograd.grad(loss, [xt] + list(model.parameters()))
    jg = jax.jit(jax.grad(lambda p, v: jnp.sum(jmodel.apply(p, v) ** 2), argnums=(0, 1)))(
        params, jnp.asarray(x))
    _close(grads[0], jg[1], 1e-4)
    names = [n.split(".") for n, _ in model.named_parameters()]
    for (_, scope, leaf), g in zip(names, grads[1:]):
        _close(g, jg[0]["params"][scope][leaf], 1e-4)


def test_latlon_unet_longitude_periodic_and_indivisible_grid():
    """Rolling the input in longitude rolls the output (by a multiple of the
    pool window, which two levels need); a grid that the levels do not
    divide is refused."""
    model = LatLonUNet(UNetConfig(output_channels=2, filters=(4, 8)), 3, device="cpu")
    x = torch.from_numpy(_rand(1, 8, 16, 3, seed=6))
    with torch.no_grad():
        out, rolled = model(x), model(torch.roll(x, 6, dims=2))
    torch.testing.assert_close(rolled, torch.roll(out, 6, dims=2), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 9, 16, 3))
    conv = LatLonConv2D(3, 6)
    assert tuple(conv(torch.zeros(2, 8, 16, 3)).shape) == (2, 8, 16, 6)
    assert {n for n, _ in conv.named_parameters()} == {"kernel", "bias"}


@pytest.mark.parametrize("lat_mode", ["reflect", "polar"])
def test_latlon_convlstm_layer_with_carry_matches_reference(lat_mode):
    """``CubeSphereConvLSTM(cell_cls=LatLonConvLSTMCell)`` over a sequence
    split in two, the carry passed back in, against the reference's."""
    xs = _rand(2, 4, 8, 16, 3, seed=7)
    layer = CubeSphereConvLSTM(3, 4, cell_cls=LatLonConvLSTMCell,
                               cell_kwargs={"lat_mode": lat_mode}, return_sequences=True,
                               generator=torch.Generator().manual_seed(1))
    jlayer = JLayer(features=4, cell_cls=JLatLonCell, cell_kwargs={"lat_mode": lat_mode},
                    return_sequences=True)
    params = _flax_params(layer)
    apply = jax.jit(lambda p, v, c=None: jlayer.apply(p, v, c, return_carry=True))
    first_j, carry_j = apply(params, jnp.asarray(xs[:, :2]))
    second_j, _ = apply(params, jnp.asarray(xs[:, 2:]), carry_j)
    first, carry = layer(torch.from_numpy(xs[:, :2]), return_carry=True)
    second = layer(torch.from_numpy(xs[:, 2:]), carry)
    for ours, ref in ((first, first_j), (carry[0], carry_j[0]), (carry[1], carry_j[1]),
                      (second, second_j)):
        _close(ours, ref, 1e-5)
    assert isinstance(layer.cell, LatLonConvLSTMCell)
    assert set(layer.jax_scopes()) == {"cell/gates"}
    again = load_jax_params(CubeSphereConvLSTM(3, 4, cell_cls=LatLonConvLSTMCell,
                                               cell_kwargs={"lat_mode": lat_mode},
                                               return_sequences=True), _np(params))
    torch.testing.assert_close(again(torch.from_numpy(xs[:, 2:]), carry), second, rtol=0, atol=0)
