"""The port's ``models/torch_mirror.py`` names against the JAX package's
torch mirror (``dlwp_cs_tpu.models.torch_mirror``) and its flax U-Net, on
the same parameters.  Tolerance 1e-5 of the largest |output| (float32
convolutions summed in another order); the halo pad is a copy and an
average, equal to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.models import torch_mirror as jmirror
from dlwp_cs_tpu_torch.models import UNetConfig
from dlwp_cs_tpu_torch.models import torch_mirror
from dlwp_cs_tpu_torch.models.unet import CubeSphereUNet
from tests.test_torch_quant import _flax_params, _np

N = 8


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(ours, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=tol * float(np.abs(ref).max()))


def test_torch_cs_pad_matches_reference_mirror():
    x = torch.from_numpy(_rand(2, 6, N, N, 3, seed=1))
    for width in (1, 2):
        _close(torch_mirror.torch_cs_pad(x, width), jmirror.torch_cs_pad(x, width), 1e-6)


@pytest.mark.parametrize("kshape,bias", [((3, 3), True), ((3, 3), False), ((1, 1), True),
                                         ((3, 1), True)])
def test_conv_from_flax_matches_reference_mirror(kshape, bias):
    scope = {"kernel_eq": _rand(*kshape, 4, 5, seed=2), "kernel_pole": _rand(*kshape, 4, 5, seed=3)}
    if bias:
        scope.update(bias_eq=_rand(5, seed=4), bias_pole=_rand(5, seed=5))
    x = torch.from_numpy(_rand(2, 6, N, N, 4, seed=6))
    ours = torch_mirror.TorchCubeSphereConv2D.from_flax(scope, device="cpu")
    assert ours.use_bias == bias
    with torch.no_grad():
        _close(ours(x), jmirror.TorchCubeSphereConv2D.from_flax(scope)(x))


def test_unet_mirror_matches_reference_mirror_and_flax():
    cfg = dict(output_channels=2, filters=(4, 8))
    params = _np(_flax_params(CubeSphereUNet(UNetConfig(**cfg), 3, device="cpu",
                                             generator=torch.Generator().manual_seed(0))))
    x = _rand(2, 6, N, N, 3, seed=7)
    mirror = torch_mirror.TorchCubeSphereUNet(UNetConfig(**cfg), device="cpu")
    with pytest.raises(RuntimeError, match="load_flax_params"):
        mirror(x)
    ours = mirror.load_flax_params(params)(x)  # a numpy array in, a tensor out
    assert isinstance(ours, torch.Tensor) and tuple(ours.shape) == (2, 6, N, N, 2)
    ref_mirror = jmirror.TorchCubeSphereUNet(JUNetConfig(**cfg)).load_flax_params(params)(x)
    _close(ours, ref_mirror)
    flax = jax.jit(JUNet(JUNetConfig(**cfg)).apply)(params, jnp.asarray(x))
    _close(ours, flax)
    _close(mirror.load_flax_params(params["params"])(torch.from_numpy(x)), flax)
