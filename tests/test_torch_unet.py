"""The port's U-Net, layers, pooling and weight loading against flax.

The flax model is initialised, its parameter tree carried across with
``load_jax_params``, and both run on the same numpy input.  The reference
runs its Pallas kernel in interpret mode (``conv_backend='pallas_interpret'``),
the port its plain conv on the CPU.  Tolerances: float32 1e-5 absolute
(outputs of order 1, sums in another order); bfloat16 2**-6 of the largest
output (two bf16 ulps at the output's scale: a rounding may flip at any of
the ~11 layers and carry on; measured one ulp); pooling and nearest
upsampling are exact; bilinear upsampling 1e-6 relative and absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.ops import pooling as jpool
from dlwp_cs_tpu_torch.models import CubeSphereUNet, UNetConfig, load_jax_params
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D
from dlwp_cs_tpu_torch.ops import pooling

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)


def _x(b=2, n=8, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 6, n, n, c)).astype(np.float32)


def _flax(cfg_kwargs, x):
    # the parameter tree does not depend on the conv backend: initialise
    # through the cheaper XLA path, apply with the configured one
    init_model = JUNet(JUNetConfig(**dict(cfg_kwargs, conv_backend="xla")))
    params = jax.jit(init_model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    model = JUNet(JUNetConfig(**cfg_kwargs))
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    return jax.tree_util.tree_map(np.array, params), ref


def _port(cfg_kwargs, in_channels, params):
    model = CubeSphereUNet(UNetConfig(**cfg_kwargs), in_channels, device="cpu")
    return load_jax_params(model, params)


@pytest.mark.parametrize("cfg_kwargs", [
    dict(output_channels=2, filters=(4, 8), conv_backend="pallas_interpret"),
    dict(output_channels=2, filters=(4, 8, 8), conv_backend="xla",
         separate_polar_weights=False, pooling="max", upsample="bilinear",
         activation="gelu"),
], ids=["flagship-layout", "variants"])
def test_forward_matches_flax(cfg_kwargs):
    x = _x(n=8)
    params, ref = _flax(cfg_kwargs, x)
    model = _port(cfg_kwargs, x.shape[-1], params)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_bf16_forward_matches_flax():
    cfg_kwargs = dict(output_channels=2, filters=(4, 8), compute_dtype="bfloat16",
                      conv_backend="pallas_interpret")
    x = _x(seed=1)
    params, ref = _flax(cfg_kwargs, x)
    model = _port(cfg_kwargs, x.shape[-1], params)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2.0**-6 * np.abs(ref).max())


def test_load_jax_params_rejects_mismatches():
    model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(4, 8)), 3,
                           device="cpu")
    tree = {}
    for name, p in model.named_parameters():  # convs.<scope>.<param>
        _, scope, key = name.split(".")
        tree.setdefault(scope, {})[key] = p.detach().numpy().copy()

    def bad(mutate):
        t = {k: dict(v) for k, v in tree.items()}
        mutate(t)
        return {"params": t}

    load_jax_params(model, bad(lambda t: None))
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, bad(lambda t: t.pop("head")))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(model, bad(lambda t: t.update(extra={})))
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, bad(lambda t: t["enc0_conv0"].pop("bias_pole")))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(model, bad(lambda t: t["enc0_conv1"].update(scale=np.ones(4))))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad(
            lambda t: t["dec0_conv0"].update(kernel_eq=np.zeros((3, 3, 11, 4)))))
    with pytest.raises(KeyError):
        load_jax_params(model, tree)  # no {"params": ...} wrapper
    before = model.convs["head"].kernel_eq.detach().clone()
    with pytest.raises(ValueError):
        load_jax_params(model, bad(
            lambda t: t["enc0_conv0"].update(kernel_eq=np.zeros((1, 1, 3, 4)))))
    torch.testing.assert_close(model.convs["head"].kernel_eq.detach(), before)


def test_seeded_init_scale_and_determinism():
    def layer(seed):
        return CubeSphereConv2D(64, 64, generator=torch.Generator().manual_seed(seed))

    a, b, c = layer(0), layer(0), layer(1)
    torch.testing.assert_close(a.kernel_eq, b.kernel_eq, rtol=0, atol=0)
    assert not torch.equal(a.kernel_eq, c.kernel_eq)
    assert not torch.equal(a.kernel_eq, a.kernel_pole)
    std = 1.0 / np.sqrt(9 * 64)  # flax lecun_normal: variance 1/fan_in
    k = a.kernel_eq.detach()
    assert abs(float(k.std()) / std - 1.0) < 0.05
    assert float(k.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert float(a.bias_eq.detach().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling_matches_reference(dtype):
    x = _x(b=1, n=8, c=4, seed=2)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    for ours, ref in (
        (pooling.cs_avg_pool(xt, 2), jpool.cs_avg_pool(xj, 2)),
        (pooling.cs_max_pool(xt, 2), jpool.cs_max_pool(xj, 2)),
        (pooling.cs_upsample(xt, 2), jpool.cs_upsample(xj, 2)),
    ):
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_bilinear_upsample_matches_reference_at_face_edges():
    x = _x(b=1, n=8, c=2, seed=3)
    for factor in (2, 3):
        ours = pooling.cs_upsample(torch.from_numpy(x), factor, method="bilinear")
        ref = np.asarray(jpool.cs_upsample(jnp.asarray(x), factor, method="bilinear"))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
        # the face edges replicate the edge cells (no cross-face blending)
        np.testing.assert_allclose(ours.numpy()[:, :, 0, 0], x[:, :, 0, 0], atol=1e-6)


def test_pooling_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pooling.cs_avg_pool(torch.zeros(1, 6, 5, 5, 1), 2)
    with pytest.raises(ValueError):
        pooling.cs_upsample(torch.zeros(1, 5, 4, 4, 1), 2)
    with pytest.raises(ValueError):
        pooling.cs_upsample(torch.zeros(1, 6, 4, 4, 1), 2, method="cubic")
