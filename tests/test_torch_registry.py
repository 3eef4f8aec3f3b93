"""The port's layer registry and ``SequentialSpec`` against the JAX
package's (``models/registry.py``).

The port's modules are built with seeded parameters, which go to the
reference as its flax tree (scopes ``f"{name.lower()}_{idx}"``).
Tolerance 1e-5 of the largest |output| (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.models import registry as jregistry
from dlwp_cs_tpu.models import SequentialSpec as JSequentialSpec
from dlwp_cs_tpu_torch.models import (
    CubeSphereConv2D,
    CubeSphereConvLSTM,
    SequentialSpec,
    freeze_spec,
    get_layer,
    load_jax_params,
    register_layer,
)
from dlwp_cs_tpu_torch.models import registry
from tests.test_torch_quant import _flax_params, _np

N = 8
# the reference module's docstring spec
DOC_SPEC = [
    ("CubeSphereConv2D", (), {"features": 32}),
    ("LeakyReLU", (), {"negative_slope": 0.1}),
    ("AvgPool", (2,), {}),
    ("CubeSphereConv2D", (), {"features": 4, "kernel_size": (1, 1)}),
]
# a recurrent layer on (B, T, 6, n, n, C), a Dense head on its last state
LSTM_SPEC = [
    ("CubeSphereConvLSTM", (4,), {"return_sequences": True}),
    ("CubeSphereConvLSTM", (), {"features": 4}),
    ("UpSampling", (2,), {}),
    ("MaxPool", (2,), {}),
    ("Dense", (3,), {}),
    ("Tanh", (), {}),
]


@pytest.mark.parametrize("spec,shape", [(DOC_SPEC, (2, 6, N, N, 3)),
                                        (LSTM_SPEC, (2, 3, 6, N, N, 3))])
def test_sequential_spec_matches_reference(spec, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    model = SequentialSpec(spec, shape[-1], device="cpu",
                           generator=torch.Generator().manual_seed(0))
    params = _flax_params(model)
    ref = np.asarray(jax.jit(JSequentialSpec(spec=jregistry.freeze_spec(spec)).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))
    # the tree loads back by name, all or nothing
    again = load_jax_params(SequentialSpec(spec, shape[-1], device="cpu"), _np(params))
    with torch.no_grad():
        np.testing.assert_array_equal(again(torch.from_numpy(x)).numpy(), ours)
    assert model.out_channels == ref.shape[-1]


def test_freeze_spec_matches_reference_on_nested_values():
    spec = [("CubeSphereConv2D", [8], {"kernel_size": [3, 3], "meta": {"b": [1, {"c": 2}],
                                                                       "a": 0}}),
            ("LeakyReLU", (), {"negative_slope": 0.2})]
    frozen = freeze_spec(spec)
    assert frozen == jregistry.freeze_spec(spec)
    hash(frozen)
    assert freeze_spec(frozen) == frozen


def test_registry_names_and_reregistration():
    assert get_layer("CubeSphereConv2D") is CubeSphereConv2D
    assert get_layer("CubeSphereConvLSTM") is CubeSphereConvLSTM
    assert set(registry.LAYERS) == set(jregistry.LAYERS)
    with pytest.raises(KeyError, match="known"):
        get_layer("FluxCapacitor")
    with pytest.raises(KeyError, match="FluxCapacitor"):
        SequentialSpec([("FluxCapacitor", (), {})], 3, device="cpu")
    saved = dict(registry._MODULES), dict(registry._FUNCTIONS), dict(registry.LAYERS)
    try:
        # a function over a module's name replaces it in every table
        register_layer("Dense", lambda x, k=2.0: x * k)
        assert "Dense" not in registry._MODULES and get_layer("Dense")(1.0) == 2.0
        model = SequentialSpec([("Dense", (), {"k": 3.0})], 2, device="cpu")
        assert not list(model.parameters())
        torch.testing.assert_close(model(torch.ones(1, 2)), torch.full((1, 2), 3.0))
        register_layer("Twice", CubeSphereConv2D, is_module=True)
        assert "Twice" in registry._MODULES and "Twice" not in registry._FUNCTIONS
    finally:
        for table, old in zip((registry._MODULES, registry._FUNCTIONS, registry.LAYERS), saved):
            table.clear()
            table.update(old)
