"""The reference's backward-mode selector in the port
(``ops/hopper_conv.py::use_pallas_backward``), under which every mode runs
the one backward (the dx and dw kernels), against the JAX package's five
modes (``dlwp_cs_tpu.ops.pallas_conv.use_pallas_backward``): gradients of
x, both kernels and both biases of ``cs_conv(...,
backend="pallas_interpret")`` at (B=2, n=8, Cin=4, Cout=8), from the same
numpy inputs and cotangent; the reference runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.

Tolerances, of each gradient's largest entry: float32 2e-5 (f32 sums of
the same products in another order: the composition's autograd, the SAME
conv's VJP and the kernels' plain versions); bfloat16 2**-6 (both round
the same f32 sums to bf16 at other points: a few ulps at the largest
entry).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.conv import cs_conv as j_cs_conv
from dlwp_cs_tpu.ops.pallas_conv import use_pallas_backward as j_use_pallas_backward
from dlwp_cs_tpu_torch.ops import hopper_conv
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    BACKWARD_MODES,
    backward_mode,
    use_pallas_backward,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

SHAPE = (2, 8, 4, 8)  # B, n, Cin, Cout
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
NAMES = ("x", "k_eq", "k_pole", "b_eq", "b_pole")


def _inputs():
    b, n, cin, cout = SHAPE
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, 6, n, n, cin)).astype(np.float32)
    ks = [(rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [rng.normal(size=(cout,)).astype(np.float32) for _ in range(2)]
    g = rng.normal(size=(b, 6, n, n, cout)).astype(np.float32)
    return (x, *ks, *bs), g


@pytest.fixture(scope="module")
def reference():
    """The reference's gradients per (mode, dtype), computed once: jax.grad
    of its ``cs_conv`` traced under ``use_pallas_backward(mode)``."""
    args, g = _inputs()
    out = {}
    for key, (_, jdt) in DTYPES.items():
        jargs = [jnp.asarray(a).astype(jdt) for a in args]
        cot = jnp.asarray(g).astype(jnp.float32)

        def loss(x, ke, kp, be, bp):
            o = j_cs_conv(x, ke, kp, bias_eq=be, bias_pole=bp, backend="pallas_interpret")
            return jnp.sum(o.astype(jnp.float32) * cot)

        for mode in BACKWARD_MODES:
            with j_use_pallas_backward(mode):  # the mode is read while tracing
                grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*jargs)
            out[mode, key] = [np.asarray(gr.astype(jnp.float32)) for gr in grads]
    return out


def _port_grads(mode, dtype):
    args, g = _inputs()
    x, ke, kp, be, bp = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in args]
    with use_pallas_backward(mode):
        out = cs_conv(x, ke, kp, bias_eq=be, bias_pole=bp, backend="pallas_interpret")
    grads = torch.autograd.grad(out, [x, ke, kp, be, bp], torch.from_numpy(g).to(dtype))
    return grads


def test_modes_are_the_reference_modes():
    from dlwp_cs_tpu.ops.pallas_conv import _BWD_MODES

    assert BACKWARD_MODES == _BWD_MODES
    assert backward_mode() == "fused"  # the port's default (the reference's is "split")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", BACKWARD_MODES)
def test_mode_gradients_match_reference(reference, mode, dtype):
    ours = _port_grads(mode, DTYPES[dtype][0])
    for name, o, r in zip(NAMES, ours, reference[mode, dtype]):
        assert o.dtype == DTYPES[dtype][0], name
        assert tuple(o.shape) == r.shape, name
        scale = np.abs(r).max()
        tol = 2e-5 * scale if dtype == "f32" else 2.0**-6 * scale
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0, atol=tol,
                                   err_msg=f"{mode} {dtype} {name}")


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown pallas backward mode 'packed'"):
        with use_pallas_backward("packed"):
            pass
    assert backward_mode() == "fused"


class _Spy:
    """Counts the calls of a wrapper and runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.fixture
def spies(monkeypatch):
    dx, dw = _Spy(hopper_conv.cs_conv3x3_dx), _Spy(hopper_conv.cs_conv3x3_dw)
    monkeypatch.setattr(hopper_conv, "cs_conv3x3_dx", dx)
    monkeypatch.setattr(hopper_conv, "cs_conv3x3_dw", dw)
    return dx, dw


@pytest.mark.parametrize("mode", BACKWARD_MODES)
def test_every_mode_runs_the_kernels(spies, mode):
    """Each mode runs the dx and dw kernels (#4, #5; their plain versions
    on the CPU) once for the conv's backward."""
    _port_grads(mode, torch.float32)
    assert (spies[0].calls, spies[1].calls) == (1, 1)
