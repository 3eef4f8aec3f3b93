"""The port's conv backward against the JAX package: the ghost-strip
transpose Eᵀ, the plain versions of the dx and dw kernels, and the
gradients of the whole autograd function.

Inputs come from numpy seeds and go to both packages; the reference runs
its Pallas kernels in interpret mode.  Tolerances:

* Eᵀ, float32: 1e-6 absolute (sums of at most six halves of order-1
  values, in another order); the adjoint identity in float64 to 1e-12
  relative;
* dx, float32: 1e-5 absolute (outputs of order 1-10, f32 sums of 9*Cout
  products in another order);
* dK and db, float32: 1e-5 of the largest entry (sums over all pixels of a
  face group, order 100, summed in another order);
* bfloat16 gradients: 2**-6 of the largest entry of each gradient.  Both
  sides round dxp (and dK, db) once from f32, but the reference folds Eᵀ
  and adds it to dx in bf16 in another order, and XLA's SAME-conv VJP of
  the ``"split"`` mode rounds at other points: a few bf16 ulps at the
  largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.halo import _ext_transpose as j_ext_transpose
from dlwp_cs_tpu.ops.halo import ext_strips as j_ext_strips
from dlwp_cs_tpu.ops.pallas_conv import _backward_all, _dx_via_kernel, cs_conv3x3_pallas
from dlwp_cs_tpu_torch.ops import hopper_conv
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.halo import _ext_transpose, ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3_dw,
    cs_conv3x3_dw_plain,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_fused,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)


def _case(b, n, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 6, n, n, cin)).astype(np.float32)
    ks = [(rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [rng.normal(size=(cout,)).astype(np.float32) for _ in range(2)]
    g = rng.normal(size=(b, 6, n, n, cout)).astype(np.float32)
    return x, ks, bs, g


@pytest.mark.parametrize("n", [8, 12])
def test_ext_transpose_matches_reference(n):
    rng = np.random.default_rng(n)
    g = rng.normal(size=(2, 6, 4, n + 2, 3)).astype(np.float32)
    ours = _ext_transpose(torch.from_numpy(g)).numpy()
    ref = np.asarray(j_ext_transpose(jnp.asarray(g)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    # the adjoint identity <E x, g> = <x, Eᵀ g>, in float64
    x = torch.from_numpy(rng.normal(size=(2, 6, n, n, 3)))
    g64 = torch.from_numpy(g.astype(np.float64))
    lhs = float((ext_strips(x) * g64).sum())
    rhs = float((x * _ext_transpose(g64)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_ext_strips_backward_is_the_transpose():
    """autograd through ext_strips runs Eᵀ (gathers), not index_add."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 8, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 6, 4, 10, 3)).astype(np.float32))
    x.requires_grad_(True)
    (dx,) = torch.autograd.grad(ext_strips(x), x, g)
    torch.testing.assert_close(dx, _ext_transpose(g), rtol=0, atol=0)
    assert ext_strips(x).grad_fn.name().endswith("_ExtStripsBackward")


@pytest.mark.parametrize("n,cin,cout", [(8, 3, 4), (16, 5, 3), (12, 16, 8)])
def test_dx_and_dw_plain_match_reference_kernels(n, cin, cout):
    x, (ke, kp), _, g = _case(2, n, cin, cout, seed=n + cin)
    # the reference kernels in interpret mode, each compiled once
    ref_dx = np.asarray(jax.jit(_dx_via_kernel, static_argnums=(0, 1, 5))(
        x.shape, jnp.float32, jnp.asarray(ke), jnp.asarray(kp), jnp.asarray(g), True))
    xj = jnp.asarray(x)
    _, *ref_w = jax.jit(_backward_all, static_argnums=(5,))(
        xj, j_ext_strips(xj), jnp.asarray(ke), jnp.asarray(kp), jnp.asarray(g), True)
    dx, d_ext = cs_conv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(ke),
                                    torch.from_numpy(kp))
    assert tuple(dx.shape) == (2, 6, n, n, cin)
    assert tuple(d_ext.shape) == (2, 6, 4, n + 2, cin)
    # W/E strips hold rows 1..n only: both ends zero
    assert float(d_ext[:, :, 2:, [0, n + 1]].abs().max()) == 0.0
    ours_dx = (dx + _ext_transpose(d_ext)).numpy()
    np.testing.assert_allclose(ours_dx, ref_dx, rtol=0, atol=1e-5)
    xt = torch.from_numpy(x)
    ours_w = cs_conv3x3_dw_plain(xt, ext_strips(xt), torch.from_numpy(g))
    for ours, ref in zip(ours_w, ref_w):
        ref = np.asarray(ref).reshape(ours.shape)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _port_grads(x, ks, bs, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ws = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (*ks, *bs)]
    out = cs_conv3x3_fused(xt, ext_strips(xt), *ws)
    grads = torch.autograd.grad(out, [xt, *ws], torch.from_numpy(g).to(dtype))
    return [gr.float().numpy() for gr in grads]


def _jax_grads(x, ks, bs, g, dtype, mode):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a).astype(jdt) for a in (x, *ks, *bs)]
    cot = jnp.asarray(g).astype(jdt)

    def loss(*a):
        out = cs_conv3x3_pallas(*a, True, mode)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(jnp.float32))

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)  # compiled once
    return [np.asarray(gr.astype(jnp.float32)) for gr in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_function_grads_match_reference(mode, dtype):
    """Gradients of x, both kernels and both biases against ``jax.grad`` of
    the reference's fused conv, with its all-kernel ``"fused"`` backward and
    its default ``"split"`` backward."""
    x, ks, bs, g = _case(2, 8, 5, 6, seed=7)
    ours = _port_grads(x, ks, bs, g, dtype)
    ref = _jax_grads(x, ks, bs, g, dtype, True if mode == "fused" else mode)
    for name, o, r in zip(("x", "k_eq", "k_pole", "b_eq", "b_pole"), ours, ref):
        assert o.shape == r.shape, name
        scale = np.abs(r).max()
        tol = 1e-5 * max(scale, 1.0) if dtype == torch.float32 else 2.0**-6 * scale
        np.testing.assert_allclose(o, r, rtol=0, atol=tol, err_msg=name)


def test_backward_skips_dx_for_data_inputs(monkeypatch):
    """The first conv's input is data: its backward launches no dx kernel."""
    calls = {"dx": 0, "dw": 0}

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(hopper_conv, "cs_conv3x3_dx", counted("dx", cs_conv3x3_dx))
    monkeypatch.setattr(hopper_conv, "cs_conv3x3_dw", counted("dw", cs_conv3x3_dw))
    x, ks, bs, g = _case(1, 8, 3, 4, seed=3)
    k_eq, k_po = (torch.from_numpy(k).requires_grad_(True) for k in ks)
    for needs_x in (False, True):
        xt = torch.from_numpy(x).requires_grad_(needs_x)
        out = cs_conv(xt, k_eq, k_po, bias_eq=torch.from_numpy(bs[0]),
                      bias_pole=torch.from_numpy(bs[1]))
        out.backward(torch.from_numpy(g))
        assert calls == {"dx": int(needs_x), "dw": 1 + int(needs_x)}
        assert (xt.grad is not None) == needs_x
    assert k_eq.grad is not None and k_po.grad is not None


def test_backward_wrappers_run_on_cuda_or_cpu_only():
    x, ks, _, g = _case(1, 4, 2, 3, seed=2)
    meta = [torch.from_numpy(a).to("meta") for a in (x, *ks, g)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        cs_conv3x3_dx(meta[3], meta[1], meta[2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        cs_conv3x3_dw(meta[0], meta[0].new_empty((1, 6, 4, 6, 2)), meta[3])
