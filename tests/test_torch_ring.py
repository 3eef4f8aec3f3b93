"""The port's ring-fix and xring conv formulations against the JAX package.

Inputs come from numpy seeds and go to both packages; the reference runs its
ring kernels in Pallas interpret mode (``interpret=True``,
``backend="xring_interpret"``), the port their plain versions on the CPU.
Tolerances, each relative to the largest entry of the reference (floored at
1 for float32):

* float32: 2e-5 (sums of up to 3*Cin products per fix, and of the SAME
  convs' 9*Cin, in another order; measured ~5e-7 on outputs of order 1);
* bfloat16: 2**-6, two bf16 ulps at the largest entry: both sides round the
  same f32 sums once, but a sum may straddle a rounding boundary, and the
  gradients round at XLA's and cuDNN's own points inside the SAME convs'
  VJP;
* gradients, float32: 2e-5 of the largest entry (dk sums over every pixel
  of a face group).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.conv import cs_conv as j_cs_conv
from dlwp_cs_tpu.ops.halo import ext_strips as j_ext_strips
from dlwp_cs_tpu.ops.ring_kernel import cs_conv3x3_xring as j_xring
from dlwp_cs_tpu.ops.ring_kernel import ring_fixes_pallas
from dlwp_cs_tpu.ops.ring_kernel import split_vjp as j_split_vjp
from dlwp_cs_tpu.ops.ring_kernel import xring_fused_apply as j_fused_apply
from dlwp_cs_tpu.ops.ringfix import ring_term as j_ring_term
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.ring_kernel import (
    cs_conv3x3_xring,
    ring_apply,
    ring_fixes,
    ring_fixes_plain,
    split_vjp,
    xring_fused_apply,
    xring_fused_apply_plain,
)
from dlwp_cs_tpu_torch.ops.ringfix import ring_term

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0**-6)}


def _case(b=2, n=8, cin=3, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 6, n, n, cin)).astype(np.float32)
    ks = [(rng.normal(size=(3, 3, cin, d)) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [rng.normal(size=(d,)).astype(np.float32) for _ in range(2)]
    return x, ks, bs


def _both(arrays, dtype):
    """The same rounded values as torch and jax arrays."""
    tdt, jdt, _ = DTYPES[dtype]
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]


def _assert_close(ours, ref, tol, floor=1.0):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(floor, float(np.abs(ref).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_fixes_match_pallas_kernel(dtype):
    x, ks, _ = _case(seed=1)
    (xt, *kt), (xj, *kj) = _both([x, *ks], dtype)
    fixes, corners = ring_fixes(ext_strips(xt), *kt)  # CPU tensor: the plain version
    ref_fixes, ref_corners = ring_fixes_pallas(j_ext_strips(xj), *kj, interpret=True)
    assert fixes.dtype == xt.dtype and corners.dtype == xt.dtype
    tol = DTYPES[dtype][2]
    _assert_close(fixes, ref_fixes, tol)
    _assert_close(corners, ref_corners, tol)


def test_ring_apply_of_fixes_is_the_ring_term():
    x, ks, _ = _case(n=12, cin=4, d=6, seed=2)
    xt, kt = torch.from_numpy(x), [torch.from_numpy(k) for k in ks]
    ref = j_ring_term(jnp.asarray(x), *map(jnp.asarray, ks))
    fixes, corners = ring_fixes_plain(ext_strips(xt), *kt)
    base = torch.zeros(2, 6, 12, 12, 6)
    _assert_close(ring_apply(base, fixes[:, :, :2], fixes[:, :, 2:], corners), ref, 2e-5)
    _assert_close(ring_term(xt, *kt), ref, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_apply_matches_pallas_kernel(dtype):
    x, ks, _ = _case(seed=3)
    rng = np.random.default_rng(4)
    bases = [rng.normal(size=(2, 6, 8, 8, 5)).astype(np.float32) for _ in range(2)]
    (xt, *rest), (xj, *rest_j) = _both([x, *ks, *bases], dtype)
    ours = xring_fused_apply(rest[2], rest[3], ext_strips(xt), rest[0], rest[1])
    ref = j_fused_apply(rest_j[2], rest_j[3], j_ext_strips(xj), rest_j[0], rest_j[1],
                        interpret=True)
    assert ours.dtype == xt.dtype
    _assert_close(ours, ref, DTYPES[dtype][2])
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(
        ours, xring_fused_apply_plain(rest[2], rest[3], ext_strips(xt), rest[0], rest[1]),
        rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["xring", "ringfix", "same"])
@pytest.mark.parametrize("bias", [True, False])
def test_cs_conv_backends_match_reference(backend, bias):
    x, ks, bs = _case(b=1, n=8, cin=4, d=6, seed=5)
    bt = [torch.from_numpy(b) for b in bs] if bias else [None, None]
    bj = [jnp.asarray(b) for b in bs] if bias else [None, None]
    ours = cs_conv(torch.from_numpy(x), *(torch.from_numpy(k) for k in ks),
                   bias_eq=bt[0], bias_pole=bt[1], backend=backend)
    ref = j_cs_conv(jnp.asarray(x), *map(jnp.asarray, ks), bias_eq=bj[0], bias_pole=bj[1],
                    backend="xring_interpret" if backend == "xring" else backend)
    _assert_close(ours, ref, 2e-5)
    # the reference's name for the CPU-testing mode is the same path
    if backend == "xring":
        again = cs_conv(torch.from_numpy(x), *(torch.from_numpy(k) for k in ks),
                        bias_eq=bt[0], bias_pole=bt[1], backend="xring_interpret")
        torch.testing.assert_close(again, ours, rtol=0, atol=0)


@pytest.mark.parametrize("backward", ["split", "ringfix"])
def test_xring_grads_match_jax_grad(backward):
    x, ks, bs = _case(b=1, n=8, cin=2, d=3, seed=6)
    g = np.random.default_rng(7).normal(size=(1, 6, 8, 8, 3)).astype(np.float32)
    args = [x, *ks, *bs]

    def j_loss(*a):
        return jnp.vdot(j_xring(*a, True, backward), jnp.asarray(g))

    ref = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ours = torch.autograd.grad(cs_conv3x3_xring(*ins, backward=backward), ins,
                               torch.from_numpy(g))
    for a, r in zip(ours, ref):
        _assert_close(a, r, 2e-5, floor=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_vjp_matches_reference(dtype):
    """The backward alone, where its bf16 rounding points show: the split
    base's SAME-conv VJP, the ring transpose in bf16, their dk summed in
    bf16, Eᵀ."""
    x, ks, bs = _case(b=2, n=8, cin=4, d=5, seed=8)
    g = np.random.default_rng(9).normal(size=(2, 6, 8, 8, 5)).astype(np.float32)
    ts, js = _both([x, *ks, *bs, g], dtype)
    ours = split_vjp(*ts)
    ref = jax.jit(j_split_vjp)(*js)
    for a, r in zip(ours, ref):
        assert a.dtype == ts[0].dtype
        _assert_close(a, r, DTYPES[dtype][2], floor=0.0)


def test_xring_rejects_unknown_backward_and_runs_on_cuda_or_cpu_only():
    x, ks, bs = _case(b=1, n=4, cin=2, d=2)
    args = [torch.from_numpy(a) for a in (x, *ks, *bs)]
    with pytest.raises(ValueError, match="backward"):
        cs_conv3x3_xring(*args, backward="nope")
    meta = [a.to("meta") for a in args]
    e = torch.empty((1, 6, 4, 6, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ring_fixes(e, meta[1], meta[2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        xring_fused_apply(meta[0], meta[0], e, meta[1], meta[2])
