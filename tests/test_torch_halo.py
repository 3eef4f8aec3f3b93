"""The port's halo padding and ghost strips against the JAX package.

Both are copies and averages of the same values in the same dtype (the
corner ghost is ``0.5 * (a + b)`` rounded once in that dtype), so they
must be equal in float32 and in bfloat16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.halo import ext_strips as j_ext_strips
from dlwp_cs_tpu.ops.padding import cs_pad as j_cs_pad
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.padding import cs_pad

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(b=2, n=8, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 6, n, n, c)).astype(np.float32)


def _pair(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n,width,dtype", [
    (8, 1, "float32"), (8, 1, "bfloat16"), (8, 2, "bfloat16"), (5, 3, "float32"),
])
def test_cs_pad_matches_reference(n, width, dtype):
    xt, xj = _pair(_x(n=n), dtype)
    ours = cs_pad(xt, width)
    ref = np.asarray(jax.jit(j_cs_pad, static_argnums=1)(xj, width).astype(jnp.float32))
    assert ours.dtype == xt.dtype
    np.testing.assert_array_equal(_np(ours), ref)


@pytest.mark.parametrize("n,dtype", [(8, "float32"), (8, "bfloat16"), (16, "float32")])
def test_ext_strips_matches_reference(n, dtype):
    xt, xj = _pair(_x(n=n, c=5, seed=n), dtype)
    ours = ext_strips(xt)
    ref = np.asarray(jax.jit(j_ext_strips)(xj).astype(jnp.float32))
    assert tuple(ours.shape) == (2, 6, 4, n + 2, 5) and ours.dtype == xt.dtype
    np.testing.assert_array_equal(_np(ours), ref)


def test_ext_strips_are_the_padded_ring():
    """ext rows S/N and columns W/E are the ring of cs_pad(x, 1)."""
    xt = torch.from_numpy(_x(n=8))
    p, e = cs_pad(xt, 1), ext_strips(xt)
    torch.testing.assert_close(e[:, :, 0], p[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(e[:, :, 1], p[:, :, -1], rtol=0, atol=0)
    torch.testing.assert_close(e[:, :, 2], p[:, :, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(e[:, :, 3], p[:, :, :, -1], rtol=0, atol=0)


def test_bad_shapes_rejected():
    with pytest.raises(ValueError):
        cs_pad(torch.zeros(1, 5, 4, 4, 1), 1)
    with pytest.raises(ValueError):
        ext_strips(torch.zeros(1, 6, 4, 5, 1))
    with pytest.raises(ValueError):
        cs_pad(torch.zeros(1, 6, 4, 4, 1), 5)
