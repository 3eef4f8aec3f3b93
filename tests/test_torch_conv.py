"""The port's conv paths against the JAX package.

Inputs come from numpy seeds and go to both packages.  Tolerances:

* float32: 1e-5 absolute on outputs of order 1 (sums of 9*Cin products in
  another order; measured ~2e-6);
* bfloat16: one bf16 ulp relative (2**-7 of |ref|) plus the float32
  bound: both sides round an f32 sum once; measured equal;
* the pad-then-VALID ('xla') path: 1e-5 in float32.

The kernel itself runs only on a CUDA card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.conv import cs_conv as j_cs_conv
from dlwp_cs_tpu.ops.pallas_conv import cs_conv3x3_pallas, cs_conv3x3_pallas_blocked
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain, tile_plan
from dlwp_cs_tpu_torch.ops.quant import cs_conv3x3_int8_plain, quantize_kernel, quantize_tensor
from dlwp_cs_tpu_torch.ops.ringfix import ring_term

F32_ATOL = 1e-5


def _case(b=2, n=8, cin=5, cout=7, seed=0, kshape=(3, 3)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 6, n, n, cin)).astype(np.float32)
    k_eq, k_po = (
        (rng.normal(size=(*kshape, cin, cout)) * 0.3).astype(np.float32)
        for _ in range(2)
    )
    b_eq, b_po = (rng.normal(size=(cout,)).astype(np.float32) for _ in range(2))
    return x, k_eq, k_po, b_eq, b_po


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _assert_bf16_close(ours, ref):
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    np.testing.assert_array_less(np.abs(ours - ref), np.abs(ref) * 2.0**-7 + F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_auto_match_pallas_kernel(dtype):
    x, *w = _case(n=8, cin=12, cout=8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = cs_conv3x3_pallas(jnp.asarray(x).astype(jdt), *map(jnp.asarray, w), True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    wt = _torch(w, tdt)
    before = cs_conv3x3.launches
    plain = cs_conv3x3_plain(xt, ext_strips(xt), *wt)
    auto = cs_conv(xt, wt[0], wt[1], bias_eq=wt[2], bias_pole=wt[3], backend="auto")
    assert cs_conv3x3.launches == before  # CPU tensors never launch the kernel
    for ours in (plain, auto):
        assert ours.dtype == tdt and tuple(ours.shape) == (2, 6, 8, 8, 8)
        if dtype == "float32":
            np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=F32_ATOL)
        else:
            _assert_bf16_close(ours, ref)


@pytest.mark.parametrize("jax_rows,cin", [(4, 6), (8, 6), (2, 12), (16, 3)])
def test_row_tiles_match_blocked_pallas_kernel(jax_rows, cin):
    """The reference's row-blocked launch computes the same function as the
    whole face; the port's conv equals it.  The kernel's own row tiles
    (ragged ones included, as :func:`tile_plan` picks them) are held against
    this plain version on the card, in ``tests/test_torch_cuda.py``."""
    x, *w = _case(b=1, n=16, cin=cin, cout=5, seed=1)
    ref = np.asarray(cs_conv3x3_pallas_blocked(
        jnp.asarray(x), *map(jnp.asarray, w), jax_rows, 1, True))
    xt = torch.from_numpy(x)
    ours = cs_conv3x3(xt, ext_strips(xt), *_torch(w))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("kshape,stride,dilation", [
    ((3, 3), 1, 1), ((3, 3), 2, 1), ((3, 3), 1, 2), ((3, 1), 1, 1), ((1, 1), 1, 1),
])
def test_xla_path_matches_reference(kshape, stride, dilation):
    x, *w = _case(b=1, n=8, cin=4, cout=3, seed=2, kshape=kshape)
    kw = dict(stride=stride, dilation=dilation, backend="xla")
    ref = np.asarray(j_cs_conv(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(w[1]),
                               bias_eq=jnp.asarray(w[2]), bias_pole=jnp.asarray(w[3]),
                               **kw))
    wt = _torch(w)
    ours = cs_conv(torch.from_numpy(x), wt[0], wt[1], bias_eq=wt[2], bias_pole=wt[3],
                   **kw)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=F32_ATOL)


def test_head_1x1_auto_matches_reference():
    """The 1x1 head takes the generic dual-base path under 'auto'; also
    without biases."""
    x, *w = _case(b=2, n=8, cin=6, cout=4, seed=3, kshape=(1, 1))
    for bias in (True, False):
        b_eq, b_po = (w[2], w[3]) if bias else (None, None)
        ref = j_cs_conv(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(w[1]),
                        bias_eq=None if b_eq is None else jnp.asarray(b_eq),
                        bias_pole=None if b_po is None else jnp.asarray(b_po))
        ours = cs_conv(torch.from_numpy(x), torch.from_numpy(w[0]),
                       torch.from_numpy(w[1]),
                       bias_eq=None if b_eq is None else torch.from_numpy(b_eq),
                       bias_pole=None if b_po is None else torch.from_numpy(b_po))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("backend", ["int8", "xring", "ringfix"])
def test_unported_backends_raise(backend):
    """Every backend is ported.  ``int8`` gives the plain composition: the
    quantized base conv's plain version plus the ring term, bitwise
    (``tests/test_torch_quant.py`` holds it against the reference);
    ``xring`` and ``ringfix`` (``tests/test_torch_ring.py``) give the pad
    path's result."""
    x, *w = _case(b=1, n=4, cin=2, cout=2)
    if backend == "int8":
        xt, (k_eq, k_po) = torch.from_numpy(x), _torch(w[:2])
        qx, sx = quantize_tensor(xt)
        (qke, ske), (qkp, skp) = quantize_kernel(k_eq), quantize_kernel(k_po)
        plain = cs_conv3x3_int8_plain(qx, torch.stack([qke, qkp]),
                                      torch.stack([sx * ske, sx * skp]), torch.float32)
        ours = cs_conv(xt, k_eq, k_po, backend=backend)
        torch.testing.assert_close(ours, plain + ring_term(xt, k_eq, k_po), rtol=0, atol=0)
    else:
        ours = cs_conv(torch.from_numpy(x), *_torch(w[:2]), backend=backend)
        ref = cs_conv(torch.from_numpy(x), *_torch(w[:2]), backend="xla")
        torch.testing.assert_close(ours, ref, rtol=0, atol=F32_ATOL)
    with pytest.raises(ValueError, match="unknown"):
        cs_conv(torch.from_numpy(x), *_torch(w[:2]), backend="nope")


@pytest.mark.parametrize("b,n,cout", [(1, 48, 32), (8, 48, 32), (1, 24, 64),
                                      (1, 12, 128), (1, 96, 64), (2, 200, 300)])
def test_tile_plan_fits_a_block(b, n, cout):
    """Every block holds at most 256 threads of 4x8 register tiles and the
    tiles cover the face."""
    h, cs = tile_plan(b, n, n, cout, sm_count=132)
    assert 1 <= h <= n and cs >= 8 and cs & (cs - 1) == 0
    assert h * -(-n // 4) * (cs // 8) <= 256
    assert cs >= min(-(-cout // 8) * 8, 8)


@pytest.mark.parametrize("b,n,cout,rows", [
    (1, 48, 32, 1), (8, 48, 32, 5), (8, 24, 64, 4), (64, 8, 8, 8),
])
def test_tile_plan_row_tiles(b, n, cout, rows):
    """On a 132-SM card the serving batch gets one row per tile, a coalesced
    batch of 8 at n=48 ragged 5-row tiles (48 = 9*5 + 3), a large batch of
    small faces whole faces: the kernel's row-band, ragged and whole-face
    launches all occur on their own."""
    assert tile_plan(b, n, n, cout, sm_count=132)[0] == rows


def test_tile_plan_rejects_oversized_face():
    with pytest.raises(ValueError, match="too large"):
        tile_plan(1, 4 * 256 + 1, 4 * 256 + 1, 8, sm_count=132)


def test_wrapper_runs_on_cuda_or_cpu_only():
    x, *w = _case(b=1, n=4, cin=2, cout=2)
    xt = torch.from_numpy(x).to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cs_conv3x3(xt, xt.new_empty((1, 6, 4, 6, 2)), *(t.to("meta") for t in _torch(w)))
