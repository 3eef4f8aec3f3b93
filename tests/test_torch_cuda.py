"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 1e-4 absolute (outputs of order 1-10, f32 sums of up to
9*192 products in another order; TF32 off); bfloat16 one bf16 ulp
relative (2**-7 of |ref|) plus that f32 bound, since both round an f32 sum
once and the two sums may straddle a rounding boundary.  The dw kernel's
f32 sums run over every pixel of a face group (up to 16*4*48*48 terms):
1e-5 of the largest entry, in both dtypes (its inputs are the same rounded
values on both sides; only the summation order differs).
"""

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.models import CubeSphereUNet, UNetConfig
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3,
    cs_conv3x3_dw,
    cs_conv3x3_dw_plain,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(b, n, cin, cout, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 6, n, n, cin)).astype(np.float32)
    k = [(rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32) for _ in range(2)]
    bias = [rng.normal(size=(cout,)).astype(np.float32) for _ in range(2)]
    return x, *k, *bias


# tile_plan on a 132-SM H100 gives: one row per tile (most serving shapes,
# n=96 included), ragged 5-row tiles (8, 48, ...) and whole faces (64, 8, ...)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", [
    (2, 48, 12, 32), (1, 24, 192, 64), (2, 12, 128, 128), (1, 16, 5, 7), (1, 10, 3, 9),
    (1, 96, 64, 64), (8, 48, 12, 32), (64, 8, 4, 8),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, b, n, cin, cout):
    tdt = getattr(torch, dtype)
    x, *w = (torch.from_numpy(a).to(cuda_device, tdt) for a in _case(b, n, cin, cout))
    e = ext_strips(x)
    before = cs_conv3x3.launches
    ours = cs_conv3x3(x, e, *w)
    torch.cuda.synchronize()
    assert cs_conv3x3.launches == before + 1
    ref = cs_conv3x3_plain(x, e, *w)
    if dtype == "float32":
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-4)
    else:
        diff = (ours.float() - ref.float()).abs()
        assert bool((diff <= ref.float().abs() * 2.0**-7 + 1e-4).all()), diff.max()


def _close(ours, ref, dtype):
    if dtype == "float32":
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-4)
    else:
        diff = (ours.float() - ref.float()).abs()
        assert bool((diff <= ref.float().abs() * 2.0**-7 + 1e-4).all()), diff.max()


# the forward test's shapes, and the flagship U-Net's at its training batch
BWD_SHAPES = [
    (2, 48, 12, 32), (1, 24, 192, 64), (2, 12, 128, 128), (1, 16, 5, 7), (1, 10, 3, 9),
    (1, 96, 64, 64), (8, 48, 12, 32), (64, 8, 4, 8),
    (16, 48, 32, 32), (16, 24, 64, 64), (16, 12, 128, 128), (16, 24, 192, 64),
    (16, 48, 96, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", BWD_SHAPES)
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, b, n, cin, cout):
    tdt = getattr(torch, dtype)
    x, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, tdt)
                           for a in _case(b, n, cin, cout))
    g = torch.randn((b, 6, n, n, cout), generator=torch.Generator().manual_seed(5))
    g = g.to(cuda_device, tdt)
    e = ext_strips(x)
    before = (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
    dx, d_ext = cs_conv3x3_dx(g, k_eq, k_po)
    dw = cs_conv3x3_dw(x, e, g)
    torch.cuda.synchronize()
    assert (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches) == (before[0] + 1, before[1] + 1)
    ref_dx, ref_ext = cs_conv3x3_dx_plain(g, k_eq, k_po)
    _close(dx, ref_dx, dtype)
    _close(d_ext, ref_ext, dtype)
    for ours, ref in zip(dw, cs_conv3x3_dw_plain(x, e, g)):
        assert ours.dtype == torch.float32
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_dw_kernel_is_deterministic(cuda_device):
    """No float atomics: two identical calls give bitwise-equal gradients."""
    x, *_ = (torch.from_numpy(a).to(cuda_device) for a in _case(16, 24, 64, 64))
    g = torch.randn((16, 6, 24, 24, 64), device=cuda_device)
    e = ext_strips(x)
    first = cs_conv3x3_dw(x, e, g)
    second = cs_conv3x3_dw(x, e, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_through_the_model_reaches_every_parameter(cuda_device, dtype):
    """Regression: the forward kernel's output once had no grad_fn on the
    card, so loss.backward() left every 3x3 kernel and bias without a
    gradient.  Every parameter gets a finite, non-zero one, through the
    three kernels (the first conv's input is data: no dx launch)."""
    model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(8, 16),
                                      compute_dtype=dtype), 3, device=cuda_device,
                           generator=torch.Generator().manual_seed(0))
    for p in model.parameters():  # non-zero biases, so every path carries signal
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn((2, 6, 16, 16, 3), device=cuda_device)
    launches = [k.launches for k in (cs_conv3x3, cs_conv3x3_dw, cs_conv3x3_dx)]
    loss = torch.mean(torch.square(model(x) - 1.0))
    loss.backward()
    torch.cuda.synchronize()
    got = [k.launches - n for k, n in zip((cs_conv3x3, cs_conv3x3_dw, cs_conv3x3_dx), launches)]
    assert got == [6, 6, 5]
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0, name


@pytest.mark.cuda
def test_kernel_rejects_mismatched_dtype(cuda_device):
    x, *w = (torch.from_numpy(a).to(cuda_device) for a in _case(1, 8, 4, 8))
    with pytest.raises(ValueError, match="k_eq"):
        cs_conv3x3(x.bfloat16(), ext_strips(x.bfloat16()), *w)
