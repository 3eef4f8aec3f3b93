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
values on both sides; only the summation order differs).  The ring-fix
kernels (#6, #7) as the conv kernel; the whole float32 xring conv, under
PyTorch's default TF32 flags, within 1e-5 of its plain version (outputs of
order 1); its gradients within 1e-4 (f32: cuDNN may pick Winograd or FFT
algorithms for the SAME convs' VJP) and 2**-6 (bf16) of each gradient's
largest entry.
"""

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.models import (
    ConvLSTMConfig,
    CubeSphereConvLSTMNet,
    CubeSphereUNet,
    UNetConfig,
)
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3,
    cs_conv3x3_dw,
    cs_conv3x3_dw_plain,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
)
from dlwp_cs_tpu_torch.ops.ring_kernel import (
    cs_conv3x3_xring,
    ring_fixes,
    ring_fixes_plain,
    xring_fused_apply,
    xring_fused_apply_plain,
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


# the ConvLSTM's gate convs (batch 1 and the training batch), a U-Net
# shape, small faces with ragged 8-wide tiles, D not a multiple of the
# 16-byte vector (scalar accesses), and a face smaller than one tile
RING_SHAPES = [
    (1, 48, 39, 128), (16, 48, 64, 128), (1, 12, 128, 128), (2, 10, 3, 9),
    (2, 20, 5, 12), (1, 6, 4, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,d", RING_SHAPES)
def test_ring_kernels_match_plain_on_card(cuda_device, dtype, b, n, cin, d):
    tdt = getattr(torch, dtype)
    x, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, tdt)
                           for a in _case(b, n, cin, d))
    gen = torch.Generator().manual_seed(6)
    bases = [torch.randn((b, 6, n, n, d), generator=gen).to(cuda_device, tdt) for _ in range(2)]
    e = ext_strips(x)
    before = (ring_fixes.launches, xring_fused_apply.launches)
    fixes, corners = ring_fixes(e, k_eq, k_po)
    out = xring_fused_apply(*bases, e, k_eq, k_po)
    torch.cuda.synchronize()
    assert (ring_fixes.launches, xring_fused_apply.launches) == (before[0] + 1, before[1] + 1)
    ref_fixes, ref_corners = ring_fixes_plain(e, k_eq, k_po)
    _close(fixes, ref_fixes, dtype)
    _close(corners, ref_corners, dtype)
    _close(out, xring_fused_apply_plain(*bases, e, k_eq, k_po), dtype)


@pytest.mark.cuda
def test_xring_conv_f32_under_default_tf32_flags(cuda_device):
    """The SAME convs run in full f32 whatever the global flags say: with
    cuDNN's TF32 default on, the f32 xring conv stays within 1e-5 of its
    plain version, and the flag is left as it was."""
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device)
                                 for a in _case(1, 48, 39, 128))
    k_eq, k_po = k_eq / 3.0 / 39**0.5, k_po / 3.0 / 39**0.5  # outputs of order 1
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        ours = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po, backend="xring")
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ref = cs_conv3x3_plain(x, ext_strips(x), k_eq, k_po, b_eq, b_po)
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backward", ["split", "ringfix"])
def test_xring_grads_match_plain_path_on_card(cuda_device, dtype, backward):
    """Gradients of the xring conv (kernel forward, torch backward) against
    autograd through the plain fused conv, on the card."""
    tdt = getattr(torch, dtype)
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, tdt)
                                 for a in _case(2, 24, 16, 32))
    g = torch.randn((2, 6, 24, 24, 32), generator=torch.Generator().manual_seed(7))
    g = g.to(cuda_device, tdt)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, k_eq, k_po, b_eq, b_po)]
        return torch.autograd.grad(fn(*ins), ins, g)

    ours = grads(lambda *a: cs_conv3x3_xring(*a, backward=backward))
    ref = grads(lambda x, *w: cs_conv3x3_plain(x, ext_strips(x), *w))
    tol = 1e-4 if dtype == "float32" else 2.0**-6
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), (err, float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convlstm_xring_on_card_reaches_every_parameter(cuda_device, dtype):
    """Two layers x two input times: 4 launches of the fused ring kernel per
    model call, none of the ring-fixes kernel; every parameter gets a
    finite, non-zero gradient."""
    cfg = ConvLSTMConfig(filters=(8, 8), compute_dtype=dtype, conv_backend="xring",
                         output_channels=4, variable_channels=2)
    model = CubeSphereConvLSTMNet(cfg, 2 * 2 + 2 + 1, device=cuda_device,
                                  generator=torch.Generator().manual_seed(0))
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn((2, 6, 16, 16, 7), device=cuda_device)
    before = (ring_fixes.launches, xring_fused_apply.launches)
    loss = torch.mean(torch.square(model(x) - 1.0))
    loss.backward()
    torch.cuda.synchronize()
    assert (ring_fixes.launches, xring_fused_apply.launches) == (before[0], before[1] + 4)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0, name


@pytest.mark.cuda
def test_ring_kernels_reject_bad_arguments(cuda_device):
    x, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device) for a in _case(1, 8, 4, 8))
    e = ext_strips(x)
    with pytest.raises(ValueError, match="expected"):
        ring_fixes(e[:, :, :3], k_eq, k_po)
    base = torch.zeros((1, 6, 8, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="base_po"):
        xring_fused_apply(base, base.bfloat16(), e, k_eq, k_po)
