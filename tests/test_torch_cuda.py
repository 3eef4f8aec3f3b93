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
largest entry.  The band and tile launches of the forward kernel (#8,
#9) as the forward kernel; a band conv of 2 ranks sharing the card (a gloo
group) against the one-card conv likewise.  The forward and dx kernels run
on the tensor cores in both dtypes (``tc_plan``; float32 as 3xTF32, at the
same 1e-4), and the dw kernel as an implicit GEMM over the pixels
(``dw_tc_plan``; float32 as 3xTF32; at the same 1e-5); each forward
output's sum runs in one K order whatever the tile, so a band's or a
tile's rows equal the whole face's bitwise given the same ghost values.
The CUDA-core instances they replaced (kept as the kernel tools' timing
rows) agree with the plain versions as before.
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
    cs_conv3x3_band,
    cs_conv3x3_dw,
    cs_conv3x3_dw_plain,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
    cs_conv3x3_tile,
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


# float32: tile_plan on a 132-SM H100 gives one row per tile (most serving
# shapes, n=96 included), ragged 5-row tiles (8, 48, ...) and whole faces
# (64, 8, ...); bfloat16: tc_plan's tiles of whole rows, ragged at the
# face's end where h does not divide n
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


# the forward with its weights streamed with each chunk: the capacity
# sweep's three bfloat16 shapes whose resident plan does not fit (and, in
# float32, (24, 768 -> 256) likewise), at the sweep's batch and at batch 1,
# and the flagship U-Net's 8 conv shapes forced there at batch 1 and 16
STREAMED = [(8, 12, 512, 512), (8, 24, 768, 256), (8, 24, 512, 256), (1, 12, 512, 512)]
FLAGSHIP_CONVS = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
                  (12, 128, 128), (24, 192, 64), (48, 96, 32)]


def _forced_forward(x, e, w, stream):
    """#1 under the plan of the weight mode ``stream`` (streamed or
    resident), whatever the paths would choose, launched through the entry
    point as ``tools/tc_sweep.py`` launches a plan of its choosing; raises
    ``ValueError`` where that mode has no plan."""
    from dlwp_cs_tpu_torch.ops.cuda_build import DTYPES
    from dlwp_cs_tpu_torch.ops.hopper_conv import fwd_plan

    b, _, n, _, cin = x.shape
    cout = w[0].shape[-1]
    dev = cs_conv3x3._device(x)
    plan = fwd_plan(x.dtype, b, n, n, cin, cout, cs_conv3x3._sm_count[dev], stream=stream)
    out = torch.empty((b, 6, n, n, cout), dtype=x.dtype, device=x.device)
    cs_conv3x3._launch("cs_conv3x3_launch", dev, DTYPES[x.dtype], dev,
                       *(t.data_ptr() for t in (x, e, *w, out)), b, n, n, cin, cout,
                       *plan.args(), int(stream), sizes=11)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", STREAMED + [(b,) + s for b in (1, 16)
                                                       for s in FLAGSHIP_CONVS])
def test_streamed_forward_matches_plain_and_resident_on_card(cuda_device, dtype, b, n, cin,
                                                             cout):
    """The streamed mode (``fwd_plan(stream=True)``) against the plain
    version, and bitwise equal to the resident mode wherever that plans
    (the same K order, the same products); the wrapper's plan streams
    exactly where the resident one refuses, and only then adds to
    ``stream_launches``."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import fwd_plan

    tdt = getattr(torch, dtype)
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, tdt)
                                 for a in _case(b, n, cin, cout))
    w = (k_eq / cin**0.5, k_po / cin**0.5, b_eq, b_po)
    e = ext_strips(x)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ours = _forced_forward(x, e, w, True)
    torch.cuda.synchronize()
    _close(ours, cs_conv3x3_plain(x, e, *w), dtype)
    assert torch.equal(_forced_forward(x, e, w, True), ours)  # repeatable
    before = cs_conv3x3.stream_launches[(n, n, cin, cout)]
    paths = cs_conv3x3(x, e, *w)
    streamed = cs_conv3x3.stream_launches[(n, n, cin, cout)] - before
    try:
        fwd_plan(tdt, b, n, n, cin, cout, sms, stream=False)
    except ValueError:
        assert fwd_plan(tdt, b, n, n, cin, cout, sms).geom.stream and streamed == 1
        assert torch.equal(paths, ours)
        return
    assert not fwd_plan(tdt, b, n, n, cin, cout, sms).geom.stream and streamed == 0
    assert torch.equal(paths, ours)
    assert torch.equal(_forced_forward(x, e, w, False), ours)


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
    # the corners' handoff between ring blocks: the same output again, and
    # the arrival counts left at zero for the next launch
    assert torch.equal(xring_fused_apply(*bases, e, k_eq, k_po), out)
    torch.cuda.synchronize()
    assert not any(t.any() for t in xring_fused_apply._count_buffers[x.device])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,d", RING_SHAPES)
def test_cuda_core_ring_rows_match_plain_on_card(cuda_device, dtype, b, n, cin, d):
    """The CUDA-core ring kernels that the ring blocks replaced, kept as
    timing rows (ops/conv_variants.py), against the same plain versions."""
    from dlwp_cs_tpu_torch.ops.conv_variants import (
        ring_fixes_cudacore,
        xring_fused_apply_cudacore,
    )

    tdt = getattr(torch, dtype)
    x, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, tdt)
                           for a in _case(b, n, cin, d, seed=5))
    gen = torch.Generator().manual_seed(7)
    bases = [torch.randn((b, 6, n, n, d), generator=gen).to(cuda_device, tdt) for _ in range(2)]
    e = ext_strips(x)
    before = (ring_fixes.launches, xring_fused_apply.launches, ring_fixes_cudacore.launches)
    fixes, corners = ring_fixes_cudacore(e, k_eq, k_po)
    out = xring_fused_apply_cudacore(*bases, e, k_eq, k_po)
    torch.cuda.synchronize()
    assert (ring_fixes.launches, xring_fused_apply.launches) == before[:2]
    assert ring_fixes_cudacore.launches == before[2] + 1
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


# local blocks (B, rows, cols, Cin, Cout): the flagship's 4-band shapes
# (h = 12, 3) and 2x2 tiles (h = W = 24, 6), a ragged band, a one-row tile
BLOCK_SHAPES = [
    (1, 12, 48, 12, 32), (8, 3, 12, 128, 128), (1, 24, 24, 96, 32), (8, 6, 6, 128, 128),
    (2, 5, 13, 5, 7), (1, 1, 3, 3, 9),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,rows,cols,cin,cout", BLOCK_SHAPES)
def test_block_kernels_match_plain_on_card(cuda_device, dtype, b, rows, cols, cin, cout):
    """Kernels #8 (band) and #9 (tile): the forward kernel on a shard's
    block with exchanged ghost strips (W/E at positions 1..rows)."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((b, 6, rows, cols, cin), generator=gen).to(cuda_device, tdt)
    ext = torch.randn((b, 6, 4, cols + 2, cin), generator=gen)
    ext[:, :, 2:, 0] = 0
    ext[:, :, 2:, rows + 1 :] = 0
    ext = ext.to(cuda_device, tdt)
    w = [torch.from_numpy(a).to(cuda_device) for a in _case(1, 1, cin, cout)[1:]]
    w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
    w = [t.to(tdt) for t in w]
    for wrapper in (cs_conv3x3_band, cs_conv3x3_tile):
        before = wrapper.launches
        ours = wrapper(x, ext, *w)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _close(ours, cs_conv3x3_plain(x, ext, *w), dtype)


@pytest.mark.cuda
def test_block_kernel_rejects_tall_blocks(cuda_device):
    x = torch.zeros((1, 6, 8, 4, 3), device=cuda_device)
    ext = torch.zeros((1, 6, 4, 6, 3), device=cuda_device)
    w = [torch.from_numpy(a).to(cuda_device) for a in _case(1, 1, 3, 5)[1:]]
    with pytest.raises(ValueError, match="H <= W"):
        cs_conv3x3_band(x, ext, *w)


def _band_conv_on_two_ranks(x, w):
    """One rank of a 2-rank group sharing the card: the band conv of kernel
    #8 on its half of the faces, gathered."""
    from dlwp_cs_tpu_torch.parallel import create_mesh
    from dlwp_cs_tpu_torch.parallel.hopper_band import make_sharded_pallas_conv3x3
    from dlwp_cs_tpu_torch.parallel.mesh import gather_blocks, local_block

    mesh = create_mesh(data=1, spatial=2)
    conv = make_sharded_pallas_conv3x3(mesh)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        band = local_block(x.cuda().to(dtype), mesh)
        y = conv(band, *(t.cuda().to(dtype) for t in w))
        out[dtype] = gather_blocks(y, mesh).cpu()
    out["launches"] = cs_conv3x3_band.launches
    return out


@pytest.mark.cuda
def test_band_conv_of_two_ranks_sharing_the_card(cuda_device, tmp_path):
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    x, *w = (torch.from_numpy(a) for a in _case(1, 48, 32, 32))
    w[0], w[1] = w[0] / 32**0.5, w[1] / 32**0.5
    results = spawn_group(_band_conv_on_two_ranks, 2, x, w, workdir=tmp_path)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        xd, *wd = (t.to(cuda_device, tdt) for t in (x, *w))
        ref = cs_conv3x3(xd, ext_strips(xd), *wd).cpu()
        for r in results:
            assert r["launches"] == 2
            _close(r[tdt], ref, dtype)


# ---- the band-row exchange kernels (#10, #11) on ranks sharing the card ----

# (n, Cin, Cout) of the flagship U-Net's 10 3x3 convs; on 4 row bands h = n/4
FLAGSHIP_CONVS = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
                  (12, 128, 128), (24, 192, 64), (24, 64, 64), (48, 96, 32), (48, 32, 32)]
XCHG_CALLS = 200


def _exchanges_and_overlap_convs(calls):
    """One rank: ``calls`` back-to-back launches of kernel #10 at the
    flagship's band shapes (batch 1 and 8, widths 1 and 2, both dtypes; a
    random host sleep of 0-2 ms before each), then each output against the
    ``ppermute`` pair on the same input; on 4 ranks also kernel #11 at every
    flagship conv shape against its plain version and against kernel #8;
    the ring buffers before and after ``release_all``."""
    import time

    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh, symmetric
    from dlwp_cs_tpu_torch.parallel.hopper_band import band_conv3x3
    from dlwp_cs_tpu_torch.parallel.mesh import local_block
    from dlwp_cs_tpu_torch.parallel.overlap_band import (
        _seam_ext,
        band_conv3x3_overlap,
        band_conv3x3_overlap_plain,
    )
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = create_mesh(data=1, spatial=world)
    rng = np.random.default_rng(rank)
    cases = [(b, n, c, w, dt) for b in (1, 8) for n, c, _ in FLAGSHIP_CONVS[::2]
             for w in (1, 2) if w <= n // world for dt in (torch.float32, torch.bfloat16)]
    inputs, outputs = [], []
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    for i in range(calls):
        b, n, c, w, dt = cases[i % len(cases)]
        x = torch.randn((b, 6, n // world, n, c), generator=gen, device="cuda").to(dt)
        time.sleep(rng.uniform(0.0, 0.002))
        inputs.append((x, w))
        outputs.append(band_exchange_rdma(x, w, mesh=mesh))
    torch.cuda.synchronize()
    out = {"launches": band_exchange_rdma.launches, "mismatches": 0}
    for (x, w), got in zip(inputs, outputs):
        want = band_exchange_plain(x, w, mesh=mesh)
        out["mismatches"] += not all(torch.equal(a, r) for a, r in zip(got, want))
    out["overlap"] = []
    if world == 4:
        for b in (1, 8):
            for n, cin, cout in FLAGSHIP_CONVS:
                for dt in (torch.float32, torch.bfloat16):
                    g = torch.Generator().manual_seed(n * 1000 + cin)
                    xg = torch.randn((b, 6, n, n, cin), generator=g)
                    w = [torch.randn((3, 3, cin, cout), generator=g) / (9 * cin) ** 0.5
                         for _ in range(2)] + [torch.randn((cout,), generator=g) * 0.1
                                               for _ in range(2)]
                    band = local_block(xg.cuda().to(dt), mesh)
                    w = [t.cuda().to(dt) for t in w]
                    before = band_conv3x3_overlap.launches
                    ours = band_conv3x3_overlap(band, *w, mesh=mesh)
                    torch.cuda.synchronize()
                    launched = band_conv3x3_overlap.launches - before
                    seam, wecols = _seam_ext(band, mesh=mesh)
                    below, above = band_exchange_plain(band, 1, mesh=mesh)
                    s = rank
                    plain = band_conv3x3_overlap_plain(band, seam, wecols, below, above, *w,
                                                       first=s == 0, last=s == world - 1)
                    k8 = band_conv3x3(band, *w, mesh=mesh)
                    out["overlap"].append(((b, n, cin, cout, str(dt)), launched, ours.cpu(),
                                           plain.cpu(), k8.cpu()))
    out["live_before"] = symmetric.live_buffers()
    symmetric.release_all()
    out["live_after"] = symmetric.live_buffers()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_band_exchange_kernels_on_ranks_sharing_the_card(cuda_device, tmp_path, world):
    """Kernel #10 bitwise equal to the ``ppermute`` pair over 200
    back-to-back exchanges with random host delays (2 and 4 ranks); kernel
    #11 against its plain version (f32 1e-4, bf16 one ulp + 1e-4) and equal
    to kernel #8 at every flagship 4-band shape; every ring buffer freed at
    the end."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_exchanges_and_overlap_convs, world, XCHG_CALLS, workdir=tmp_path)
    for r in results:
        assert r["launches"] == XCHG_CALLS and r["mismatches"] == 0, r["mismatches"]
        # the ring buffer of #10/#11 (one or two neighbours mapped) and the
        # group buffer of the collectives (every peer mapped)
        assert r["live_before"] == (2, (1 if world == 2 else 2) + world - 1), r["live_before"]
        assert r["live_after"] == (0, 0), r["live_after"]
        assert len(r["overlap"]) == (40 if world == 4 else 0)
        for case, launched, ours, plain, k8 in r["overlap"]:
            assert launched == 1, case
            _close(ours, plain, "float32" if "float32" in case[-1] else "bfloat16")
            assert torch.equal(ours, k8), (case, (ours.float() - k8.float()).abs().max())


def _one_rank_stays_away():
    """Every rank exchanges once; then all but the last exchange again, with
    a 2 s bound on each wait: the others' error messages, from the end of
    the call's block of work and from the next launch."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh, symmetric
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_rdma

    symmetric.SPIN_TIMEOUT_S = 2.0
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = create_mesh(data=1, spatial=world)
    x = torch.ones((1, 6, 12 // world, 12, 8), device="cuda")
    band_exchange_rdma(x, 1, mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    if rank == world - 1:
        return None
    msgs = []
    for _ in range(2):
        try:
            band_exchange_rdma(x, 1, mesh=mesh)
            symmetric.check_timeouts()
            msgs.append("no error")
        except RuntimeError as e:
            msgs.append(str(e))
    return msgs


@pytest.mark.cuda
def test_band_exchange_times_out_when_a_rank_stays_away(cuda_device, tmp_path):
    """Three of 4 ranks call kernel #10 without the fourth: each raises an
    error naming itself, the call and the counter it waited on, and raises
    it again at its next launch; the group then ends (its buffers freed)."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_one_rank_stays_away, 4, workdir=tmp_path)
    assert results[-1] is None
    for rank, msgs in enumerate(results[:-1]):
        for msg in msgs:
            assert "timed out in kernel #10" in msg and f"coordinate {rank}" in msg, msg
            assert "epoch 2" in msg, msg


def _lagging_rank(epochs, lagger, lag_ns):
    """One rank: ``epochs`` calls enqueued back to back, #10 (width 1 and 2)
    and #11 in turns at flagship band shapes, both dtypes, the rank
    ``lagger`` holding its stream ``lag_ns`` before it reads each call's
    received rows (so its neighbours send the next epochs into its other
    parity's slots meanwhile); then every output against the ``ppermute``
    pair (#10) and against #8 and the plain version (#11)."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh, symmetric
    from dlwp_cs_tpu_torch.parallel.hopper_band import band_conv3x3
    from dlwp_cs_tpu_torch.parallel.overlap_band import (
        _seam_ext,
        band_conv3x3_overlap,
        band_conv3x3_overlap_plain,
    )
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = create_mesh(data=1, spatial=world)
    gen = torch.Generator(device="cuda").manual_seed(200 + rank)
    symmetric.READ_LAG_NS = lag_ns if rank == lagger else 0
    calls = []
    for i in range(epochs):
        n, cin, cout = FLAGSHIP_CONVS[i % len(FLAGSHIP_CONVS)]
        dt = (torch.float32, torch.bfloat16)[(i // 2) % 2]
        b = 1 + 7 * ((i // 4) % 2)
        x = torch.randn((b, 6, n // world, n, cin), generator=gen, device="cuda").to(dt)
        if i % 2 == 0:
            w = 1 + (i // 2) % 2
            calls.append(("xchg", x, w, band_exchange_rdma(x, w, mesh=mesh)))
        else:
            k = [(torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                  / (9 * cin) ** 0.5).to(dt) for _ in range(2)]
            bias = [(torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(dt)
                    for _ in range(2)]
            calls.append(("overlap", x, k + bias, band_conv3x3_overlap(x, *k, *bias, mesh=mesh)))
    symmetric.check_timeouts()
    symmetric.READ_LAG_NS = 0
    out = {"xchg_mismatches": 0, "overlap": []}
    for kind, x, arg, got in calls:
        if kind == "xchg":
            want = band_exchange_plain(x, arg, mesh=mesh)
            out["xchg_mismatches"] += not all(torch.equal(a, r) for a, r in zip(got, want))
            continue
        seam, wecols = _seam_ext(x, mesh=mesh)
        below, above = band_exchange_plain(x, 1, mesh=mesh)
        plain = band_conv3x3_overlap_plain(x, seam, wecols, below, above, *arg,
                                           first=rank == 0, last=rank == world - 1)
        k8 = band_conv3x3(x, *arg, mesh=mesh)
        out["overlap"].append((str(x.dtype), got.cpu(), plain.cpu(), k8.cpu()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_band_exchange_slot_reuse_when_a_rank_lags(cuda_device, tmp_path, world):
    """One rank holds its stream 3 ms before it reads each call's received
    rows, for 24 calls of #10 and #11 in turns, while its neighbours run
    ahead into its other parity's slots: every #10 output is bitwise equal to
    the ``ppermute`` pair, every #11 output to #8 and within the plain
    version's tolerance."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_lagging_rank, world, 24, world - 1, 3_000_000, workdir=tmp_path)
    for r in results:
        assert r["xchg_mismatches"] == 0, r["xchg_mismatches"]
        assert len(r["overlap"]) == 12
        for dt, ours, plain, k8 in r["overlap"]:
            _close(ours, plain, "float32" if "float32" in dt else "bfloat16")
            assert torch.equal(ours, k8), (dt, (ours.float() - k8.float()).abs().max())


# ---- the kernel tools' kernels: #3, #13 (tensor cores), #12, #14, #15, #16 ----

# small faces (Cin not a multiple of 8: the scalar staging path; Cout not a
# multiple of 8), the flagship U-Net's 10 conv shapes at batch 1, its first
# level at the training batch, n = 96, and the packed layout's 128 channels
MMA_SHAPES = [
    (1, 10, 5, 7), (2, 8, 12, 16), (1, 8, 8, 8),
    (1, 48, 12, 32), (1, 48, 32, 32), (1, 24, 32, 64), (1, 24, 64, 64), (1, 12, 64, 128),
    (1, 12, 128, 128), (1, 24, 192, 64), (1, 48, 96, 32), (16, 48, 32, 32), (1, 96, 64, 64),
]


def _mma_kernels():
    from dlwp_cs_tpu_torch.ops import conv_variants as cv

    return {"npack": (cv.cs_conv3x3_npack, cv.cs_conv3x3_npack_plain, cv.npack_taps),
            "npack_v1": (cv.cs_conv3x3_npack_v1, cv.cs_conv3x3_npack_plain, cv.npack_taps),
            "im2col": (cv.cs_conv3x3_im2col, cv.cs_conv3x3_im2col_plain, cv.im2col_taps),
            "im2col_v1": (cv.cs_conv3x3_im2col_v1, cv.cs_conv3x3_im2col_plain,
                          cv.im2col_taps)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["npack", "npack_v1", "im2col", "im2col_v1"])
@pytest.mark.parametrize("b,n,cin,cout", MMA_SHAPES)
def test_mma_conv_kernels_match_plain_and_conv_kernel_on_card(cuda_device, kind, b, n, cin,
                                                              cout):
    """Kernels #3 (kn2row) and #13 (im2col; and the kernels of their first
    designs, timing rows) in bfloat16 against their plain versions and
    against kernel #1 on the same strips, each within one bf16 ulp of |ref|
    + 1e-4 (all three round an f32 sum once); bitwise equal from launch to
    launch."""
    wrapper, plain, taps = _mma_kernels()[kind]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(b, n, cin, cout))
    k_eq, k_po = k_eq / cin**0.5, k_po / cin**0.5
    e = ext_strips(x)
    w = (taps(k_eq), taps(k_po))
    before = wrapper.launches
    ours = wrapper(x, e, *w, b_eq, b_po)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert ours.shape == (b, 6, n, n, cout) and ours.dtype == torch.bfloat16
    _close(ours, plain(x, e, *w, b_eq, b_po), "bfloat16")
    _close(ours, cs_conv3x3(x, e, k_eq, k_po, b_eq, b_po), "bfloat16")
    assert torch.equal(wrapper(x, e, *w, b_eq, b_po), ours)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 32, 256), (1, 48, 64, 256), (16, 24, 64, 64),
                                          (2, 12, 39, 40), (1, 20, 8, 12)])
def test_im2col_kernel_past_the_first_designs_plan_on_card(cuda_device, b, n, cin, cout):
    """Kernel #13 where the first design's 64 accumulator tiles a block did
    not reach (n = 48 with Cout = 256), at batch 16, with an odd Cin (plain
    2-byte gathers) and a Cout whose rows take 8-byte copies: within one
    bf16 ulp of |ref| + 1e-4 of its plain version and of #1, bitwise equal
    from launch to launch."""
    wrapper, plain, taps = _mma_kernels()["im2col"]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(b, n, cin, cout))
    k_eq, k_po = k_eq / cin**0.5, k_po / cin**0.5
    e = ext_strips(x)
    w = (taps(k_eq), taps(k_po))
    ours = wrapper(x, e, *w, b_eq, b_po)
    _close(ours, plain(x, e, *w, b_eq, b_po), "bfloat16")
    _close(ours, cs_conv3x3(x, e, k_eq, k_po, b_eq, b_po), "bfloat16")
    assert torch.equal(wrapper(x, e, *w, b_eq, b_po), ours)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 128, 128), (1, 48, 64, 256), (1, 48, 32, 256),
                                          (16, 24, 64, 64), (2, 12, 39, 40), (1, 20, 8, 12),
                                          (4, 48, 128, 128), (1, 126, 256, 5), (2, 10, 5, 7)])
def test_npack_kernel_past_the_first_designs_plan_on_card(cuda_device, b, n, cin, cout):
    """Kernel #3 where the first design's block did not fit shared memory
    (n = 48 with 128 -> 128 channels, Cout = 256), at one of the first
    design's largest blocks for Cout < 8 (the three dx runs of Cout
    channels side by side, odd run widths read by plain loads), at batch
    16, with an odd Cin (plain 2-byte staging) and Cout whose runs take
    8-byte copies:
    within one bf16 ulp of |ref| + 1e-4 of its plain version and of #1,
    bitwise equal from launch to launch."""
    wrapper, plain, taps = _mma_kernels()["npack"]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(b, n, cin, cout))
    k_eq, k_po = k_eq / cin**0.5, k_po / cin**0.5
    e = ext_strips(x)
    w = (taps(k_eq), taps(k_po))
    ours = wrapper(x, e, *w, b_eq, b_po)
    _close(ours, plain(x, e, *w, b_eq, b_po), "bfloat16")
    _close(ours, cs_conv3x3(x, e, k_eq, k_po, b_eq, b_po), "bfloat16")
    assert torch.equal(wrapper(x, e, *w, b_eq, b_po), ours)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 30, 1024, 1), (1, 62, 512, 3)])
def test_npack_kernel_at_the_first_designs_largest_blocks_on_card(cuda_device, b, n, cin, cout):
    """Kernel #3 at shapes whose block the first design only just fits
    (Cin of 512 and 1024, Cout < 8: the three dx runs of Cout channels side
    by side) and #1 does not plan: within one bf16 ulp of |ref| + 1e-4 of
    its plain version, bitwise equal from launch to launch."""
    wrapper, plain, taps = _mma_kernels()["npack"]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(b, n, cin, cout))
    k_eq, k_po = k_eq / cin**0.5, k_po / cin**0.5
    e = ext_strips(x)
    w = (taps(k_eq), taps(k_po))
    ours = wrapper(x, e, *w, b_eq, b_po)
    _close(ours, plain(x, e, *w, b_eq, b_po), "bfloat16")
    assert torch.equal(wrapper(x, e, *w, b_eq, b_po), ours)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 12, 39, 40), (2, 8, 24, 24), (1, 7, 16, 8),
                                          (1, 9, 16, 5), (1, 6, 24, 12)])
def test_npack_kernel_at_every_tile_on_card(cuda_device, b, n, cin, cout):
    """Kernel #3 launched with every tile its plan chooses from, and each
    with one weight buffer too (ragged row and channel tiles, an odd count
    of n8 tiles at 8 channels): each within one bf16 ulp of |ref| + 1e-4 of
    the plain version, and every tile's output bitwise equal to the plan's
    where both sum in the same order (the same channel width: the K order
    of a product column does not depend on the rows)."""
    from dlwp_cs_tpu_torch.ops import conv_variants as cv

    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(b, n, cin, cout))
    k_eq, k_po = k_eq / cin**0.5, k_po / cin**0.5
    e = ext_strips(x)
    w = (cv.npack_taps(k_eq), cv.npack_taps(k_po))
    ref = cv.cs_conv3x3_npack_plain(x, e, *w, b_eq, b_po)
    kernel = cv.cs_conv3x3_npack
    dev = kernel._device(x)
    tiles = cv.npack_tiles(b, n, cin, cout)
    tiles += [cv.npack_launch(b, n, cin, cout, p.h, p.bn, 1) for p in tiles if p.wbufs == 2]
    assert {p.wbufs for p in tiles} == {1, 2} and 8 in {p.bn for p in tiles}
    outs = {}
    for p in tiles:
        out = torch.empty((b, 6, n, n, cout), dtype=torch.bfloat16, device=cuda_device)
        kernel._launch_kernel(dev, x, e, *w, b_eq, b_po, out, plan=p)
        _close(out, ref, "bfloat16")
        outs.setdefault(p.bn, []).append(out)
    for same in outs.values():
        for out in same[1:]:
            assert torch.equal(out, same[0])


@pytest.mark.cuda
def test_im2col_kernel_on_the_packed_layout_on_card(cuda_device):
    """Kernel #13 at the packed layout's 128 channels (n = 48, batch 4):
    the kernel_variants tool's ``im2colonly`` row."""
    wrapper, plain, taps = _mma_kernels()["im2col"]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                                 for a in _case(4, 48, 128, 128))
    k_eq, k_po = k_eq / 128**0.5, k_po / 128**0.5
    e = ext_strips(x)
    ours = wrapper(x, e, taps(k_eq), taps(k_po), b_eq, b_po)
    _close(ours, plain(x, e, taps(k_eq), taps(k_po), b_eq, b_po), "bfloat16")
    _close(ours, cs_conv3x3(x, e, k_eq, k_po, b_eq, b_po), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["npack", "npack_v1", "im2col", "im2col_v1"])
def test_mma_conv_kernels_reject_float32(cuda_device, kind):
    wrapper, _, taps = _mma_kernels()[kind]
    x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device) for a in _case(1, 8, 4, 8))
    before = wrapper.launches
    with pytest.raises(ValueError, match="bfloat16 only"):
        wrapper(x, ext_strips(x), taps(k_eq), taps(k_po), b_eq, b_po)
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", [(2, 8, 5, 7), (16, 48, 32, 32), (16, 12, 128, 128)])
def test_kernel_only_is_the_conv_kernel_on_card(cuda_device, dtype, b, n, cin, cout):
    """Kernel #12, the conv kernel on strips computed before the call,
    equals kernel #1 bitwise and counts its launches apart."""
    from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_kernel_only

    x, *w = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
             for a in _case(b, n, cin, cout))
    e = ext_strips(x)
    before = (cs_conv3x3_kernel_only.launches, cs_conv3x3.launches)
    ours = cs_conv3x3_kernel_only(x, e, *w)
    torch.cuda.synchronize()
    assert (cs_conv3x3_kernel_only.launches, cs_conv3x3.launches) == (before[0] + 1, before[1])
    assert torch.equal(ours, cs_conv3x3(x, e, *w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", [(1, 10, 3, 9), (2, 8, 12, 16), (16, 48, 32, 32),
                                          (16, 24, 64, 64), (16, 12, 128, 128),
                                          (16, 24, 192, 64)])
def test_dx_ring_kernel_matches_plain_and_dx_kernel_on_card(cuda_device, dtype, b, n, cin,
                                                            cout):
    """Kernel #14 against its plain version; its interior bitwise equal to
    kernel #4's dx, its S/N rows and its W/E columns at rows 1..n bitwise
    equal to #4's d_ext, whose W/E ends stay zero (#4 as before)."""
    from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_dx_ring, cs_conv3x3_dx_ring_plain

    tdt = getattr(torch, dtype)
    _, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, tdt)
                           for a in _case(1, 1, cin, cout))
    g = torch.randn((b, 6, n, n, cout), generator=torch.Generator().manual_seed(9))
    g = g.to(cuda_device, tdt)
    before = (cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches)
    dx, dring = cs_conv3x3_dx_ring(g, k_eq, k_po)
    dx4, d_ext = cs_conv3x3_dx(g, k_eq, k_po)
    torch.cuda.synchronize()
    assert (cs_conv3x3_dx_ring.launches, cs_conv3x3_dx.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    ref_dx, ref_ring = cs_conv3x3_dx_ring_plain(g, k_eq, k_po)
    _close(dx, ref_dx, dtype)
    _close(dring, ref_ring, dtype)
    assert torch.equal(dx, dx4)
    assert torch.equal(dring[:, :, :2], d_ext[:, :, :2])
    assert torch.equal(dring[:, :, 2:, 1 : n + 1], d_ext[:, :, 2:, 1 : n + 1])
    assert not bool(d_ext[:, :, 2:, [0, n + 1]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 8, 8, 5), (16, 6, 48, 48, 32), (1, 6, 12, 12, 128),
                                   (2, 6, 48, 48, 39), (3, 6, 24, 24, 3), (1, 6, 7, 7, 24)])
@pytest.mark.parametrize("v1", [False, True])
def test_lane_store_is_three_x_on_card(cuda_device, dtype, shape, v1):
    """Kernel #15 returns 3 x bitwise (x + x is exact, so one rounding),
    through its 16-byte path (C's bytes a multiple of 16; C = 24: three or
    six 16-byte items a pixel) and its element path (C = 5, 39, 3), as does
    the kernel it replaced (the timing row ``lane_store_v1``)."""
    from dlwp_cs_tpu_torch.tools.probes import lane_store, lane_store_v1

    kernel = lane_store_v1 if v1 else lane_store
    x = torch.randn(shape, generator=torch.Generator().manual_seed(10))
    x = x.to(cuda_device, getattr(torch, dtype))
    before = kernel.launches
    out = kernel(x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(out, 3 * x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("small", [True, False])
def test_probes_match_plain_on_card(cuda_device, dtype, small):
    """Every probe of #16 (and its launch count) through the probe tool's
    own check: equal where no sum is reordered, within 1e-5 of the largest
    entry (+ one bf16 ulp for bf16 outputs) for the products."""
    from dlwp_cs_tpu_torch.tools import mosaic_bisect, probes

    before = {k.name: k.launches for k in probes.PROBES.values()}
    rows = mosaic_bisect.run(cuda_device, getattr(torch, dtype), small, reps=1)
    torch.cuda.synchronize()
    assert len(rows) == 9 + 2 * (2 if small else len(mosaic_bisect.DW_SHAPES))
    for k in probes.PROBES.values():  # one checked launch, 3 timed per row
        n_rows = sum(r["probe"] == k.name for r in rows)
        assert k.launches - before[k.name] == 4 * n_rows, k.name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("small", [True, False])
def test_v1_probes_match_plain_on_card(cuda_device, dtype, small):
    """The probe kernels that #16's redesign replaced (tools/probes.py's
    ``PROBES_V1``, timing rows), at the probe tool's inputs and gate,
    counted apart from the tool's probes; the redesigned probes bitwise
    equal from one call to the next."""
    from dlwp_cs_tpu_torch.tools import mosaic_bisect, probes

    old_of = {probes.PROBES[k].name: v for k, v in probes.PROBES_V1.items()}
    before = {k.name: k.launches for k in probes.PROBES.values()}
    checked = 0
    for name, probe, args in mosaic_bisect._cases(cuda_device, getattr(torch, dtype), small):
        ref = probe.plain(*args)
        old = old_of.get(probe.name)
        if old is not None:
            err, tol, ok = mosaic_bisect.compare(name, old(*args), ref)
            assert ok, (name, err, tol)
            checked += 1
    assert {k.name: k.launches for k in probes.PROBES.values()} == before
    assert checked == 8 + 2 * (2 if small else len(mosaic_bisect.DW_SHAPES))
    for name, probe, args in mosaic_bisect._cases(cuda_device, getattr(torch, dtype), small):
        assert torch.equal(probe(*args), probe(*args)), name


@pytest.mark.cuda
def test_probes_reject_bad_arguments(cuda_device):
    """Shapes, dtypes and devices are checked before any pointer reaches
    the kernels; nothing launches."""
    from dlwp_cs_tpu_torch.tools import probes

    x = torch.zeros((8, 8, 4), device=cuda_device)
    before = {k.name: k.launches for k in probes.PROBES.values()}
    with pytest.raises(ValueError, match="shape"):
        probes.probe_dot(x, torch.zeros((5, 3), device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        probes.probe_assemble(x, torch.zeros((4, 9, 4), device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        probes.probe_bias(x, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="one dtype"):
        probes.probe_dw_reshape(x, torch.zeros((8, 8, 4), device=cuda_device).bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probes.probe_select(*(torch.zeros((3, 3, 4, 4), device=cuda_device).half(),) * 2)
    assert {k.name: k.launches for k in probes.PROBES.values()} == before


@pytest.mark.cuda
def test_tools_hold_their_kernel_rows_against_plain_on_card(cuda_device):
    """conv_micro and kernel_variants at their small sizes on the card:
    every row that launches a kernel of the port is held against its plain
    version inside the tool (a failure raises), #12 bitwise against #1,
    each kernel row timed."""
    from dlwp_cs_tpu_torch.tools import conv_micro, kernel_variants

    for r in conv_micro.run(conv_micro.LEVELS_SMALL, torch.bfloat16, cuda_device, reps=1):
        assert r["kernel_equals_fused"] and r["kernel_max_abs_err"] < 0.1
        assert r["kernel"] > 0 and r["kernel_plain_ms"] > 0 and r["kernel_library_ms"] > 0
    rows = kernel_variants.run(cuda_device, small=True, reps=1)
    checked = [k for k, r in rows.items() if isinstance(r, dict) and r.get("plain_max_abs_err")
               is not None]
    assert len(checked) == 12 and all(rows[k]["ms"] > 0 for k in checked)


# (n, Cin, Cout) of the flagship U-Net's convs, in order; the dx kernel runs
# on the last 9 in a training step (the first conv's input is data)
FLAGSHIP_CONVS = [
    (48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128), (12, 128, 128),
    (24, 192, 64), (24, 64, 64), (48, 96, 32), (48, 32, 32),
]
TC_SHAPES = sorted(set(FLAGSHIP_CONVS), key=FLAGSHIP_CONVS.index) + [(96, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("n,cin,cout", TC_SHAPES)
def test_tensor_core_conv_matches_plain_on_card(cuda_device, b, n, cin, cout):
    """The bfloat16 forward (#1) on the tensor cores at every flagship conv
    shape (the 12-channel input included) and n = 96, at the serving and the
    training batch: one launch, within one bf16 ulp + 1e-4 of its plain
    version."""
    x, *w = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
             for a in _case(b, n, cin, cout))
    w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
    e = ext_strips(x)
    before = cs_conv3x3.launches
    ours = cs_conv3x3(x, e, *w)
    torch.cuda.synchronize()
    assert cs_conv3x3.launches == before + 1
    _close(ours, cs_conv3x3_plain(x, e, *w), "bfloat16")


def _block_of(x, ext, r0, c0, rows, cols):
    """A block of whole faces ``x`` and its ghost strips, as an exchange
    would give them: rows r0.., columns c0.. of the padded faces."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import _padded_faces

    p = _padded_faces(x, ext)
    blk = x[:, :, r0 : r0 + rows, c0 : c0 + cols].contiguous()
    strips = torch.zeros(x.shape[:2] + (4, cols + 2, x.shape[-1]), dtype=x.dtype,
                         device=x.device)
    strips[:, :, 0] = p[:, :, r0, c0 : c0 + cols + 2]
    strips[:, :, 1] = p[:, :, r0 + rows + 1, c0 : c0 + cols + 2]
    strips[:, :, 2, 1 : rows + 1] = p[:, :, r0 + 1 : r0 + rows + 1, c0]
    strips[:, :, 3, 1 : rows + 1] = p[:, :, r0 + 1 : r0 + rows + 1, c0 + cols + 1]
    return blk, strips


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 12, 32), (8, 24, 192, 64), (1, 12, 128, 128),
                                          (2, 48, 96, 32), (16, 24, 64, 64)])
def test_tensor_core_blocks_equal_the_whole_face_on_card(cuda_device, b, n, cin, cout):
    """#8 (rank 1's band of 4, rank 3's band of 2) and #9 (the NE tile of
    2 x 2) in bfloat16, given the ghost values the whole face has there,
    equal the matching rows of #1's whole-face output bitwise: one K order
    for every output, whatever the plan's tiles."""
    x, *w = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
             for a in _case(b, n, cin, cout))
    w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
    e = ext_strips(x)
    whole = cs_conv3x3(x, e, *w)
    for wrapper, (r0, c0, rows, cols) in (
        (cs_conv3x3_band, (n // 4, 0, n // 4, n)),
        (cs_conv3x3_band, (n // 2, 0, n // 2, n)),
        (cs_conv3x3_tile, (n // 2, n // 2, n // 2, n // 2)),
    ):
        blk, strips = _block_of(x, e, r0, c0, rows, cols)
        ours = wrapper(blk, strips, *w)
        torch.cuda.synchronize()
        assert torch.equal(ours, whole[:, :, r0 : r0 + rows, c0 : c0 + cols]), (wrapper.name,
                                                                               r0, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout", FLAGSHIP_CONVS[1:])
def test_tensor_core_dx_matches_plain_at_the_step_shapes_on_card(cuda_device, n, cin, cout):
    """The bfloat16 dx kernel (#4) on the tensor cores at the training
    step's 9 shapes at batch 16: dx and d_ext within one bf16 ulp + 1e-4
    of the plain version, d_ext's W/E ends zero."""
    _, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                           for a in _case(1, 1, cin, cout))
    g = torch.randn((16, 6, n, n, cout), generator=torch.Generator().manual_seed(n + cin))
    g = g.to(cuda_device, torch.bfloat16)
    before = cs_conv3x3_dx.launches
    dx, d_ext = cs_conv3x3_dx(g, k_eq / cout**0.5, k_po / cout**0.5)
    torch.cuda.synchronize()
    assert cs_conv3x3_dx.launches == before + 1
    ref_dx, ref_ext = cs_conv3x3_dx_plain(g, k_eq / cout**0.5, k_po / cout**0.5)
    _close(dx, ref_dx, "bfloat16")
    _close(d_ext, ref_ext, "bfloat16")
    assert not bool(d_ext[:, :, 2:, [0, n + 1]].any())


@pytest.mark.cuda
def test_tensor_core_kernels_refuse_what_the_plan_refuses(cuda_device):
    """A bfloat16 row of more than 256 pixels, or weights of one 8-channel
    slice past the shared memory, raise before any launch: nothing falls
    back to another kernel."""
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    x = torch.zeros((1, 6, 2, 300, 8), **bf)
    ext = torch.zeros((1, 6, 4, 302, 8), **bf)
    w = [torch.zeros((3, 3, 8, 8), **bf)] * 2 + [torch.zeros((8,), **bf)] * 2
    before = (cs_conv3x3_band.launches, cs_conv3x3_dx.launches)
    with pytest.raises(ValueError, match="rows of at most 256"):
        cs_conv3x3_band(x, ext, *w)
    g = torch.zeros((1, 6, 4, 4, 2048), **bf)
    k = torch.zeros((3, 3, 8, 2048), **bf)
    with pytest.raises(ValueError, match="cannot hold the weights"):
        cs_conv3x3_dx(g, k, k)
    assert (cs_conv3x3_band.launches, cs_conv3x3_dx.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 12, 32), (16, 24, 192, 64), (2, 8, 5, 7)])
def test_cuda_core_instances_match_plain_on_card(cuda_device, b, n, cin, cout):
    """The CUDA-core forward and dx kernels in both dtypes that the
    tensor-core ones replaced (kept so that one card call times the two
    side by side): each against its plain version; in float32 the
    production forward and dx (3xTF32 on the tensor cores) within 1e-4 of
    the CUDA-core ones."""
    from dlwp_cs_tpu_torch.ops.conv_variants import (
        cs_conv3x3_cudacore,
        cs_conv3x3_dx_cudacore,
        cs_conv3x3_dx_ring_plain,
    )

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        x, *w = (torch.from_numpy(a).to(cuda_device, tdt) for a in _case(b, n, cin, cout))
        w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
        e = ext_strips(x)
        g = torch.randn((b, 6, n, n, cout), generator=torch.Generator().manual_seed(3))
        g = g.to(cuda_device, tdt)
        out = cs_conv3x3_cudacore(x, e, *w)
        dx, d_ext = cs_conv3x3_dx_cudacore(g, w[0], w[1])
        dx_r, ring = cs_conv3x3_dx_cudacore(g, w[0], w[1], raw=True)
        torch.cuda.synchronize()
        _close(out, cs_conv3x3_plain(x, e, *w), dtype)
        for ours, ref in zip((dx, d_ext), cs_conv3x3_dx_plain(g, w[0], w[1])):
            _close(ours, ref, dtype)
        _close(ring, cs_conv3x3_dx_ring_plain(g, w[0], w[1])[1], dtype)
        assert torch.equal(dx_r, dx)
        if dtype == "float32":  # the production kernels, 3xTF32 on the tensor cores
            _close(cs_conv3x3_dx(g, w[0], w[1])[0], dx, dtype)
            _close(cs_conv3x3(x, e, *w), out, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("n,cin,cout", TC_SHAPES)
def test_float32_tensor_core_conv_matches_plain_on_card(cuda_device, b, n, cin, cout):
    """The float32 forward (#1) on the tensor cores (3xTF32) at every
    flagship conv shape and n = 96, at the serving and the training batch:
    one launch, within 1e-4 of its plain version."""
    x, *w = (torch.from_numpy(a).to(cuda_device) for a in _case(b, n, cin, cout))
    w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
    e = ext_strips(x)
    before = cs_conv3x3.launches
    ours = cs_conv3x3(x, e, *w)
    torch.cuda.synchronize()
    assert cs_conv3x3.launches == before + 1
    _close(ours, cs_conv3x3_plain(x, e, *w), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 12, 32), (8, 24, 192, 64), (1, 12, 128, 128),
                                          (2, 48, 96, 32), (16, 24, 64, 64), (1, 10, 3, 9)])
def test_float32_blocks_equal_the_whole_face_on_card(cuda_device, b, n, cin, cout):
    """#8 (band) and #9 (tile) in float32, given the ghost values the whole
    face has there, equal the matching rows of #1's float32 output bitwise.
    (#11 equals #8 bitwise in both dtypes:
    test_band_exchange_kernels_on_ranks_sharing_the_card.)"""
    x, *w = (torch.from_numpy(a).to(cuda_device) for a in _case(b, n, cin, cout))
    w[0], w[1] = w[0] / cin**0.5, w[1] / cin**0.5
    e = ext_strips(x)
    whole = cs_conv3x3(x, e, *w)
    for wrapper, (r0, c0, rows, cols) in (
        (cs_conv3x3_band, (n // 4, 0, n // 4, n)),
        (cs_conv3x3_band, (n // 2, 0, n // 2, n)),
        (cs_conv3x3_tile, (n // 2, n // 2, n // 2, n // 2)),
    ):
        blk, strips = _block_of(x, e, r0, c0, rows, cols)
        ours = wrapper(blk, strips, *w)
        torch.cuda.synchronize()
        assert torch.equal(ours, whole[:, :, r0 : r0 + rows, c0 : c0 + cols]), (wrapper.name,
                                                                               r0, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout", TC_SHAPES[:-1])
def test_tensor_core_dw_matches_plain_at_the_step_shapes_on_card(cuda_device, n, cin, cout):
    """The bfloat16 dw kernel (#5) on the tensor cores at the training
    step's 8 distinct shapes at batch 16: dK and db within 1e-5 of each
    one's largest entry of the plain version, and bitwise repeatable."""
    gen = torch.Generator().manual_seed(n + cin + cout)
    x = torch.randn((16, 6, n, n, cin), generator=gen).to(cuda_device, torch.bfloat16)
    g = torch.randn((16, 6, n, n, cout), generator=gen).to(cuda_device, torch.bfloat16)
    e = ext_strips(x)
    before = cs_conv3x3_dw.launches
    dw = cs_conv3x3_dw(x, e, g)
    again = cs_conv3x3_dw(x, e, g)
    torch.cuda.synchronize()
    assert cs_conv3x3_dw.launches == before + 2
    for ours, twice, ref in zip(dw, again, cs_conv3x3_dw_plain(x, e, g)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
        assert torch.equal(ours, twice)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", [(2, 8, 5, 7), (16, 48, 12, 32), (16, 24, 64, 64)])
def test_cuda_core_dw_timing_row_matches_plain_on_card(cuda_device, dtype, b, n, cin, cout):
    """The CUDA-core dw kernel in both dtypes (the instances the
    tensor-core ones replaced, a timing row) against its plain version."""
    from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_dw_cudacore

    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b + n)
    x = torch.randn((b, 6, n, n, cin), generator=gen).to(cuda_device, tdt)
    g = torch.randn((b, 6, n, n, cout), generator=gen).to(cuda_device, tdt)
    e = ext_strips(x)
    before = cs_conv3x3_dw_cudacore.launches
    dw = cs_conv3x3_dw_cudacore(x, e, g)
    torch.cuda.synchronize()
    assert cs_conv3x3_dw_cudacore.launches == before + 1
    for ours, ref in zip(dw, cs_conv3x3_dw_plain(x, e, g)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


F32_BWD_SHAPES = [(16,) + s for s in TC_SHAPES[:-1]] + [(2, 8, 5, 7), (1, 48, 12, 32),
                                                      (1, 10, 3, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", F32_BWD_SHAPES)
def test_float32_tensor_core_dx_and_dw_match_plain_on_card(cuda_device, b, n, cin, cout):
    """The float32 dx (#4) and dw (#5) kernels on the tensor cores (3xTF32)
    at the training step's shapes at batch 16 and at small, ragged ones:
    one launch each; dx and d_ext within 1e-4 of the plain version, d_ext's
    W/E ends zero; dK and db within 1e-5 of each one's largest entry of the
    plain version, and bitwise repeatable."""
    gen = torch.Generator().manual_seed(n + cin + cout)
    x = torch.randn((b, 6, n, n, cin), generator=gen).to(cuda_device)
    g = torch.randn((b, 6, n, n, cout), generator=gen).to(cuda_device)
    k = [(torch.randn((3, 3, cin, cout), generator=gen) / cout**0.5).to(cuda_device)
         for _ in range(2)]
    e = ext_strips(x)
    before = (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
    dx, d_ext = cs_conv3x3_dx(g, *k)
    dw = cs_conv3x3_dw(x, e, g)
    again = cs_conv3x3_dw(x, e, g)
    torch.cuda.synchronize()
    assert (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches) == (before[0] + 1, before[1] + 2)
    ref_dx, ref_ext = cs_conv3x3_dx_plain(g, *k)
    _close(dx, ref_dx, "float32")
    _close(d_ext, ref_ext, "float32")
    assert not bool(d_ext[:, :, 2:, [0, n + 1]].any())
    for ours, twice, ref in zip(dw, again, cs_conv3x3_dw_plain(x, e, g)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
        assert torch.equal(ours, twice)


@pytest.mark.cuda
def test_float32_tensor_core_kernels_refuse_what_the_plan_refuses(cuda_device):
    """float32 weights of one 8-channel dx slice past the shared memory, or
    a face whose single dw row does not fit, raise before any launch:
    nothing falls back to the CUDA-core or plain versions."""
    f32 = dict(device=cuda_device, dtype=torch.float32)
    g = torch.zeros((1, 6, 4, 4, 1024), **f32)
    k = torch.zeros((3, 3, 8, 1024), **f32)
    before = (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
    with pytest.raises(ValueError, match="cannot hold the weights"):
        cs_conv3x3_dx(g, k, k)
    x = torch.zeros((1, 6, 600, 600, 32), **f32)
    with pytest.raises(ValueError, match="cannot stage"):
        cs_conv3x3_dw(x, ext_strips(x), torch.zeros((1, 6, 600, 600, 8), **f32))
    assert (cs_conv3x3_dx.launches, cs_conv3x3_dw.launches) == before


# ---- F4: shapes past a kernel's plan; F5: the fused apply under CUDA graphs ----

@pytest.mark.cuda
def test_refused_shape_trains_through_ringfix_on_card(cuda_device):
    """At (1, 6, 128, 128, 32) -> 32 in float32 with a gradient only the dw
    kernel's plan refuses: ``cs_conv`` takes the ring-fix composition, so
    one training step (forward, backward, SGD) launches none of #1, #4,
    #5, and matches the plain path (the fused conv's plain version through
    autograd): outputs 1e-4, gradients and updated weights 1e-5 of the
    largest entry.  Without a gradient the forward kernel plans and runs."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import fused_fits

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert not fused_fits(torch.float32, 1, 128, 32, 32, sms, True, True)
    assert fused_fits(torch.float32, 1, 128, 32, 32, sms, False, False)
    arrays = _case(1, 128, 32, 32)
    paths = {}
    for name in ("route", "plain"):
        x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device).requires_grad_(True)
                                     for a in arrays)
        params = [k_eq, k_po, b_eq, b_po]
        opt = torch.optim.SGD(params, lr=0.1)
        before = (cs_conv3x3.launches, cs_conv3x3_dx.launches, cs_conv3x3_dw.launches)
        if name == "route":
            out = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po)
        else:
            out = cs_conv3x3_plain(x, ext_strips(x), k_eq, k_po, b_eq, b_po)
        (out.square().mean()).backward()
        opt.step()
        torch.cuda.synchronize()
        assert (cs_conv3x3.launches, cs_conv3x3_dx.launches, cs_conv3x3_dw.launches) == before
        paths[name] = (out.detach(), x.grad, *(p.grad for p in params),
                       *(p.detach() for p in params))
    torch.testing.assert_close(paths["route"][0], paths["plain"][0], rtol=0, atol=1e-4)
    for ours, ref in zip(paths["route"][1:], paths["plain"][1:]):
        assert float((ours - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with torch.no_grad():
        x, k_eq, k_po, b_eq, b_po = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        before = cs_conv3x3.launches
        out = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po)
        assert cs_conv3x3.launches == before + 1
    _close(out, cs_conv3x3_plain(x, ext_strips(x), k_eq, k_po, b_eq, b_po), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_apply_graph_replays_after_its_counters_grow_on_card(cuda_device, dtype):
    """A CUDA graph of the fused apply (#7) captured at batch 1, then the
    arrival counts grown past the first buffer (a second buffer), an eager
    call at batch 16 on it, then other allocations: the graph's replays
    still count in its own buffer, which stays alive and zero.  Two
    replays agree bitwise and equal the plain version; the batch-16 call
    does too."""
    from dlwp_cs_tpu_torch.ops.ring_kernel import _RING_LIB, _XringApplyKernel

    kernel = _XringApplyKernel("xring_fused_apply_graph", _RING_LIB)  # buffers of its own
    tdt = getattr(torch, dtype)
    n, cin, d = 48, 64, 128

    def inputs(b, seed):
        x, k_eq, k_po, _, _ = (torch.from_numpy(a).to(cuda_device, tdt)
                               for a in _case(b, n, cin, d, seed=seed))
        gen = torch.Generator().manual_seed(seed)
        bases = [torch.randn((b, 6, n, n, d), generator=gen).to(cuda_device, tdt)
                 for _ in range(2)]
        return (*bases, ext_strips(x), k_eq, k_po)

    small = inputs(1, 7)
    kernel(*small)  # eager first: the counters are made outside capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*small)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(*small)
    bufs = kernel._count_buffers[small[2].device]
    assert len(bufs) == 1
    kernel._counters(bufs[0].device, bufs[0].numel() + 1)
    big = inputs(16, 8)
    out16 = kernel(*big)
    assert len(bufs) == 2 and bufs[1].numel() > bufs[0].numel()
    junk = [torch.full((1 << 16,), -1, dtype=torch.int32, device=cuda_device) for _ in range(64)]
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    _close(first, xring_fused_apply_plain(*small), dtype)
    _close(out16, xring_fused_apply_plain(*big), dtype)
    assert not any(t.any() for t in bufs)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["unet", "convlstm"])
def test_exported_forecast_equals_live_and_replays_bitwise_on_card(cuda_device, tmp_path,
                                                                   kind, dtype):
    """An exported artifact (``serve/export.py``) served on the card: the
    first request runs the program eagerly, captures the rollout as one CUDA
    graph and replays it; its forecast equals the live service's bitwise
    (the same kernels in the same order), the next replays repeat it
    bitwise, and the kernels launched while capturing (280 / 112 at full
    size; here 10 / 4 a call) show the graph holds the kernels, not their
    plain versions."""
    from dlwp_cs_tpu_torch import DataConfig, DLWPEstimator, ExperimentConfig
    from dlwp_cs_tpu_torch.serve import ExportedForecaster, ForecastService, export_forecaster

    n, steps = 24, 3
    data = DataConfig(grid_n=n, variables=("z500", "t2m"), constants=("topography",))
    if kind == "unet":
        model, per_call, kernel = UNetConfig(filters=(8, 16), compute_dtype=dtype), 6, cs_conv3x3
    else:
        model, per_call, kernel = (ConvLSTMConfig(filters=(8, 8), conv_backend="xring",
                                                  compute_dtype=dtype), 4, xring_fused_apply)
    stats = {"mean": [5400.0, 280.0], "std": [300.0, 20.0], "insol_mean": 300.0,
             "insol_std": 400.0}
    est = DLWPEstimator(ExperimentConfig(data=data, model=model), device=cuda_device,
                        seed=2).load_state(stats)
    rng = np.random.default_rng(6)
    const = rng.normal(size=(6, n, n, 1)).astype(np.float32)
    windows = (rng.normal(size=(2, 2, 6, n, n, 2)) * [300.0, 20.0]
               + [5400.0, 280.0]).astype(np.float32)
    t0 = [9668.5, 9701.25]
    export_forecaster(est, tmp_path / "art", steps=steps, batch_sizes=(2,), constants=const)
    exp = ExportedForecaster(tmp_path / "art")
    launches = kernel.launches
    live = ForecastService(est, constants=const).forecast(windows, t0, steps=steps)
    per_forecast = kernel.launches - launches
    assert per_forecast == per_call * steps
    launches = kernel.launches
    first = exp.forecast(windows, t0)
    # the eager run and the capture each launch every call's kernels once
    assert kernel.launches - launches == 2 * per_forecast
    again = exp.forecast(windows, t0)
    assert kernel.launches - launches == 2 * per_forecast  # replays launch from the graph
    assert len(exp._graphs) == 1
    np.testing.assert_array_equal(first.fields, live.fields)
    np.testing.assert_array_equal(again.fields, first.fields)
    np.testing.assert_array_equal(exp.forecast(windows[1], t0[1]).fields, first.fields[1:])


# ---- training under a mesh: 4 ranks sharing the card -----------------------

TRAIN_SGD_LR = 2.0**20  # the parameters' change is the gradient scaled by a power of two


def _mesh_train_steps():
    """One rank of a 4-rank group sharing the card: one SGD step of a small
    U-Net (n = 16, filters (8, 16)) through the data-parallel step on data
    = 4 (kernels #1, #4, #5 on the rank's block) and through the spatial
    step on 4 row bands (kernel #8; its backward the band ring-fix
    composition), in both dtypes: the new parameters and each path's
    launches."""
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_dw, cs_conv3x3_dx
    from dlwp_cs_tpu_torch.ops.losses import mse
    from dlwp_cs_tpu_torch.parallel import (
        create_mesh,
        make_dp_train_step,
        make_spatial_train_step,
        shard_batch,
    )
    from dlwp_cs_tpu_torch.train import init_params, init_state, make_optimizer, model_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = (cs_conv3x3, cs_conv3x3_dx, cs_conv3x3_dw, cs_conv3x3_band)
    meshes = {"dp": create_mesh(data=4), "band": create_mesh(data=1, spatial=4)}
    x, y = (torch.from_numpy(a).cuda() for a in _train_batch())
    opt = make_optimizer(TrainConfig(optimizer="sgd", learning_rate=TRAIN_SGD_LR))
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(8, 16), compute_dtype=dtype),
                               3, device="cuda")
        apply = model_apply(model)
        for name, m in meshes.items():
            if name == "dp":
                step, batch = make_dp_train_step(apply, opt, mse, m), shard_batch((x, y), m)
            else:
                step, batch = make_spatial_train_step(apply, opt, mse, m, band_conv="pallas"), (x, y)
            for w in wrappers:
                w.launches = 0
            state, _ = step(init_state(init_params(model, 0), opt), *batch)
            out[name, dtype] = ({k: v.detach().cpu() for k, v in state.params.items()},
                                {w.name: w.launches for w in wrappers})
    return out


def _train_batch():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8, 6, 16, 16, 3)).astype(np.float32)
    return x, (0.5 * x[..., :2]).copy()


@pytest.mark.cuda
def test_mesh_train_steps_of_ranks_sharing_the_card(cuda_device, tmp_path):
    """The data-parallel step through #1/#4/#5 and the band step through #8,
    4 ranks sharing the card: each parameter's change (its all-reduced
    gradient times 2**20) against the one-card step's within 1e-4 (float32)
    and 2**-6 (bfloat16) of the tensor's largest, every parameter moved, the
    parameters bitwise equal on every rank; the data-parallel step launches
    #1 per 3x3 conv, #5 per 3x3 conv and #4 for all but the first, the band
    step #8 per 3x3 conv and none of #1/#4/#5."""
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group
    from dlwp_cs_tpu_torch.train import Trainer

    results = spawn_group(_mesh_train_steps, 4, workdir=tmp_path)
    x, y = (torch.from_numpy(a).to(cuda_device) for a in _train_batch())
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2.0**-6)):
        model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(8, 16), compute_dtype=dtype),
                               3, device=cuda_device)
        one = Trainer(model, TrainConfig(optimizer="sgd", learning_rate=TRAIN_SGD_LR))
        state0 = one.init(x)
        cs_conv3x3.launches = 0
        ref, _ = one.train_step(state0, x, y)
        convs = cs_conv3x3.launches
        want = {"dp": {"cs_conv3x3": convs, "cs_conv3x3_dx": convs - 1, "cs_conv3x3_dw": convs,
                       "cs_conv3x3_band": 0},
                "band": {"cs_conv3x3": 0, "cs_conv3x3_dx": 0, "cs_conv3x3_dw": 0,
                         "cs_conv3x3_band": convs}}
        for name in ("dp", "band"):
            for r in results:
                params, launches = r[name, dtype]
                assert launches == want[name], (name, dtype, launches)
                for k, p0 in state0.params.items():
                    p0 = p0.detach().cpu()
                    g, g_ref = p0 - params[k], p0 - ref.params[k].detach().cpu()
                    assert float(g.abs().max()) > 0, (name, dtype, k)
                    err = float((g - g_ref).abs().max() / g_ref.abs().max())
                    assert err <= tol, (name, dtype, k, err)
                    assert torch.equal(params[k], results[0][name, dtype][0][k])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bilinear", "conservative"])
def test_apply_remap_on_card(cuda_device, tmp_path, kind):
    """``apply_remap`` on a CUDA tensor computes on the card: float32 within
    1e-5 of the largest |x| of ``RemapWeights.apply_numpy`` (float32 sums in
    another order), bitwise repeatable; an integer field promoted to
    float32 likewise; bfloat16 within 2**-6 of the largest |x| of the plain
    version on the bfloat16-rounded inputs and weights (bfloat16 roundings
    of partial sums); a NaN source column poisons exactly the rows that use
    it."""
    from dlwp_cs_tpu_torch.geometry import CubedSphere
    from dlwp_cs_tpu_torch.remap import (
        RemapWeights,
        apply_remap,
        conservative_weights,
        latlon_grid,
        ll_to_cs_weights,
    )

    if kind == "bilinear":
        w = ll_to_cs_weights(*latlon_grid(46, 90), CubedSphere(24))
    else:
        w = conservative_weights("ll2cs", n_lat=91, n_lon=180, n_cs=24, lat_centered=False,
                                 cache_dir=tmp_path)
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(3, 5, w.shape[1])) * 100.0).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    out = apply_remap(w, xd)
    assert out.device.type == "cuda" and out.dtype == torch.float32
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(out.cpu().numpy(), w.apply_numpy(x), rtol=0, atol=1e-5 * scale)
    assert torch.equal(apply_remap(w, xd), out)
    ints = np.round(x).astype(np.int32)
    got = apply_remap(w, torch.from_numpy(ints).to(cuda_device))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), w.apply_numpy(ints.astype(np.float32)),
                               rtol=0, atol=1e-5 * scale)
    xb = xd.bfloat16()
    wb = RemapWeights(w.rows, w.cols, torch.from_numpy(w.vals).bfloat16().float().numpy(),
                      w.shape)
    gotb = apply_remap(w, xb)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().cpu().numpy(), wb.apply_numpy(xb.float().cpu().numpy()),
                               rtol=0, atol=2.0**-6 * scale)
    col = int(w.cols[len(w.cols) // 3])
    x[1, 2, col] = np.nan
    nan_out = apply_remap(w, torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    users = np.zeros(w.shape[0], bool)
    users[w.rows[w.cols == col]] = True
    assert users.any() and not users.all()
    np.testing.assert_array_equal(np.isnan(nan_out[1, 2]), users)
    assert np.isnan(nan_out).sum() == users.sum()


def _int8_case(b, n, cin, cout, device, seed=13):
    rng = np.random.default_rng(seed)
    qx = torch.from_numpy(rng.integers(-127, 128, size=(b, 6, n, n, cin)).astype(np.int8))
    qk = torch.from_numpy(rng.integers(-127, 128, size=(2, 3, 3, cin, cout)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-6, 1e-3, size=(2, cout)).astype(np.float32))
    return qx.to(device), qk.to(device), scale.to(device)


# Cin 12 (the flagship's first conv: 4-byte staging), 16 and 192 (16-byte),
# 33 (byte by byte); Cout 32 (128 x 32 tiles) and wider (64 x 64), one that
# no tile divides; faces that no tile divides (n = 7, 12)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,cout", [
    (1, 48, 12, 32), (2, 24, 16, 64), (1, 12, 33, 40), (1, 24, 192, 64), (3, 7, 33, 5),
    (8, 12, 128, 128),
])
def test_int8_kernel_bitwise_equal_to_plain_on_card(cuda_device, dtype, b, n, cin, cout):
    """The s8 tensor-core conv equals its plain version bit for bit (exact
    integer sums, the same float32 product and rounding), on both weight
    groups' faces."""
    from dlwp_cs_tpu_torch.ops.quant import cs_conv3x3_int8_base, cs_conv3x3_int8_plain

    tdt = getattr(torch, dtype)
    qx, qk, scale = _int8_case(b, n, cin, cout, cuda_device)
    before = cs_conv3x3_int8_base.launches
    ours = cs_conv3x3_int8_base(qx, qk, scale, tdt)
    torch.cuda.synchronize()
    assert cs_conv3x3_int8_base.launches == before + 1 and ours.dtype == tdt
    ref = cs_conv3x3_int8_plain(qx, qk, scale, tdt)
    assert torch.equal(ours, ref), (ours.float() - ref.float()).abs().max()
    # the host's plain version (float64 convs on the CPU) gives the same bits
    assert torch.equal(ours.cpu(), cs_conv3x3_int8_plain(qx.cpu(), qk.cpu(), scale.cpu(), tdt))


@pytest.mark.cuda
def test_int8_kernel_under_graph_capture_and_in_a_model(cuda_device):
    """Captured in a CUDA graph, replays equal the eager call; a quantized
    U-Net call on the card launches the kernel once per 3x3 conv, no other
    conv kernel of the port, and equals its call on the plain version."""
    from dlwp_cs_tpu_torch.ops import quant

    qx, qk, scale = _int8_case(2, 24, 64, 64, cuda_device)
    eager = quant.cs_conv3x3_int8_base(qx, qk, scale, torch.bfloat16)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        quant.cs_conv3x3_int8_base(qx, qk, scale, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = quant.cs_conv3x3_int8_base(qx, qk, scale, torch.bfloat16)
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)

    cfg = UNetConfig(output_channels=4, filters=(8, 16), conv_backend="int8",
                     compute_dtype="bfloat16")
    model = CubeSphereUNet(cfg, 7, device=cuda_device,
                           generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(2, 6, 16, 16, 7))
                         .astype(np.float32)).to(cuda_device)
    before, fused = quant.cs_conv3x3_int8_base.launches, cs_conv3x3.launches
    with torch.no_grad():
        ours = model(x)
    torch.cuda.synchronize()
    assert quant.cs_conv3x3_int8_base.launches == before + 6
    assert cs_conv3x3.launches == fused
    saved = quant.cs_conv3x3_int8_base
    quant.cs_conv3x3_int8_base = quant.cs_conv3x3_int8_plain
    try:
        with torch.no_grad():
            plain = model(x)
    finally:
        quant.cs_conv3x3_int8_base = saved
    assert torch.equal(ours, plain)
    assert bool(torch.isfinite(ours).all())


@pytest.mark.cuda
def test_int8_kernel_rejects_bad_arguments(cuda_device):
    from dlwp_cs_tpu_torch.ops.quant import cs_conv3x3_int8_base

    qx, qk, scale = _int8_case(1, 8, 4, 8, cuda_device)
    with pytest.raises(ValueError, match="qk"):
        cs_conv3x3_int8_base(qx, qk.float(), scale, torch.float32)
    with pytest.raises(ValueError, match="scale"):
        cs_conv3x3_int8_base(qx, qk, scale[:, :4], torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cs_conv3x3_int8_base(qx, qk, scale, torch.float16)


@pytest.mark.cuda
def test_barotropic_day_on_card_matches_cpu_float64(cuda_device):
    """One day (48 RK4 steps of 30 min) of the T42 Rossby-Haurwitz case in
    float32 on the card against the same on the CPU in float64: within
    1e-4 of the largest |zeta| (float32 rounding carried through 192
    tendencies; the card's matmuls run in full float32)."""
    from dlwp_cs_tpu_torch.barotropic import BarotropicModel, SphericalHarmonics

    card = BarotropicModel(SphericalHarmonics(42, device=cuda_device))
    host = BarotropicModel(SphericalHarmonics(42, device="cpu"))
    z0 = card.rossby_haurwitz_vorticity()
    ours = card.integrate(torch.as_tensor(z0, dtype=torch.float32), 48, save_every=24)
    ref = host.integrate(z0, 48, save_every=24)
    assert ours.device.type == "cuda" and ours.dtype == torch.float32
    assert ref.dtype == torch.float64 and ours.shape == ref.shape == (2, 65, 130)
    torch.testing.assert_close(ours.cpu().double(), ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_trace_names_the_kernels_on_card(cuda_device, tmp_path):
    """``utils.trace`` around a fused conv's forward and backward writes a
    trace whose device events name the forward, dx and dw kernels."""
    import json

    from dlwp_cs_tpu_torch.utils import trace

    x, *w = (torch.from_numpy(a).to(cuda_device, torch.bfloat16).requires_grad_(True)
             for a in _case(2, 24, 32, 32))
    with trace(tmp_path) as path:
        out = cs_conv(x, w[0], w[1], bias_eq=w[2], bias_pole=w[3])
        out.float().square().sum().backward()
        torch.cuda.synchronize()
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    for kernel in ("cs_conv3x3_tc_kernel", "cs_conv3x3_dx_tc_kernel", "cs_conv3x3_dw_tc_kernel"):
        assert any(kernel in name for name in names), kernel


# ---- the named-axis collectives on the card (device_collectives) ----------

# (op, shape, axis, tiled): a band's ghost-row strip, the seam strips, a
# tile's columns, a data=4 gradient bucket, odd sizes (the scalar paths)
COLLECTIVE_CASES = [
    ("ppermute", (1, 6, 1, 48, 32), None, None),
    ("ppermute", (8, 6, 3, 12, 64), None, None),
    ("ppermute", (1, 6, 12, 1, 12), None, None),
    ("ppermute", (3, 5), None, None),
    ("all_gather", (1, 6, 4, 1, 50, 32), 0, True),
    ("all_gather", (1, 6, 6, 24, 64), 3, True),
    ("all_gather", (1, 6, 6, 24, 64), 3, False),
    ("all_gather", (2, 3, 5), 0, False),
    ("psum", (1, 6, 4, 1, 50, 32), None, None),
    ("psum", (411_213,), None, None),
    ("psum", (1, 6, 4, 2, 14, 12), None, None),
    ("psum", (7,), None, None),
]


def _collective_perms(world):
    """Every ``ppermute`` permutation the halo code issues on ``world``
    shards, and one that names only some receivers."""
    return [[(i, (i + 1) % world) for i in range(world)],
            [(i, (i - 1) % world) for i in range(world)],
            [(0, world - 1), (world - 1, 0)]]


def _device_collectives(cases, reps):
    """One rank: every case of ``cases`` in both dtypes through the device
    transport and the plain version over gloo on the same inputs (each rank
    its own seeded draw), ``reps`` back-to-back calls each; the outputs, the
    launches, the routes and the buffers before and after ``release_all``."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import device_collectives as dc
    from dlwp_cs_tpu_torch.parallel import symmetric

    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    gen = torch.Generator(device="cuda").manual_seed(300 + rank)
    out = {"route": dc.route(torch.zeros(1, device="cuda"), group), "mismatches": [],
           "zeros_ok": True}
    for w in dc.KERNELS.values():
        w.launches = 0
    calls = 0
    for op, shape, axis, tiled in cases:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            if op == "ppermute":
                runs = [(lambda p=p: dc.ppermute(x, group, p),
                         lambda p=p: dc.ppermute_plain(x, group, p), p)
                        for p in _collective_perms(world)]
            elif op == "all_gather":
                runs = [(lambda: dc.all_gather(x, group, axis, tiled),
                         lambda: dc.all_gather_plain(x, group, axis, tiled), None)]
            else:
                runs = [(lambda: dc.psum(x, group), lambda: dc.psum_plain(x, group), None)]
            for ours, plain, perm in runs:
                got = [ours() for _ in range(reps)]
                calls += reps
                want = plain()
                if not all(torch.equal(g, want) for g in got):
                    out["mismatches"].append((op, shape, str(dt), perm))
                if perm is not None and rank not in {d for _, d in perm}:
                    out["zeros_ok"] &= bool((got[0] == 0).all())
    torch.cuda.synchronize()
    symmetric.check_timeouts()
    out["calls"] = calls
    out["launches"] = {k: w.launches for k, w in dc.KERNELS.items()}
    out["live_before"] = symmetric.live_buffers()
    symmetric.release_all()
    out["live_after"] = symmetric.live_buffers()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_device_collectives_equal_their_plain_versions_on_card(cuda_device, tmp_path, world):
    """``ppermute`` (3 permutations), ``all_gather`` (tiled and stacked,
    axes 0 and 3) and ``psum`` through the send, reduce and unpack kernels,
    on 2 and 4 ranks sharing the card, in both dtypes, 5 back-to-back calls
    a case: each output bitwise equal to the plain version over gloo (the
    psum's rank-order sum included); the receivers no pair names get zeros;
    one group buffer mapped to every peer, freed at the end."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_device_collectives, world, COLLECTIVE_CASES, 5, workdir=tmp_path)
    for r in results:
        assert r["route"] == "device"
        assert r["mismatches"] == [], r["mismatches"]
        assert r["zeros_ok"]
        assert r["launches"]["collective_reduce"] == 2 * 5 * 4  # 4 psum cases, 2 dtypes
        assert r["launches"]["collective_unpack"] > 0 and r["launches"]["collective_send"] > 0
        assert r["live_before"] == (1, world - 1), r["live_before"]
        assert r["live_after"] == (0, 0), r["live_after"]


def _collective_stays_away():
    """Every rank sums once; then all but the last sum again, with a 2 s
    bound on each wait: the others' error messages, from the end of the
    block of work and from the next call."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import device_collectives as dc
    from dlwp_cs_tpu_torch.parallel import symmetric

    symmetric.SPIN_TIMEOUT_S = 2.0
    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.ones((4, 1000), device="cuda")
    dc.psum(x, dist.group.WORLD)
    torch.cuda.synchronize()
    dist.barrier()
    if rank == world - 1:
        return None
    msgs = []
    for _ in range(2):
        try:
            dc.psum(x, dist.group.WORLD)
            symmetric.check_timeouts()
            msgs.append("no error")
        except RuntimeError as e:
            msgs.append(str(e))
    return msgs


@pytest.mark.cuda
def test_device_collective_times_out_when_a_rank_stays_away(cuda_device, tmp_path):
    """Three of 4 ranks call ``psum`` without the fourth: each raises an
    error naming its rank, the epoch and the counter it waited on, and
    raises it again at its next call; the group then ends."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_collective_stays_away, 4, workdir=tmp_path)
    assert results[-1] is None
    for rank, msgs in enumerate(results[:-1]):
        for msg in msgs:
            assert "collective psum timed out" in msg and f"rank {rank}" in msg, msg
            assert "epoch 2" in msg and "counter" in msg, msg


def _sharded_forward_counts():
    """One rank of 4 sharing the card: a small U-Net (n = 16) through row
    bands and 2 x 2 tiles with kernels #8 / #9, and through #10 + #8 and
    #11: the collectives each forward issued on the device and through the
    host, and the outputs."""
    from dlwp_cs_tpu_torch.parallel import collectives, create_mesh, make_spatial_apply

    model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(8, 16)), 3, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_train_batch()[0][:1]).cuda()
    out = {}
    for name, shape, opts in (("band", (1, 4, 1), dict(band_conv="pallas")),
                              ("tile", (1, 2, 2), dict(band_conv="pallas")),
                              ("rdma", (1, 4, 1), dict(band_impl="rdma", band_conv="pallas")),
                              ("overlap", (1, 4, 1), dict(band_conv="overlap"))):
        mesh = create_mesh(data=shape[0], spatial=shape[1], spatial_x=shape[2])
        fn = make_spatial_apply(model, mesh, **opts)
        before = (collectives.device_calls, collectives.host_calls)
        with torch.no_grad():
            y = fn(x)
        out[name] = (collectives.device_calls - before[0], collectives.host_calls - before[1],
                     y.cpu())
    return out


@pytest.mark.cuda
def test_sharded_forward_stages_no_collective_through_the_host(cuda_device, tmp_path):
    """4 ranks sharing the card run a U-Net forward on bands and tiles
    (#8, #9, #10 + #8, #11): every collective runs on the device
    (``host_calls == 0``), and each rank's output equals the one-card
    forward bitwise."""
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    results = spawn_group(_sharded_forward_counts, 4, workdir=tmp_path)
    model = CubeSphereUNet(UNetConfig(output_channels=2, filters=(8, 16)), 3, device=cuda_device,
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model(torch.from_numpy(_train_batch()[0][:1]).to(cuda_device)).cpu()
    for r in results:
        for name, (device_calls, host_calls, y) in r.items():
            assert host_calls == 0 and device_calls > 0, (name, device_calls, host_calls)
            assert torch.equal(y, ref), (name, (y - ref).abs().max())
