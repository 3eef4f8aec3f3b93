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
group) against the one-card conv likewise.
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
        assert r["live_before"] == (1, 1 if world == 2 else 2), r["live_before"]
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
