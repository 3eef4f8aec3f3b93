"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 1e-4 absolute (outputs of order 1-10, f32 sums of up to
9*192 products in another order; TF32 off); bfloat16 one bf16 ulp
relative (2**-7 of |ref|) plus that f32 bound, since both round an f32 sum
once and the two sums may straddle a rounding boundary.
"""

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3, cs_conv3x3_plain


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


@pytest.mark.cuda
def test_kernel_rejects_mismatched_dtype(cuda_device):
    x, *w = (torch.from_numpy(a).to(cuda_device) for a in _case(1, 8, 4, 8))
    with pytest.raises(ValueError, match="k_eq"):
        cs_conv3x3(x.bfloat16(), ext_strips(x.bfloat16()), *w)
