"""The host plan of the tensor-core conv kernels (``tc_plan``), on the CPU.

The bfloat16 forward (#1, and through the same entry point #8, #9, #11,
#12) and dx (#4, #14) kernels launch with the tiles, slices and walks that
``dlwp_cs_tpu_torch.ops.hopper_conv.tc_plan`` computes; the C side
(``csrc/cs_conv3x3_tile.cuh``) recomputes the geometry and refuses a
launch whose shared memory differs.  For every shape that the serving and
training paths, the sharded paths and the kernel tools give these kernels,
the plan must cover each output pixel and channel exactly once, fit the
H100's shared memory per block (232,448 bytes) and, at batch 1, fill at
least one wave of its 132 SMs.  Pure Python: no card, no JAX.
"""

import pytest
import torch

from dlwp_cs_tpu_torch.ops.hopper_conv import (
    dx_plan_args,
    fwd_plan_args,
    tc_blocks,
    tc_geom,
    tc_plan,
    tile_plan,
)

SMS = 132
SMEM = 232448
# (n, Cin, Cout) of the flagship C48 U-Net's 3x3 convs, the n = 96 shape of
# the card's checks, and the kernel tools' (conv_micro's levels,
# kernel_variants' packed and decoder rows)
FLAGSHIP = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
            (12, 128, 128), (24, 192, 64), (48, 96, 32)]
FORWARD = (
    [(b, n, n, cin, cout) for b in (1, 8, 16) for n, cin, cout in FLAGSHIP]
    + [(1, 96, 96, 64, 64), (8, 96, 96, 64, 64)]
    # shards: 4 or 2 row bands, 2 x 2 tiles, at the serving batches
    + [(b, n // s, n, cin, cout) for b in (1, 8) for s in (2, 4) for n, cin, cout in FLAGSHIP]
    + [(b, n // 2, n // 2, cin, cout) for b in (1, 8) for n, cin, cout in FLAGSHIP]
    # conv_micro, kernel_variants (base, packed 4 x 32, the decoder packed 2 x 96)
    + [(16, 48, 48, 32, 32), (16, 24, 24, 64, 64), (16, 12, 12, 128, 128),
       (4, 48, 48, 128, 128), (16, 48, 48, 96, 32), (8, 48, 48, 192, 64),
       (2, 8, 8, 8, 8), (2, 4, 4, 16, 16), (4, 8, 8, 8, 8), (1, 8, 8, 32, 32)]
)
# the dx kernel: the training step's 9 convs (the first one's input is
# data), conv_micro's levels and kernel_variants' (#4 and #14)
DX = ([(16, n, cin, cout) for n, cin, cout in FLAGSHIP[1:]]
      + [(2, 8, 8, 8), (2, 4, 16, 16), (4, 8, 8, 8)])


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _check_cover(plan, b, rows, cols, nch):
    """Every (face, row, channel) of the output in exactly one block's tile."""
    g = plan.geom
    seen = {}
    blocks = tc_blocks(plan, b)
    assert len(blocks) == plan.blocks
    assert all(1 <= len(tiles) <= plan.tpb for tiles in blocks)
    for tiles in blocks:
        keys = {((face % 6) >= 4, n0) for face, _, n0 in tiles}
        assert len(keys) == 1  # one face group and slice: the weights stay staged
        for face, r0, n0 in tiles:
            for r in range(r0, min(r0 + g.h, rows)):
                for c in range(n0, min(n0 + g.cs, nch)):
                    seen[face, r, c] = seen.get((face, r, c), 0) + 1
    assert len(seen) == b * 6 * rows * nch
    assert set(seen.values()) == {1}
    # a tile is h whole rows: the warps along M (32 pixels each) hold them,
    # the warps along N (nw n8 tiles each) the slice
    assert (g.wm - 1) * 32 < g.h * cols <= g.wm * 32
    assert g.wn * g.nw * 8 == g.cs and g.threads == 32 * g.wm * g.wn


@pytest.mark.parametrize("b,rows,cols,cin,cout", FORWARD, ids=_ids(FORWARD))
def test_forward_plan_covers_fits_and_fills(b, rows, cols, cin, cout):
    plan = tc_plan(b, rows, cols, cin, cout, SMS)
    g = plan.geom
    _check_cover(plan, b, rows, cols, cout)
    assert g.smem <= SMEM
    assert g.threads <= 256 and g.threads % 32 == 0
    assert plan.tiles == b * 6 * g.ntr * g.nslices
    if b == 1:
        assert plan.blocks >= SMS, (plan, "a batch-1 grid fills one wave of the SMs")
    # the C side takes exactly these numbers
    assert fwd_plan_args(torch.bfloat16, b, rows, cols, cin, cout, SMS) == plan.args()


@pytest.mark.parametrize("b,n,cin,cout", DX, ids=_ids(DX))
def test_dx_plan_covers_the_frame_and_fits(b, n, cin, cout):
    plan = tc_plan(b, n + 2, n + 2, cout, cin, SMS, dx=True)
    _check_cover(plan, b, n + 2, n + 2, cin)
    assert plan.geom.smem <= SMEM
    assert dx_plan_args(torch.bfloat16, b, n, cin, cout, SMS) == plan.args()


def test_float32_keeps_the_cuda_core_plan():
    """float32 launches the CUDA-core kernels with tile_plan's (h, cs)."""
    for b, n, cin, cout in [(1, 48, 12, 32), (16, 12, 128, 128)]:
        assert fwd_plan_args(torch.float32, b, n, n, cin, cout, SMS) == (
            *tile_plan(b, n, n, cout, SMS), 0, 0, 0)
        h, cs, nw, tpb, smem = dx_plan_args(torch.float32, b, n, cin, cout, SMS)
        assert (nw, tpb, smem) == (0, 0, 0) and cs <= 64


@pytest.mark.parametrize("dx", [False, True])
def test_geometry_counts_shared_memory_as_the_kernel_does(dx):
    """Weights resident (forward: 9 kp rows of cs + pad; dx: cs rows of
    9 kp + 8) and two stages of (h+2) x (W+2) cells of kc + 8 channels."""
    g = tc_geom(12, 12, 64, 128, 5, 32, 4, dx)
    kp, stage = 64, 7 * 14 * 40
    wsize = 32 * (9 * kp + 8) if dx else 9 * kp * 40
    assert (g.kc, g.kp, g.wn, g.wm, g.threads) == (32, kp, 1, 2, 64)
    assert g.smem == 2 * (wsize + 2 * stage)
    assert tc_geom(5, 5, 12, 7, 5, 8, 1, dx).kc == 16  # up to 16 channels: one chunk of 16


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="rows of at most 256"):
        tc_plan(1, 4, 300, 8, 8, SMS)
    with pytest.raises(ValueError, match="cannot hold the weights"):
        tc_plan(1, 48, 48, 1536, 32, SMS)
    with pytest.raises(ValueError):
        tc_geom(8, 8, 8, 8, 1, 24, 1)  # slices of 8, 16, 32 or 64 channels
    with pytest.raises(ValueError):
        tc_geom(8, 200, 8, 64, 2, 64, 1)  # 16 warps
