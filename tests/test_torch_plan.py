"""The host plans of the tensor-core conv kernels (``tc_plan``,
``dw_tc_plan``), on the CPU.

The forward (#1, and through the same entry point #8, #9, #11, #12) and
the dx (#4, #14) kernels launch, in bfloat16 and, as 3xTF32, in float32,
with the tiles, slices and walks that
``dlwp_cs_tpu_torch.ops.hopper_conv.tc_plan`` computes; the dw kernel (#5)
with ``dw_tc_plan``'s.  The C side (``csrc/cs_conv3x3_tile.cuh``,
``csrc/cs_conv3x3_bwd.cu``) recomputes the geometry and refuses a launch
whose shared memory differs.  For every shape that the serving and
training paths, the sharded paths and the kernel tools give these kernels,
the plan must cover each output exactly once, fit the H100's shared memory
per block (232,448 bytes) and, for the forward at batch 1, fill at least
one wave of its 132 SMs.  The float32 kernels' 3xTF32 split and sum orders
are emulated in plain torch against float64.  Pure Python: no card, no
JAX.
"""

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.ops.conv_variants import (
    cs_conv3x3_im2col_plain,
    cs_conv3x3_npack_plain,
    im2col_blocks,
    im2col_plan,
    mma_plan,
    npack_blocks,
    npack_launch,
    npack_plan,
    npack_taps,
    npack_tiles,
)
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    dw_launch_args,
    dw_plan,
    dw_tc_blocks,
    dw_tc_geom,
    dw_tc_plan,
    dx_plan_args,
    fwd_plan_args,
    tc_blocks,
    tc_geom,
    tc_plan,
    tile_plan,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

SMS = 132
SMEM = 232448
_SMEM_TWO_BLOCKS = 233472 // 2 - 1024  # two blocks an SM, 1 KB each reserved
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


@pytest.mark.parametrize("b,n,cin,cout", [(1, 48, 12, 32), (16, 12, 128, 128),
                                          (16, 24, 192, 64), (2, 8, 5, 7)])
def test_float32_backward_routes_to_the_tensor_core_entry_points(b, n, cin, cout):
    """float32's backward runs on the tensor cores: the dx entry points
    take tc_plan's float32 dx plan (4-byte elements), the dw wrapper
    ``cs_conv3x3_dw_launch`` with dw_tc_plan's float32 plan; only the
    CUDA-core timing row takes dw_plan's (rows, nsplit)."""
    plan = tc_plan(b, n + 2, n + 2, cout, cin, SMS, dx=True, esize=4)
    assert dx_plan_args(torch.float32, b, n, cin, cout, SMS) == plan.args()
    assert plan.geom.kp >= 2 * cout and plan.geom.smem > 0 and plan.tpb >= 1
    assert plan.args() != tc_plan(b, n + 2, n + 2, cout, cin, SMS, dx=True).args()
    dw = dw_tc_plan(b, n, cin, cout, SMS, esize=4)
    assert dw.kpx == 8
    assert dw_launch_args(torch.float32, b, n, cin, cout, SMS) == ("cs_conv3x3_dw_launch",
                                                                   dw.args())
    assert dw_launch_args(torch.float32, b, n, cin, cout, SMS, cudacore=True) == (
        "cs_conv3x3_dw_cc_launch", dw_plan(b, n, cin, cout, SMS))


@pytest.mark.parametrize("b,n,cin,cout", DX, ids=_ids(DX))
def test_float32_dx_plan_covers_the_frame_and_fits(b, n, cin, cout):
    """The float32 dx kernel (3xTF32): every frame pixel and Cin channel in
    one tile, the resident float32 weights (9 Cout x cs) and three stages
    within one block's shared memory, at most 4 n8 tiles a warp."""
    plan = tc_plan(b, n + 2, n + 2, cout, cin, SMS, dx=True, esize=4)
    g = plan.geom
    _check_cover(plan, b, n + 2, n + 2, cin)
    assert g.smem <= SMEM - 1024 and g.nw <= 4
    assert g.kp >= 2 * cout and g.kp % g.kc == 0  # whole chunks of f32 channels
    assert dx_plan_args(torch.float32, b, n, cin, cout, SMS) == plan.args()


@pytest.mark.parametrize("b,rows,cols,cin,cout", FORWARD, ids=_ids(FORWARD))
def test_float32_forward_plan_covers_fits_and_fills(b, rows, cols, cin, cout):
    """The float32 forward on the tensor cores: 4-byte values take two
    16-bit units of shared memory, slices of at most 32 channels (at most
    4 n8 tiles a warp), the weights as n x k rows; at batch 1 its fuller
    blocks fill at least 85 % of the SMs (the batch-1 regime aims at 90 %
    of them; at n = 96 a block of one SM walks 5 tiles: 118 blocks)."""
    plan = tc_plan(b, rows, cols, cin, cout, SMS, esize=4)
    g = plan.geom
    _check_cover(plan, b, rows, cols, cout)
    assert g.smem <= SMEM and g.cs <= 32 and g.nw <= 4
    assert g.kp >= 2 * cin and g.kp % g.kc == 0  # whole chunks of f32 channels
    assert plan.tiles == b * 6 * g.ntr * g.nslices
    if b == 1:
        assert plan.blocks >= 0.85 * SMS, (plan, "a batch-1 grid fills 85 % of the SMs")
    assert fwd_plan_args(torch.float32, b, rows, cols, cin, cout, SMS) == plan.args()


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
        tc_plan(1, 48, 48, 1536, 32, SMS, stream=False)  # resident weights
    # the forward then streams them with each chunk; the dx kernel does not
    assert tc_plan(1, 48, 48, 1536, 32, SMS).geom.stream
    with pytest.raises(ValueError, match="resident"):
        tc_plan(1, 48, 48, 1536, 32, SMS, dx=True, stream=True)
    with pytest.raises(ValueError):
        tc_geom(8, 8, 8, 8, 1, 24, 1)  # slices of 8, 16, 32 or 64 channels
    with pytest.raises(ValueError):
        tc_geom(8, 200, 8, 64, 2, 64, 1)  # 16 warps


def test_float32_geometry_counts_units():
    """A float32 channel takes two 16-bit units: 12 channels are 24 units,
    one chunk of 32; the weights are staged as n x (9 kp + 8) units, and
    beside the two stages a third holds the lo halves of the one in use."""
    g = tc_geom(12, 12, 12, 32, 5, 32, 4, esize=4)
    assert (g.kc, g.kp) == (32, 32)
    assert g.smem == 2 * (32 * (9 * 32 + 8) + 3 * 7 * 14 * 40)
    assert tc_geom(12, 12, 192, 32, 5, 8, 1, esize=4).kp == 384
    assert tc_geom(5, 5, 8, 8, 5, 8, 1, esize=4).kc == 16  # 8 channels: one chunk of 16 units
    with pytest.raises(ValueError):
        tc_geom(12, 12, 64, 64, 2, 64, 8, esize=4)  # float32: at most 4 n8 tiles a warp
    # the float32 dx kernel: the weights as n x (9 kp + 8) units as well
    g = tc_geom(14, 14, 64, 64, 2, 32, 4, dx=True, esize=4)
    assert (g.kc, g.kp) == (32, 128)
    assert g.smem == 2 * (32 * (9 * 128 + 8) + 3 * 4 * 16 * 40)


@pytest.mark.parametrize("h,cs,nw", [(14, 32, 4), (5, 16, 2), (1, 8, 1)])
def test_float32_dx_geometry_counts_shared_memory_as_the_kernel_does(h, cs, nw):
    """The float32 dx kernel at (12, 128 -> 128): K = 9 x 128 f32 channels,
    256 units a tap, chunks of 32 units; the weights cs rows of 9 kp + 8
    units, two stages of (h+2) x 16 cells of 40 units and the lo halves of
    one."""
    g = tc_geom(14, 14, 128, 128, h, cs, nw, dx=True, esize=4)
    assert (g.kc, g.kp, g.nslices, g.ntr) == (32, 256, 128 // cs, -(-14 // h))
    assert g.smem == 2 * (cs * (9 * 256 + 8) + 3 * (h + 2) * 16 * 40)


def test_float32_dx_plan_refuses_what_the_kernel_cannot_take():
    """The weights of one 8-channel slice past the shared memory (Cout =
    1024 in float32: 310,400 bytes), 8 n8 tiles a warp, a row of more than
    256 pixels."""
    with pytest.raises(ValueError, match="cannot hold the weights"):
        tc_plan(1, 6, 6, 1024, 8, SMS, dx=True, esize=4)
    with pytest.raises(ValueError):
        tc_geom(14, 14, 64, 64, 2, 64, 8, dx=True, esize=4)
    with pytest.raises(ValueError, match="rows of at most 256"):
        tc_plan(16, 300, 300, 32, 32, SMS, dx=True, esize=4)


# ---- the dw kernel on the tensor cores (#5, bfloat16) ----------------------

DW = [(b, n, cin, cout) for b in (1, 16) for n, cin, cout in FLAGSHIP]


@pytest.mark.parametrize("b,n,cin,cout", DW, ids=_ids(DW))
def test_dw_plan_covers_every_tap_channel_and_pixel_once(b, n, cin, cout):
    """Every (face group, tap, Cin, Cout, pixel) in exactly one block, one
    warp and one k16 step: the blocks of a K slice tile the channels, the
    K slices of a group split its items (batch item, face, row chunk)
    without gap or overlap, the row chunks tile each face, an item's k16
    steps cover its pixels, and a block's warps cover its 9 taps x 16 cig
    Cin x 32 ng Cout channels."""
    plan = dw_tc_plan(b, n, cin, cout, SMS)
    blocks = dw_tc_blocks(plan, b, n, cin, cout)
    assert len(blocks) == 2 * plan.ncib * plan.ncob * plan.nsplit
    ci_w, co_w = 16 * plan.cig, 32 * plan.ng
    by_items = {}
    for grp, ci0, co0, items in blocks:
        by_items.setdefault((grp, tuple(items)), []).append((ci0, co0))
    for grp, nf in ((0, 4), (1, 2)):
        seen_px = {}
        slices = [(items, tiles) for (g, items), tiles in by_items.items() if g == grp]
        for items, tiles in slices:
            seen_ch = {}
            for ci0, co0 in tiles:
                for ci in range(ci0, min(ci0 + ci_w, cin)):
                    for co in range(co0, min(co0 + co_w, cout)):
                        seen_ch[ci, co] = seen_ch.get((ci, co), 0) + 1
            assert len(seen_ch) == cin * cout and set(seen_ch.values()) == {1}
            for face, r0 in items:
                assert (face % 6 >= 4) == (grp == 1)
                for r in range(r0, min(r0 + plan.rows, n)):
                    seen_px[face, r] = seen_px.get((face, r), 0) + 1
        # empty K slices write zeros; the others hold each item once
        assert len(seen_px) == b * nf * n and set(seen_px.values()) == {1}
    assert (plan.steps - 1) * 16 < plan.rows * n <= plan.steps * 16
    warps = {(cg * 16 + c, dy * 3 + dx) for cg in range(plan.cig) for dy in range(3)
             for dx in range(3) for c in range(16)}
    assert len(warps) == 9 * ci_w and plan.threads == 32 * 3 * plan.cig * plan.ng


@pytest.mark.parametrize("b,n,cin,cout", DW, ids=_ids(DW))
def test_dw_plan_fits_and_keeps_its_partials_small(b, n, cin, cout):
    plan = dw_tc_plan(b, n, cin, cout, SMS)
    # two blocks of up to 6 warps on an SM (the kernel's launch bounds)
    assert plan.threads <= 192 and 2 * (plan.smem + 1024) <= 233472
    assert plan.nsplit * 2 * 9 * cin * cout * 4 <= 20 * 2**20
    assert dw_launch_args(torch.bfloat16, b, n, cin, cout, SMS) == (
        "cs_conv3x3_dw_launch", plan.args())
    # the CUDA-core timing row: dw_plan's (rows, nsplit) in either dtype
    assert dw_launch_args(torch.bfloat16, b, n, cin, cout, SMS, cudacore=True) == (
        "cs_conv3x3_dw_cc_launch", dw_plan(b, n, cin, cout, SMS))
    if b == 16:
        assert 2 * plan.ncib * plan.ncob * plan.nsplit >= 2 * SMS  # two blocks per SM


def test_dw_geometry_counts_shared_memory_as_the_kernel_does():
    """Two stages of the (R+2) x (n+2) padded cells of 16 cig + 8 channels
    and 16 x steps dout pixels of 32 ng + 8 channels, in bf16."""
    g = dw_tc_geom(16, 24, 64, 64, 8, 66, 2, 1)
    assert (g.steps, g.ncib, g.ncob, g.threads) == (12, 2, 2, 192)
    assert g.smem == 2 * 2 * (10 * 26 * 40 + 16 * 12 * 40)
    g = dw_tc_geom(1, 10, 3, 9, 10, 1, 1, 1)  # a partial last k16 step
    assert (g.steps, g.ncib, g.ncob, g.threads) == (7, 1, 1, 96)


def test_dw_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        dw_tc_geom(1, 48, 64, 64, 4, 1, 2, 2)  # 12 warps
    with pytest.raises(ValueError):
        dw_tc_geom(1, 8, 8, 8, 9, 1, 1, 1)  # more rows than the face
    with pytest.raises(ValueError):
        dw_tc_geom(1, 8, 8, 8, 8, 65536, 1, 1)  # a grid dimension past 65535
    with pytest.raises(ValueError, match="cannot stage"):
        dw_tc_plan(16, 1000, 64, 64, SMS)


# ---- the dw kernel on the tensor cores in float32 (#5, 3xTF32) -------------

@pytest.mark.parametrize("b,n,cin,cout", DW, ids=_ids(DW))
def test_float32_dw_plan_covers_every_tap_channel_and_pixel_once(b, n, cin, cout):
    """As the bfloat16 plan: every (face group, tap, Cin, Cout, pixel) in
    exactly one block and one k step, the steps now of 8 pixels (TF32 k8)."""
    plan = dw_tc_plan(b, n, cin, cout, SMS, esize=4)
    blocks = dw_tc_blocks(plan, b, n, cin, cout)
    assert len(blocks) == 2 * plan.ncib * plan.ncob * plan.nsplit
    ci_w, co_w = 16 * plan.cig, 32 * plan.ng
    for grp, nf in ((0, 4), (1, 2)):
        seen_px, seen_ch = {}, {}
        for g, ci0, co0, items in blocks:
            if g != grp:
                continue
            for ci in range(ci0, min(ci0 + ci_w, cin)):
                for co in range(co0, min(co0 + co_w, cout)):
                    seen_ch[ci, co, tuple(items)] = seen_ch.get((ci, co, tuple(items)), 0) + 1
            if (ci0, co0) == (0, 0):
                for face, r0 in items:
                    for r in range(r0, min(r0 + plan.rows, n)):
                        seen_px[face, r] = seen_px.get((face, r), 0) + 1
        assert set(seen_ch.values()) == {1}
        assert len(seen_ch) == cin * cout * plan.nsplit
        assert len(seen_px) == b * nf * n and set(seen_px.values()) == {1}
    assert plan.kpx == 8 and (plan.steps - 1) * 8 < plan.rows * n <= plan.steps * 8


@pytest.mark.parametrize("b,n,cin,cout", DW, ids=_ids(DW))
def test_float32_dw_plan_fits_and_keeps_its_partials_small(b, n, cin, cout):
    """Three stage-sized buffers of 4-byte values within one block's shared
    memory, at most 6 warps, partial sums of at most 20 MiB, and at batch
    16 at least one block per SM."""
    plan = dw_tc_plan(b, n, cin, cout, SMS, esize=4)
    assert plan.threads <= 192 and plan.smem + 1024 <= SMEM
    assert plan.nsplit * 2 * 9 * cin * cout * 4 <= 20 * 2**20
    assert dw_launch_args(torch.float32, b, n, cin, cout, SMS) == (
        "cs_conv3x3_dw_launch", plan.args())
    if b == 16:
        assert 2 * plan.ncib * plan.ncob * plan.nsplit >= SMS


@pytest.mark.parametrize("rows,cig,ng", [(8, 2, 1), (3, 1, 2), (12, 1, 1)])
def test_float32_dw_geometry_counts_shared_memory_as_the_kernel_does(rows, cig, ng):
    """Two stages of the (R+2) x (n+2) padded cells of 16 cig + 8 floats and
    8 x steps dout pixels of 32 ng + 8 floats, and a third buffer of the
    same size for the lo halves, at n = 24."""
    g = dw_tc_geom(16, 24, 64, 64, rows, 66, cig, ng, esize=4)
    steps = -(-rows * 24 // 8)
    assert (g.steps, g.kpx, g.threads) == (steps, 8, 96 * cig * ng)
    assert g.smem == 4 * 3 * ((rows + 2) * 26 * (16 * cig + 8) + 8 * steps * (32 * ng + 8))
    # the same geometry in bfloat16: k16 steps, two stages of 2-byte values
    h = dw_tc_geom(16, 24, 64, 64, rows, 66, cig, ng)
    assert h.kpx == 16 and h.smem == 2 * 2 * ((rows + 2) * 26 * (16 * cig + 8)
                                              + 16 * h.steps * (32 * ng + 8))


def test_float32_dw_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        dw_tc_geom(1, 48, 64, 64, 4, 1, 2, 1, esize=8)  # 2- or 4-byte elements
    with pytest.raises(ValueError):
        dw_tc_geom(1, 48, 64, 64, 4, 1, 2, 2, esize=4)  # 12 warps
    with pytest.raises(ValueError, match="cannot stage"):
        dw_tc_plan(16, 600, 32, 8, SMS, esize=4)  # one row of three buffers


# ---- 3xTF32 in plain torch --------------------------------------------------

def _tf32(v):
    """float32 -> TF32 (10 explicit mantissa bits), to nearest, ties away
    from zero (cvt.rna.tf32.f32): round the magnitude bits at bit 13."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_three_tf32_products_hold_float32_accuracy_at_the_flagship_k():
    """The split hi = tf32(v), lo = tf32(v - hi) of both operands, summed as
    lo.hi + hi.lo + hi.hi (lo.lo dropped), against float64 at the
    flagship's largest K (9 x 192) with the U-Net's weight scale; the
    float32 forward's gate is 1e-4 absolute.  One TF32 product alone misses
    it; three stay under float32's own rounding of the sums."""
    rng = np.random.default_rng(0)
    k = 9 * 192
    a = torch.from_numpy(rng.normal(size=(256, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, 64)) / k**0.5).astype(np.float32))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    assert torch.equal(_tf32(ah), ah) and torch.equal(ah + (a - ah), a)
    exact = a.double() @ b.double()
    three = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
    one = ah.double() @ bh.double()
    f32 = a @ b  # float32's own sums
    err3 = float((three - exact).abs().max())
    assert err3 < 1e-6 and err3 <= 4 * float((f32.double() - exact).abs().max())
    assert float((one - exact).abs().max()) > 1e-4
    # the kernel's order: each tap's 192 products summed apart, the taps'
    # sums added in float32
    taps = sum((al[:, t::9].double() @ bh[t::9].double() + ah[:, t::9].double() @ bl[t::9].double()
                + ah[:, t::9].double() @ bh[t::9].double()).float() for t in range(9))
    assert float((taps.double() - exact).abs().max()) < 1e-5


def _three_tf32(a, b):
    """``(hi + lo)(a), (hi + lo)(b)`` in float64 and the lo halves: the
    kernel's lo.hi + hi.lo + hi.hi (each product exact in float64) is
    ``A B - A_lo B_lo`` with ``A = hi + lo`` (exact in float64)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah.double() + al.double(), bh.double() + bl.double(), al.double(), bl.double()


@pytest.mark.parametrize("n,cin,cout", [(48, 12, 32), (12, 128, 128)])
def test_float32_dw_sum_order_holds_float32_accuracy(n, cin, cout):
    """The float32 dw kernel's sums at batch 16, emulated: per item (a
    batch item's face rows of dw_tc_plan), the 3xTF32 products over its
    pixels into fresh sums (summed exactly, rounded once to float32); the
    items of each K slice added in float32 in order; the slices' partials
    reduced by torch.sum in float32.  Against the float64 gradient, within
    1e-5 of the largest entry (the kernel's gate)."""
    b = 16
    plan = dw_tc_plan(b, n, cin, cout, SMS, esize=4)
    rng = np.random.default_rng(n + cin)
    p = torch.from_numpy(rng.normal(size=(b, 6, n + 2, n + 2, cin)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(b, 6, n, n, cout)).astype(np.float32))
    dA, _, dlo, _ = _three_tf32(d, d)
    nchunk = -(-n // plan.rows)
    pad = nchunk * plan.rows - n  # the last item's missing rows: zero dout
    dA = torch.nn.functional.pad(dA, (0, 0, 0, 0, 0, pad))
    dlo = torch.nn.functional.pad(dlo, (0, 0, 0, 0, 0, pad))
    for grp, faces in ((0, slice(0, 4)), (1, slice(4, 6))):
        nf = faces.stop - faces.start
        items = b * nf * nchunk
        bounds = [(items * s // plan.nsplit, items * (s + 1) // plan.nsplit)
                  for s in range(plan.nsplit)]
        dg = dA[:, faces].reshape(items, plan.rows * n, cout)
        dgl = dlo[:, faces].reshape(items, plan.rows * n, cout)
        for dy in range(3):
            for dx in range(3):
                win = p[:, faces, dy : dy + n, dx : dx + n]
                exact = torch.einsum("bfijc,bfijd->cd", win.double(), d[:, faces].double())
                win = torch.nn.functional.pad(win, (0, 0, 0, 0, 0, pad))
                pA, _, plo, _ = _three_tf32(win, win)
                pg = pA.reshape(items, plan.rows * n, cin)
                pgl = plo.reshape(items, plan.rows * n, cin)
                per_item = (pg.transpose(1, 2) @ dg - pgl.transpose(1, 2) @ dgl).float()
                parts = torch.zeros((plan.nsplit, cin, cout))
                for s, (lo, hi) in enumerate(bounds):
                    for it in range(lo, hi):  # in order, in float32
                        parts[s] += per_item[it]
                got = parts.sum(dim=0)
                err = float((got.double() - exact).abs().max())
                assert err <= 1e-5 * float(exact.abs().max()), (grp, dy, dx, err)


def test_float32_dx_sum_order_holds_float32_accuracy_at_k_9x128():
    """The float32 dx kernel's sums, emulated at K = 9 x 128 (the (12, 128
    -> 128) conv): per staged chunk of 16 Cout channels and per tap, the
    3xTF32 products into a fresh sum (summed exactly, rounded once to
    float32), added into the float32 total in the kernel's order (chunk,
    tap).  dout of order 1, the taps at the U-Net's scale: within 1e-4 of
    the float64 sums (the kernel's gate; float32's own sums are 2.3e-6
    off, one TF32 product 1.2e-3)."""
    rng = np.random.default_rng(1)
    cout, cin = 128, 128
    a = torch.from_numpy(rng.normal(size=(256, 9, cout)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(9, cout, cin)) / (9 * cout) ** 0.5).astype(np.float32))
    aA, wA, alo, wlo = _three_tf32(a, w)
    exact = torch.einsum("mtk,tkn->mn", a.double(), w.double())
    acc = torch.zeros((256, cin))
    for c0 in range(0, cout, 16):
        for t in range(9):
            ks = slice(c0, c0 + 16)
            part = aA[:, t, ks] @ wA[t, ks] - alo[:, t, ks] @ wlo[t, ks]
            acc += part.float()
    err = float((acc.double() - exact).abs().max())
    one = float((_tf32(a).double().reshape(256, -1) @ _tf32(w).double().reshape(-1, cin)
                 - exact).abs().max())
    assert err <= 1e-4
    assert one > 1e-4  # one TF32 product alone misses the gate


# ---- the ring kernels (#6, #7) and the probes (#16) ---------------------------

from dlwp_cs_tpu_torch.ops.ring_kernel import grid_roles, ring_blocks, ring_geom, ring_plan  # noqa: E402
from dlwp_cs_tpu_torch.tools.probes import (  # noqa: E402
    conv_geom,
    conv_plan,
    dw_slices,
    dw_split,
    lane_store_geom,
)

# (b, n, Cin, D) of the ring phase of chip_smoke.py (the flagship U-Net's
# conv shapes and the ConvLSTM's two gate convs at batch 1 and 16) and of
# tests/test_torch_cuda.py::RING_SHAPES
RING = (
    [(b, n, cin, d) for b in (1, 16) for n, cin, d in
     sorted(set(FLAGSHIP), key=FLAGSHIP.index) + [(48, 39, 128), (48, 64, 128)]]
    + [(1, 48, 39, 128), (16, 48, 64, 128), (1, 12, 128, 128), (2, 10, 3, 9),
       (2, 20, 5, 12), (1, 6, 4, 8)]
)
RING = sorted(set(RING), key=RING.index)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,d", RING, ids=_ids(RING))
def test_ring_plan_covers_every_pixel_once_and_fits(dtype, b, n, cin, d):
    """The fused apply's launch: every (face, pixel, channel) of the output
    written by exactly one block - the ring blocks' lines and the copy
    blocks' interiors - except the corners, which both of their ring blocks
    (one S/N, one W/E) publish and the second to arrive writes; the ring
    blocks' D slices tile D; the block fits the card's shared memory, two
    to an SM where any plan does."""
    g = ring_plan(getattr(torch, dtype), b, n, cin, d, SMS)
    assert g.smem <= SMEM and g.dn % 16 == 0 and 1 <= g.spb <= 8
    esize = 4 if dtype == "float32" else 2
    two = (228 * 1024) // 2 - 1024  # two blocks an SM (1 KB each reserved)

    def smem(dn):
        try:
            return ring_geom(esize, b, n, cin, d, 1, dn, g.ncopy).smem
        except ValueError:
            return SMEM + 1

    if any(smem(dn) <= two for dn in (16, 32, 64, 128) if dn < d + 16):
        assert g.smem <= two
    slices = sorted({(r * g.dn, min((r + 1) * g.dn, d)) for r in range(g.nsplit)})
    assert slices[0][0] == 0 and slices[-1][1] == d
    assert all(a[1] == b_[0] for a, b_ in zip(slices, slices[1:]))
    index = {s: k for k, s in enumerate(slices)}
    count = np.zeros((b * 6, n, n, len(slices)), np.int32)
    roles = grid_roles(g)
    assert sorted(roles) == sorted([("ring", r) for r in range(g.nring)]
                                   + [("copy", q) for q in range(g.ncopy)])
    blocks = ring_blocks(g)
    assert len(blocks) == g.nring + g.ncopy
    for (kind, _), runs in zip(roles, blocks):
        for face, i, j, d0, d1 in runs:
            if kind == "copy":
                assert (d0, d1) == (0, d) and 0 < i < n - 1 and 0 < j < n - 1
                count[face, i, j] += 1
            else:
                count[face, i, j, index[d0, d1]] += 1
    corner = np.zeros((n, n), bool)
    corner[[0, 0, n - 1, n - 1], [0, n - 1, 0, n - 1]] = True
    assert (count[:, corner] == 2).all() and (count[:, ~corner] == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,cin,d", RING, ids=_ids(RING))
def test_ring_fixes_plan_covers_every_fix_and_corner_once(dtype, b, n, cin, d):
    """The fixes' launch (ring blocks only): every fix (face, edge,
    position, channel) and every corner (face, corner, channel) once; no
    copy blocks."""
    g = ring_plan(getattr(torch, dtype), b, n, cin, d, SMS, apply=False)
    assert g.ncopy == 0 and g.smem <= SMEM
    fix = np.zeros((b * 6, 4, n, d), np.int32)
    cor = np.zeros((b * 6, 4, d), np.int32)
    for runs in ring_blocks(g, apply=False):
        for run in runs:
            if run[0] == "fix":
                _, face, e, t, d0, d1 = run
                fix[face, e, t, d0:d1] += 1
            else:
                _, face, c, d0, d1 = run
                cor[face, c, d0:d1] += 1
    assert (fix == 1).all() and (cor == 1).all()


def test_ring_geometry_counts_shared_memory_as_the_kernel_does():
    """csrc/cs_ring.cu::make_ring_geom's numbers at the bf16 gate conv
    (48, 64 -> 128), one strip, a 32-channel slice: taps 3 x 64 rows of 40
    units, staged cells (48 + 6 + 1 zero) x 72 units, and for the fused
    apply the 48 base rows of 40 elements and 2 flags."""
    g = ring_geom(2, 1, 48, 64, 128, 1, 32, 264)
    assert (g.cp, g.kpe, g.nsplit, g.nch, g.nring) == (72, 64, 4, (4, 2), 96)
    assert g.smem == 3 * 64 * 40 * 2 + 2 * (54 + 1) * 72 + 48 * 40 * 2 + 8
    f = ring_geom(4, 1, 48, 39, 128, 1, 32, 0, apply=False)
    # float32: 44 channels a cell (an odd multiple of 16 bytes), K = 40 a
    # tap; 39 channels are 156 bytes, not a multiple of 16, so the strip
    # also lands raw (50 x 156 bytes in 16-byte copies from the boundary
    # before it) and is repacked into its cells
    assert (f.cp, f.kpe) == (88, 40)
    assert f.smem == 3 * 40 * 40 * 4 + 2 * (54 + 1) * 88 + 7808 + 16
    with pytest.raises(ValueError):
        ring_geom(2, 1, 48, 64, 128, 9, 32, 264)  # at most 8 strips a block
    with pytest.raises(ValueError):
        ring_geom(2, 1, 48, 64, 128, 1, 24, 264)  # slices of 16 channels
    with pytest.raises(ValueError):
        ring_geom(2, 1, 48, 64, 128, 1, 32, 0)  # the fused apply needs copy blocks


def _three_tf32_mm(a, b):
    """a @ b as the kernel's 3xTF32 products: exact in float64, less lo.lo."""
    aA, bA, alo, blo = _three_tf32(a, b)
    return aA @ bA - alo @ blo


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("n,cin,d", [(48, 39, 128), (48, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_fix_sum_order_holds_the_gates(dtype, n, cin, d, b):
    """The ring blocks' sums at the ConvLSTM's gate convs, emulated: each
    ring row's window (3 positions x Cin) times its edge's taps, float32 as
    3xTF32 with each tap's products into a fresh sum (exact, rounded once to
    float32) added in tap order, bfloat16 as one float32 sum of exact
    products; the corner dots the same rows with the window [P0, 0, 0] or
    [0, 0, P(n+1)]; then the fused apply's lines base + fix and corners
    ((base + S|N fix) + W|E fix) - corner in float32, rounded once.
    Against the float64 sums, within the card's gates (float32 1e-4
    absolute; bfloat16 2**-7 |ref| + 1e-4)."""
    rng = np.random.default_rng(n + cin + b)
    tdt = getattr(torch, dtype)
    ext = torch.from_numpy(rng.normal(size=(b, 6, 4, n + 2, cin)).astype(np.float32)).to(tdt)
    ks = [torch.from_numpy((rng.normal(size=(3, 3, cin, d)) / (9 * cin) ** 0.5)
                           .astype(np.float32)).to(tdt) for _ in range(2)]
    base = torch.from_numpy(rng.normal(size=(b, 6, n, n, d)).astype(np.float32)).to(tdt)
    taps = lambda k: torch.stack([k[0], k[2], k[:, 0], k[:, 2]])  # noqa: E731  [S, N, W, E]
    fix32, fix64 = [], []
    for faces, k in ((slice(0, 4), ks[0]), (slice(4, 6), ks[1])):
        e = ext[:, faces].float()
        t = taps(k).float()  # (4, 3, Cin, D)
        win = torch.stack([e[..., dy:dy + n, :] for dy in range(3)], dim=-2)  # (b,F,4,n,3,C)
        exact = torch.einsum("bfetyc,eycd->bfetd", win.double(), t.double())
        if dtype == "float32":
            acc = torch.zeros(exact.shape, dtype=torch.float32)
            for dy in range(3):  # fresh sums per tap, added in order
                for edge in range(4):
                    part = _three_tf32_mm(win[:, :, edge, :, dy].reshape(-1, cin), t[edge, dy])
                    acc[:, :, edge] += part.float().reshape(acc[:, :, edge].shape)
        else:
            acc = exact.float()
        fix32.append(acc)
        fix64.append(exact)
    fix32, fix64 = torch.cat(fix32, 1), torch.cat(fix64, 1)  # (b, 6, 4, n, D)
    err = float((fix32.double() - fix64).abs().max())
    assert err <= 1e-4, err
    # the corner dots: the S/N rows [P0, 0, 0] and [0, 0, P(n+1)]
    cor64 = torch.cat([torch.einsum("bfqc,qcd->bfqd", torch.stack(
        [ext[:, faces, 0, 0], ext[:, faces, 0, n + 1], ext[:, faces, 1, 0],
         ext[:, faces, 1, n + 1]], 2).double(),
        torch.stack([k[0, 0], k[0, 2], k[2, 0], k[2, 2]]).double())
        for faces, k in ((slice(0, 4), ks[0]), (slice(4, 6), ks[1]))], 1)
    out = base.float().clone()
    ref = base.double().clone()
    for o, f, c in ((out, fix32, None), (ref, fix64, cor64)):
        c = c if c is not None else cor64.float()
        o[:, :, 0] += f[:, :, 0]
        o[:, :, n - 1] += f[:, :, 1]
        o[:, :, 1:n - 1, 0] += f[:, :, 2, 1:n - 1]
        o[:, :, 1:n - 1, n - 1] += f[:, :, 3, 1:n - 1]
        for ci, (i, j, e2, t2) in enumerate(((0, 0, 2, 0), (0, n - 1, 3, 0), (n - 1, 0, 2, n - 1),
                                             (n - 1, n - 1, 3, n - 1))):
            o[:, :, i, j] += f[:, :, e2, t2]
            o[:, :, i, j] -= c[:, :, ci]
    got = out.to(tdt).double()
    if dtype == "float32":
        assert float((got - ref).abs().max()) <= 1e-4
    else:
        assert float(((got - ref).abs() - ref.abs() * 2.0**-7).max()) <= 1e-4


PROBE_DW = [(48, 32, 64), (24, 64, 64), (12, 128, 128), (8, 8, 16), (4, 16, 16)]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,c,d", PROBE_DW, ids=_ids(PROBE_DW))
def test_dw_probe_slices_cover_every_pixel_once_in_order(n, c, d, batched):
    """#16's dw probes: the K slices of ``dw_split`` hold every pixel once,
    k1's as runs of at most 64 consecutive pixels in order, k2's as whole
    columns (rows in order); the slices fill about one wave of the card."""
    nsplit = dw_split(n, c, d, batched, SMS)
    tiles = -(-c // 32) * -(-d // 64)
    assert 1 <= nsplit and tiles * nsplit <= max(SMS, tiles)
    chunks = [ch for sl in dw_slices(n, nsplit, batched) for ch in sl]
    flat = [p for ch in chunks for p in ch]
    assert sorted(flat) == list(range(n * n))
    if batched:
        assert all(ch == [i * n + ch[0] for i in range(n)] for ch in chunks)
    else:
        assert flat == list(range(n * n)) and all(len(ch) <= 64 for ch in chunks)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,c,d", PROBE_DW[:3], ids=_ids(PROBE_DW[:3]))
def test_float32_dw_probe_sum_order_holds_the_gate(n, c, d, batched):
    """The float32 dw probes' sums, emulated: each chunk's 3xTF32 products
    into a fresh sum (exact, rounded once to float32; k2: a column), the
    chunks of a slice added in float32 in order, the slices' partials summed
    in float32 (torch.sum): within the probe tool's 1e-5 of the largest
    entry of the float64 product."""
    rng = np.random.default_rng(n + c)
    x = torch.from_numpy(rng.normal(size=(n * n, c)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n * n, d)).astype(np.float32))
    exact = x.double().T @ g.double()
    parts = []
    for sl in dw_slices(n, dw_split(n, c, d, batched, SMS), batched):
        acc = torch.zeros((c, d))
        for ch in sl:
            acc += _three_tf32_mm(x[ch].T.contiguous(), g[ch]).float()
        parts.append(acc)
    got = torch.stack(parts).sum(0)
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("n,c,d", [(48, 64, 64), (8, 8, 8), (8, 8, 16)])
def test_probe_conv_plan_fits_and_covers(dtype, shifted, n, c, d):
    """#16's dot and shifted-dots kernel: the plan's blocks (h face rows x
    dn channels) tile the output, fit the card's shared memory, and its
    geometry counts shared memory as ``make_conv_geom`` does: the taps
    (ntaps x Cin rounded to a k step, rows of dn + 8), the staged cells
    (h rows, or h + 2 framed rows of n + 2 pixels, + 1 zero cell)."""
    g = conv_plan(getattr(torch, dtype), shifted, n, c, d, SMS)
    esize = 4 if dtype == "float32" else 2
    assert g.smem <= SMEM and g.dn % 16 == 0 and 1 <= g.h <= n
    assert -(-n // g.h) * g.h >= n and -(-d // g.dn) * g.dn >= d
    cells = (g.h + 2) * (n + 2) if shifted else g.h * n
    assert g.smem == (9 if shifted else 1) * g.kpe * (g.dn + 8) * esize + 2 * (cells + 1) * g.cp
    assert g == conv_geom(esize, shifted, n, c, d, g.h, g.dn)
    assert (g.cp // 8) % 2 == 1 and g.cp * 2 >= c * esize


def test_ring_phase_tool_switches_guard_the_kernel_source():
    """``tools/ring_phases.py`` compiles variants of ``csrc/cs_ring.cu``
    with phases switched off: every switch's anchor is in the source once
    and each variant defines every switch."""
    from dlwp_cs_tpu_torch.tools import ring_phases

    for name, switches in ring_phases.VARIANTS.items():
        src = ring_phases.patched_source(switches)
        for s in ring_phases.SWITCHES:
            assert f"#define {s} {int(s in switches)}\n" in src, (name, s)
            assert src.count(f"{s}") >= 2, (name, s)



def test_phase_tools_refuse_an_anchor_not_in_the_source_once():
    """``tools/phases.py`` patches a guard only where its anchor is in the
    source exactly once (an anchor that drifted would guard nothing)."""
    from dlwp_cs_tpu_torch.ops.ring_kernel import _RING_LIB
    from dlwp_cs_tpu_torch.tools import phases

    with pytest.raises(RuntimeError, match="an anchor of NO_X is not in cs_ring.cu once"):
        phases.patched_source(_RING_LIB, {"NO_X": [("no such text", "")]}, ("NO_X",), ())
    twice = "__syncthreads();"
    assert _RING_LIB.source.read_text().count(twice) > 1
    with pytest.raises(RuntimeError, match="NO_Y"):
        phases.patched_source(_RING_LIB, {"NO_Y": [(twice, "")]}, ("NO_Y",), ("NO_Y",))
    src = phases.patched_source(_RING_LIB, {}, ("NO_A", "NO_B"), ("NO_B",))
    assert src.startswith("#define NO_A 0\n#define NO_B 1\n")


# ---- #13: the im2col GEMM kernel's tiles and its column gather --------------

IM2COL = ([(b, n, cin, cout) for b in (1, 16) for n, cin, cout in FLAGSHIP]
          + [(4, 48, 128, 128), (1, 48, 64, 256), (1, 48, 32, 256), (1, 96, 64, 64),
             (1, 10, 5, 7), (2, 8, 12, 16)])


@pytest.mark.parametrize("b,n,cin,cout", IM2COL, ids=_ids(IM2COL))
def test_im2col_plan_covers_every_pixel_of_both_groups_once(b, n, cin, cout):
    """#13's blocks, as the kernel decodes them (N tiles fastest, then the
    equatorial group's M tiles, then the polar group's): every output pixel
    and channel in exactly one block, each block's pixels of one weight
    group; the tiles fit the card's shared memory two to an SM; at batch 1
    the plan takes the configuration with the most blocks, at batch 16 the
    largest tile that still fills a wave."""
    plan = im2col_plan(b, n, cin, cout, SMS)
    seen = np.zeros((b * 6 * n * n, cout), dtype=np.int32)
    blocks = im2col_blocks(plan, b, n, cout)
    assert len(blocks) == plan.blocks
    for grp, pixels, (c0, c1) in blocks:
        faces = (np.asarray(pixels) // (n * n)) % 6
        assert ((faces >= 4) == bool(grp)).all() and 0 < len(pixels) <= plan.bm
        assert 0 <= c0 < c1 <= min(c0 + plan.bn, cout)
        seen[pixels, c0:c1] += 1
    assert (seen == 1).all()
    # K windows: whole taps, or equal 16-channel slices of one tap
    kp = -(-cin // 16) * 16
    assert plan.bks % 16 == 0 and plan.tpw * plan.bks <= (256 if plan.kg > 1 else 128)
    assert plan.nsl * plan.bks >= kp > (plan.nsl - 1) * plan.bks
    assert plan.tpw == 1 or plan.bks == kp
    assert plan.nwin == -(-9 // plan.tpw) * plan.nsl
    assert plan.threads == 256 and plan.smem <= SMEM
    if plan.kg == 1:  # many tiles: 128 pixels, two blocks an SM
        assert plan.bm == 128 and plan.blocks >= SMS and plan.smem <= _SMEM_TWO_BLOCKS
    else:  # few tiles (batch 1): 64 pixels, every block resident at once
        assert plan.bm == 64 and plan.smem <= 233472 // -(-plan.blocks // SMS) - 1024
    if b == 16 and n >= 24:
        assert plan.kg == 1


def _cell_offset(face, n, cin, p, pc, ext_base):
    """The flat offset of padded cell (p, pc) of ``face`` in x followed by
    the ghost strips, as ``csrc/cs_conv3x3_mma.cu::cell_ptr`` addresses it."""
    m = n + 2
    e = ext_base + face * 4 * m * cin
    if p == 0:
        return e + pc * cin
    if p == n + 1:
        return e + (m + pc) * cin
    if pc == 0:
        return e + (2 * m + p) * cin
    if pc == n + 1:
        return e + (3 * m + p) * cin
    return face * n * n * cin + ((p - 1) * n + pc - 1) * cin


def _im2col_gemm_emulated(x, ext, w_eq, w_pole, b_eq, b_pole, plan):
    """The im2col GEMM kernel's index arithmetic in plain torch: per block
    the rows of its M tile decoded to pixels, per K window (taps t0 ..
    t0 + ntw - 1, channels c0 .. c0 + wd of each) the rows' cell runs
    gathered from the flat x and ghost strips side by side (channels past
    Cin zero) and the weight rows t * Cin + c0 .. (past Cin zero), the
    window products summed, the bias added, the rows written back through
    their flat output offsets."""
    b, _, n, _, cin = x.shape
    cout = w_eq.shape[1]
    src = torch.cat([x.reshape(-1), ext.reshape(-1)])
    ext_base = x.numel()
    kp = -(-cin // 16) * 16
    out = torch.full((b * 6 * n * n * cout,), float("nan"), dtype=x.dtype)
    for bid in range(plan.blocks):
        nti, mti = bid % plan.nt, bid // plan.nt
        grp = 0 if mti < plan.mt[0] else 1
        nf, f0 = (2, 4) if grp else (4, 0)
        m0 = (mti - plan.mt[0] if grp else mti) * plan.bm
        n0 = nti * plan.bn
        w, bias = (w_pole, b_pole) if grp else (w_eq, b_eq)
        rows = []
        for r in range(plan.bm):
            m = m0 + r
            if m >= b * nf * n * n:
                break
            item, rem = divmod(m, nf * n * n)
            fl, pix = divmod(rem, n * n)
            rows.append((item * 6 + f0 + fl, *divmod(pix, n)))
        acc = torch.zeros((plan.bm, plan.bn), dtype=x.dtype)
        ncols = min(plan.bn, cout - n0)
        for q in range(plan.nwin):
            tg = q // plan.nsl
            t0, c0 = tg * plan.tpw, (q - tg * plan.nsl) * plan.bks
            ntw, wd = min(plan.tpw, 9 - t0), min(plan.bks, kp - c0)
            avail = max(0, min(wd, cin - c0))
            a = torch.zeros((plan.bm, ntw * wd), dtype=x.dtype)
            bm = torch.zeros((ntw * wd, plan.bn), dtype=x.dtype)
            for tt in range(ntw):
                t = t0 + tt
                dy, dx = divmod(t, 3)
                for r, (face, i, j) in enumerate(rows):
                    off = _cell_offset(face, n, cin, i + dy, j + dx, ext_base) + c0
                    a[r, tt * wd : tt * wd + avail] = src[off : off + avail]
                rw = t * cin + c0
                bm[tt * wd : tt * wd + avail, :ncols] = w[rw : rw + avail, n0 : n0 + ncols]
            acc += a @ bm
        for r, (face, i, j) in enumerate(rows):
            o = ((face * n + i) * n + j) * cout + n0
            out[o : o + ncols] = acc[r, :ncols] + bias[n0 : n0 + ncols]
    return out.reshape(b, 6, n, n, cout)


@pytest.mark.parametrize("sms", [SMS, 4])
@pytest.mark.parametrize("b,n,cin,cout", [(2, 8, 12, 16), (1, 10, 5, 7), (1, 6, 39, 40),
                                          (2, 4, 80, 24), (1, 8, 96, 70), (1, 4, 200, 16)])
def test_im2col_gather_emulation_reproduces_the_plain_version(sms, b, n, cin, cout):
    """The windowed column gather of #13 (several taps a window, odd Cin,
    slices of a tap, ragged N tiles; the small card's plan takes the
    single-group tiles) against
    ``cs_conv3x3_im2col_plain`` in float64: the same map to rounding."""
    rng = np.random.default_rng(b * 100 + n + cin)
    x = torch.from_numpy(rng.normal(size=(b, 6, n, n, cin)))
    ws = [torch.from_numpy(rng.normal(size=(9 * cin, cout))) for _ in range(2)]
    bs = [torch.from_numpy(rng.normal(size=(cout,))) for _ in range(2)]
    ext = ext_strips(x)
    plan = im2col_plan(b, n, cin, cout, sms)
    got = _im2col_gemm_emulated(x, ext, *ws, *bs, plan)
    ref = cs_conv3x3_im2col_plain(x, ext, *ws, *bs)
    assert ref.dtype == torch.float64
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)


# ---- #3: the kn2row tile kernel's tiles and its shifted adds ----------------

NPACK = ([(b, n, cin, cout) for b in (1, 16) for n, cin, cout in FLAGSHIP]
         + [(1, 48, 128, 128), (4, 48, 128, 128), (1, 48, 64, 256), (1, 48, 32, 256),
            (1, 96, 64, 64), (1, 10, 5, 7), (2, 8, 12, 16), (2, 12, 39, 40)])


@pytest.mark.parametrize("b,n,cin,cout", NPACK, ids=_ids(NPACK))
def test_npack_plan_covers_every_output_once(b, n, cin, cout):
    """#3's tiles, as the kernel decodes its blocks: every output row and
    channel of a face in exactly one block; the block fits the card's shared
    memory (two to an SM at the flagship shapes), its output units fit the
    registers (4 a thread of 256); the staged cells reach every product row
    the shifted adds read; where some tile's grid is resident on the card at
    once (two blocks an SM where shared memory allows), the plan's is, with
    the most blocks of those of its channel width; else its block fits two
    to an SM where some tile's does."""
    plan = npack_plan(b, n, cin, cout, SMS)
    seen = np.zeros((n, cout), dtype=np.int32)
    blocks = npack_blocks(plan, n, cout)
    assert len(blocks) == plan.rt * plan.ct and plan.blocks == len(blocks) * 6 * b
    for (r0, r1), (c0, c1) in blocks:
        assert 0 <= r0 < r1 <= r0 + plan.h and 0 <= c0 < c1 <= c0 + plan.bn
        seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    assert plan.smem <= SMEM and plan.bn % 8 == 0
    assert plan.h * n * plan.bn // 8 <= 4 * 256
    assert plan.cells == (plan.h + 2) * (n + 2)
    # the last output (h - 1, n - 1) reads product row (h - 1)(n + 2) + n + 1,
    # which is cell 2(n + 2) + that at dy = 2
    last = (plan.h - 1) * (n + 2) + n + 1
    assert last < 16 * plan.mt and 2 * (n + 2) + last < plan.cells
    if (n, cin, cout) in FLAGSHIP:
        assert plan.smem <= _SMEM_TWO_BLOCKS and plan.wbufs == 2 and plan.bn >= 16
    same = [p for p in npack_tiles(b, n, cin, cout) if p.bn * p.ct == plan.bn * plan.ct]

    def resident(p):
        return p.blocks <= SMS * (2 if p.smem <= _SMEM_TWO_BLOCKS else 1)

    if any(resident(p) for p in same):
        assert resident(plan)
        assert plan.blocks == max(p.blocks for p in same if resident(p) and p.bn == plan.bn)
    elif any(p.smem <= _SMEM_TWO_BLOCKS for p in same):
        assert plan.smem <= _SMEM_TWO_BLOCKS


def test_npack_plan_takes_every_shape_the_first_design_takes():
    """Every shape of a grid of n, Cin and Cout that the first design's plan
    (``mma_plan("npack")``) takes, the tile kernel's plan takes too (Cout <
    8 with Cin >= 256 among them, where a tile's three dx runs of Cout
    channels side by side keep its weights as small as v1's); and the tile
    kernel plans (48, 128 -> 128) and Cout = 256 at n = 48, where v1
    refuses."""
    ns = (1, 2, 3, 6, 8, 10, 12, 14, 16, 24, 30, 46, 48, 62, 64, 96, 126, 128, 192)
    cs = (1, 3, 5, 8, 12, 16, 24, 32, 39, 48, 64, 96, 128, 160, 192, 256, 384, 512, 1024)
    v1_only = []
    for n in ns:
        for cin in cs:
            for cout in cs:
                try:
                    mma_plan("npack", 1, n, cin, cout, SMS)
                except ValueError:
                    continue
                try:
                    npack_plan(1, n, cin, cout, SMS)
                except ValueError:
                    v1_only.append((n, cin, cout))
    assert not v1_only, v1_only
    for n, cin, cout in ((30, 1024, 1), (62, 512, 3), (126, 256, 5)):
        plan = npack_plan(1, n, cin, cout, SMS)
        assert plan.bn == 8 and plan.sw == cout
    for n, cin, cout in ((48, 128, 128), (48, 64, 256), (48, 32, 256)):
        with pytest.raises(ValueError):
            mma_plan("npack", 1, n, cin, cout, SMS)
        npack_plan(1, n, cin, cout, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        npack_plan(1, 48, 4096, 512, SMS)


def _npack_tiles_emulated(x, ext, t_eq, t_pole, b_eq, b_pole, plan):
    """The kn2row tile kernel's index arithmetic in plain torch: per block
    the tile's cells (padded rows r0 .. r0 + h + 1 as one run of cells,
    zero past the face and past Cin), per dy the product of the cells dy (n
    + 2) .. dy (n + 2) + 16 mt - 1 (past the staged cells: the last one)
    with the dy slice's three sw-channel runs side by side (zero past Cin
    and Cout), then
    for each output (i, j) the product rows i (n + 2) + j + dx of the dx
    run, added in the order dy, dx; bias; the tile's rows and channels
    written."""
    from dlwp_cs_tpu_torch.ops.hopper_conv import _padded_faces

    b, _, n, _, cin = x.shape
    cout = t_eq.shape[1] // 9
    np2, kp, h, sw = n + 2, -(-cin // 16) * 16, plan.h, plan.sw
    nw = -(-(3 * sw) // 8) * 8
    pad = torch.zeros((b, 6, n + 2 + h + 2, np2, kp), dtype=x.dtype)
    pad[:, :, :np2, :, :cin] = _padded_faces(x, ext)
    out = torch.full((b, 6, n, n, cout), float("nan"), dtype=x.dtype)
    for (r0, r1), (c0, c1) in npack_blocks(plan, n, cout):
        cells = pad[:, :, r0 : r0 + h + 2].reshape(b, 6, -1, kp)
        assert cells.shape[2] == plan.cells
        rows = torch.arange(16 * plan.mt)
        o = torch.zeros((b, 6, h, n, sw), dtype=x.dtype)
        for dy in range(3):
            a = cells[:, :, torch.clamp(dy * np2 + rows, max=plan.cells - 1)]
            for g, (taps, faces) in enumerate(((t_eq, slice(0, 4)), (t_pole, slice(4, 6)))):
                w = torch.zeros((kp, nw), dtype=x.dtype)
                for dx in range(3):
                    cc = min(c1, cout) - c0
                    col = (3 * dy + dx) * cout + c0
                    w[:cin, dx * sw : dx * sw + cc] = taps[:, col : col + cc]
                prod = a[:, faces] @ w
                for i in range(h):
                    for dx in range(3):
                        m = i * np2 + dx + torch.arange(n)
                        o[:, faces, i] += prod[:, :, m, dx * sw : (dx + 1) * sw]
        for g, (bias, faces) in enumerate(((b_eq, slice(0, 4)), (b_pole, slice(4, 6)))):
            out[:, faces, r0:r1, :, c0:c1] = (o[:, faces, : r1 - r0, :, : c1 - c0]
                                              + bias[c0:c1])
    return out


@pytest.mark.parametrize("tile", [None, (1, 8, 1), (3, 16, 2), (2, 32, 1)])
@pytest.mark.parametrize("b,n,cin,cout", [(2, 8, 12, 16), (1, 10, 5, 7), (1, 6, 39, 40),
                                          (1, 7, 24, 24), (1, 9, 20, 3), (1, 6, 16, 12)])
def test_npack_tile_emulation_reproduces_the_plain_version(tile, b, n, cin, cout):
    """The tile kernel's cells, M rows across padded rows, clamped reads
    past the cells, channel runs and shifted adds (ragged row and channel
    tiles, odd Cin, 8-channel runs, runs of Cout channels where Cout is
    narrower than the tile), at the plan's tile and at forced ones,
    against ``cs_conv3x3_npack_plain`` in float64: the same map to
    rounding."""
    rng = np.random.default_rng(b * 100 + n + cin)
    x = torch.from_numpy(rng.normal(size=(b, 6, n, n, cin)))
    ts = [npack_taps(torch.from_numpy(rng.normal(size=(3, 3, cin, cout)))) for _ in range(2)]
    bs = [torch.from_numpy(rng.normal(size=(cout,))) for _ in range(2)]
    ext = ext_strips(x)
    plan = npack_plan(b, n, cin, cout, SMS) if tile is None else npack_launch(
        b, n, cin, cout, *tile)
    got = _npack_tiles_emulated(x, ext, *ts, *bs, plan)
    ref = cs_conv3x3_npack_plain(x, ext, *ts, *bs)
    assert ref.dtype == torch.float64
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)


def test_npack_phase_tool_switches_guard_the_kernel_source():
    """``tools/npack_phases.py`` compiles variants of
    ``csrc/cs_conv3x3_mma.cu`` with phases of #3 switched off: every
    switch's anchor is in the source once and each variant defines every
    switch."""
    from dlwp_cs_tpu_torch.tools import npack_phases

    for name, switches in npack_phases.VARIANTS.items():
        src = npack_phases.patched_source(switches)
        for sw in npack_phases.SWITCHES:
            assert f"#define {sw} {int(sw in switches)}\n" in src, (name, sw)
            assert src.count(sw) >= 2, (name, sw)


# ---- #15: the lane store's tiles --------------------------------------------

LANE = [(16 * 6 * 48 * 48, 32, 2), (16 * 6 * 48 * 48, 32, 4), (2 * 6 * 48 * 48, 39, 2),
        (3 * 6 * 24 * 24, 3, 4), (6 * 7 * 7, 24, 2), (6 * 7 * 7, 24, 4), (2 * 6 * 8 * 8, 5, 4),
        (6 * 12 * 12, 128, 4), (1, 512, 4)]


@pytest.mark.parametrize("npix,c,esize", LANE, ids=_ids(LANE))
def test_lane_store_tiles_cover_every_item_once(npix, c, esize):
    """#15's launch: 16-byte items exactly where C's bytes allow; each
    thread's (pixel, item) pairs, advanced by the kernel's constant step,
    equal the division of its flat item index; over the tiles every item
    of every pixel is moved once, within the tile's pixels; the tile's
    scratch rows (3C a pixel) fit the shared memory; the grid is at most
    the tiles and at least one block an SM where there are enough tiles."""
    vec = (c * esize) % 16 == 0
    g = lane_store_geom(esize, npix, c, vec, SMS)
    u = c * esize // 16 if vec else c
    items_per_thread = 4 if vec else 8
    assert (g.vec, g.u) == (vec, u)
    assert g.p * u <= items_per_thread * 256 < (g.p + 1) * u
    assert g.smem == 3 * g.p * u * (16 if vec else esize) <= SMEM
    assert g.ntiles == -(-npix // g.p) and 1 <= g.grid <= g.ntiles
    assert g.grid == g.ntiles or g.grid >= SMS
    tid = np.arange(256)
    dq, dv = 256 // u, 256 % u
    qq, vv = tid // u, tid % u
    idx, q = [], []
    for j in range(items_per_thread):
        flat = tid + j * 256
        assert (qq == flat // u).all() and (vv == flat % u).all()
        idx.append(flat)
        q.append(qq.copy())
        qq, vv = qq + dq, vv + dv
        qq, vv = np.where(vv >= u, qq + 1, qq), np.where(vv >= u, vv - u, vv)
    idx, q = np.stack(idx).ravel(), np.stack(q).ravel()
    seen = np.zeros(npix * u, dtype=np.int32)
    for t in range(g.ntiles):
        items = t * g.p * u + idx
        keep = (q < g.p) & (items < npix * u)
        seen[items[keep]] += 1
    assert (seen == 1).all()


def test_lane_store_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="wider than a tile"):
        lane_store_geom(2, 4, 4096, False, SMS)
    with pytest.raises(ValueError, match="vec"):
        lane_store_geom(2, 4, 12, True, SMS)


def test_im2col_phase_tool_switches_guard_the_kernel_source():
    """``tools/im2col_phases.py`` compiles variants of
    ``csrc/cs_conv3x3_mma.cu`` with phases of #13 switched off: every
    switch's anchor is in the source once and each variant defines every
    switch."""
    from dlwp_cs_tpu_torch.tools import im2col_phases

    for name, switches in im2col_phases.VARIANTS.items():
        src = im2col_phases.patched_source(switches)
        for s in im2col_phases.SWITCHES:
            assert f"#define {s} {int(s in switches)}\n" in src, (name, s)
            assert src.count(f"{s}") >= 2, (name, s)
