"""The band 3x3 conv fused with the band-row exchange: kernel #11.

The counterpart of ``dlwp_cs_tpu.parallel.overlap_band``.  One call of
``csrc/cs_band_overlap.cu`` per conv: the band conv of kernel #8 whose two
ghost rows come from the ring neighbours by remote copies around its
passes (the protocol of kernel #10, over the same
:mod:`~dlwp_cs_tpu_torch.parallel.symmetric` buffers), not from an
exchange before it.  Tiles that touch no ghost row compute while the rows
are in flight; the tiles of rows 0 and h-1 run after the stream's wait for
them.  :data:`band_conv3x3_overlap_v1` is the first design, one
cooperative kernel that spins on the arrivals between its passes, kept as a
timing row.

The seam material still comes from the host-side exchange
(:func:`_seam_ext`: :func:`~dlwp_cs_tpu_torch.parallel.halo.halo_pieces`
under the ``"zero"`` band transport): the S/N ghost rows of the end shards,
the polar faces' ghost-row corners and the W/E ghost columns.  Every value
that depends on the band rows comes back zero there; the kernel fills it
from the received rows, the equatorial corners through
:func:`_eq_corner_table`.

:func:`band_conv3x3_overlap_plain` is the plain version: it consumes what
the kernel consumes (the seam strips, the two rows the ``ppermute`` pair
brings, the corner table), assembles the ghost rows as the kernel does and
runs the conv's plain version.  CPU tensors take it.

The backward is the reference's: autograd through the band ring-fix
composition recomputed on the saved inputs (over the ``ppermute`` pair), as
:mod:`~dlwp_cs_tpu_torch.parallel.hopper_band` does for kernel #8.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_W
from dlwp_cs_tpu_torch.ops.cuda_build import DTYPES, I32, VP, CudaLibrary, check_cuda_args
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain, fwd_plan
from dlwp_cs_tpu_torch.ops.padding import padding_plan
from dlwp_cs_tpu_torch.parallel import symmetric
from dlwp_cs_tpu_torch.parallel.collectives import axis_index, axis_size
from dlwp_cs_tpu_torch.parallel.halo import halo_pieces, use_band_exchange
from dlwp_cs_tpu_torch.parallel.hopper_band import ringfix_backward
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS
from dlwp_cs_tpu_torch.parallel.overlap import sharded_ringfix_conv3x3
from dlwp_cs_tpu_torch.parallel.rdma_halo import RemoteCopyKernel, band_exchange_plain

__all__ = [
    "band_conv3x3_overlap",
    "band_conv3x3_overlap_plain",
    "band_conv3x3_overlap_v1",
    "make_overlap_conv3x3",
    "overlap_supported",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _eq_corner_table(n: int):
    """Per face ``(partner_face, partner_col_is_east)`` for the W/E
    ghost-row corner cells of the 4 equatorial faces, as four 6-tuples
    ``(pf_w, pe_w, pf_e, pe_e)`` (zeros for the polar faces 4, 5).

    The equatorial ring seams are col<->col and unreversed (asserted by
    ``halo._check_topology``), so the ghost corner beyond edge W/E of face f
    at a band-halo row is the W/E partner face's column 0 or n-1 at that
    same row: an entry of the partner face's received band row.  Polar
    faces' corners come from the seam rows instead.
    """
    table = padding_plan(n, 1).table
    pf_w, pe_w, pf_e, pe_e = [], [], [], []
    for f in range(4):
        lw, le = table[f][EDGE_W], table[f][EDGE_E]
        pf_w.append(lw.face)
        pe_w.append(1 if lw.edge == EDGE_E else 0)
        pf_e.append(le.face)
        pe_e.append(1 if le.edge == EDGE_E else 0)
    return (tuple(pf_w + [0, 0]), tuple(pe_w + [0, 0]),
            tuple(pf_e + [0, 0]), tuple(pe_e + [0, 0]))


def _packed_corners(n: int) -> int:
    """The corner table as the kernel takes it: 6 bits per equatorial face
    f at bit 6f, [W partner (2 bits), W column n-1, E partner, E column
    n-1]."""
    pf_w, pe_w, pf_e, pe_e = _eq_corner_table(n)
    return sum((pf_w[f] | pe_w[f] << 2 | pf_e[f] << 3 | pe_e[f] << 5) << (6 * f)
               for f in range(4))


def _seam_ext(x, *, mesh, axis_name: str = SPATIAL_AXIS):
    """The seam material of the band ``x`` ``(B, 6, h, n, C)``,
    independent of the band rows: ``(seam, wecols)``, each ``(B, 6, 2, n+2,
    C)``.  ``seam`` holds the [S, N] ghost rows with their corners as
    :func:`halo_pieces` gives them under the ``"zero"`` transport (whole on
    the end shards; zero wherever a value depends on the band rows);
    ``wecols`` the [W, E] ghost columns of the band's rows at positions
    1..h, zero elsewhere."""
    n, h = x.shape[3], x.shape[2]
    with use_band_exchange("zero"):
        bottom, top, west, east = halo_pieces(x, 1, mesh=mesh, axis_name=axis_name)
    seam = torch.stack([bottom[:, :, 0], top[:, :, 0]], dim=2)

    def we(col):  # (B, 6, h, 1, C) -> (B, 6, n+2, C) at positions 1..h
        return F.pad(col[:, :, :, 0], (0, 0, 1, n + 1 - h))

    return seam, torch.stack([we(west), we(east)], dim=2)


def band_conv3x3_overlap_plain(x, seam, wecols, below, above, k_eq, k_pole, b_eq, b_pole, *,
                               first: bool, last: bool):
    """Plain version of kernel #11 on its own inputs: the band ``x`` ``(B,
    6, h, n, Cin)``, its seam strips (:func:`_seam_ext`), the rows received
    from the ring neighbours ``below``/``above`` ``(B, 6, 1, n, Cin)`` and
    whether this shard is the ``first``/``last`` of the ring.  The S/N ghost
    rows are the seam rows on the end shards; elsewhere the received rows,
    with their corner cells from the seam row (polar faces) or from the W/E
    partner face's received row (equatorial faces, :func:`_eq_corner_table`).
    Returns :func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_plain` on
    the assembled ghost strips."""
    n = x.shape[3]
    pf_w, pe_w, pf_e, pe_e = _eq_corner_table(n)

    def ghost_row(topo, ring, is_end):  # (B, 6, n+2, C)
        if is_end:
            return topo
        ring = ring[:, :, 0]
        rows = []
        for f in range(6):
            if f < 4:
                cw = ring[:, pf_w[f], n - 1 if pe_w[f] else 0]
                ce = ring[:, pf_e[f], n - 1 if pe_e[f] else 0]
            else:
                cw, ce = topo[:, f, 0], topo[:, f, n + 1]
            rows.append(torch.cat([cw[:, None], ring[:, f], ce[:, None]], dim=1))
        return torch.stack(rows, dim=1)

    ext = torch.stack([ghost_row(seam[:, :, 0], below, first), ghost_row(seam[:, :, 1], above, last),
                       wecols[:, :, 0], wecols[:, :, 1]], dim=2)
    return cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole)


_LIB = CudaLibrary("cs_band_overlap.cu", {
    "cs_band_overlap_launch": [I32, I32] + [VP] * 11 + [symmetric.I64] + [I32] * 12
    + [symmetric.U64, symmetric.U64, VP, symmetric.U64, symmetric.I64, VP],
    "cs_band_overlap_v1_launch": [I32, I32] + [VP] * 11 + [symmetric.I64] + [I32] * 12
    + [symmetric.U64, ctypes.POINTER(symmetric.U64), symmetric.I64, VP, I32, VP],
}, "cs_band_overlap_error_string")


class _OverlapConv(torch.autograd.Function):
    """Forward: kernel #11 (its wrapper's ``_forward``); backward: the band
    ring-fix composition's."""

    @staticmethod
    def forward(ctx, x, k_eq, k_pole, b_eq, b_pole, kernel, mesh, axis_name):
        ctx.save_for_backward(x, k_eq, k_pole, b_eq, b_pole)
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return kernel._forward(x, k_eq, k_pole, b_eq, b_pole, mesh=mesh, axis_name=axis_name)

    @staticmethod
    def backward(ctx, g):
        def reference(x, *weights):
            return sharded_ringfix_conv3x3(x, *(w.to(x.dtype) for w in weights),
                                           mesh=ctx.mesh, axis_name=ctx.axis_name)

        return ringfix_backward(ctx, g, reference) + (None, None, None)


class _BandOverlapKernel(RemoteCopyKernel):
    def __init__(self, name, library, v1: bool = False):
        super().__init__(name, library)
        self.v1 = v1

    def __call__(self, x, k_eq, k_pole, b_eq, b_pole, *, mesh, axis_name: str = SPATIAL_AXIS):
        """Fused CS band conv, 3x3/stride-1, with the band-row exchange in
        the launch: this rank's band ``x`` ``(B, 6, h, n, Cin)`` -> ``(B,
        6, h, n, Cout)``, the same rows of the single-device ``cs_conv``.  A
        collective call of every rank of ``axis_name`` (at least 2).
        Kernels and biases are cast to ``x``'s dtype.  On a CPU tensor
        :func:`band_conv3x3_overlap_plain` on the ``ppermute`` pair's
        rows.  Differentiable: the backward is the band ring-fix
        composition's (a collective call, as the forward)."""
        b, nf, h, n, cin = x.shape
        S = axis_size(mesh, axis_name)
        if nf != 6 or h * S != n or S < 2:
            raise ValueError(
                f"band_conv3x3_overlap: expected a local band (B, 6, n/{S}, n, C) of "
                f"at least 2 shards, got {tuple(x.shape)}")
        return _OverlapConv.apply(x, k_eq, k_pole, b_eq, b_pole, self, mesh, axis_name)

    def _forward(self, x, k_eq, k_pole, b_eq, b_pole, *, mesh, axis_name):
        S = axis_size(mesh, axis_name)
        k_eq, k_pole, b_eq, b_pole = (t.to(x.dtype).contiguous()
                                      for t in (k_eq, k_pole, b_eq, b_pole))
        x = x.contiguous()
        seam, wecols = _seam_ext(x, mesh=mesh, axis_name=axis_name)
        s = axis_index(mesh, axis_name)
        first, last = s == 0, s == S - 1
        if x.device.type == "cpu":
            below, above = band_exchange_plain(x, 1, mesh=mesh, axis_name=axis_name)
            return band_conv3x3_overlap_plain(x, seam, wecols, below, above, k_eq, k_pole,
                                              b_eq, b_pole, first=first, last=last)
        if x.device.type != "cuda":
            raise ValueError(f"band_conv3x3_overlap runs on cuda or cpu, not {x.device}")
        return self.fused(x, seam, wecols, k_eq, k_pole, b_eq, b_pole, mesh=mesh,
                          axis_name=axis_name)

    def fused(self, x, seam, wecols, k_eq, k_pole, b_eq, b_pole, *, mesh,
              axis_name: str = SPATIAL_AXIS):
        """The launch alone, on CUDA tensors: the band ``x``, its seam
        strips (:func:`_seam_ext`), HWIO kernels and biases, all of ``x``'s
        dtype and contiguous.  A collective call of every rank of
        ``axis_name``, as the wrapper."""
        b, _, h, n, cin = x.shape
        cout = k_eq.shape[-1]
        S = axis_size(mesh, axis_name)
        s = axis_index(mesh, axis_name)
        first, last = s == 0, s == S - 1
        check_cuda_args(self.name, x, {
            "x": (x, (b, 6, h, n, cin)),
            "seam": (seam, (b, 6, 2, n + 2, cin)),
            "wecols": (wecols, (b, 6, 2, n + 2, cin)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
            "b_eq": (b_eq, (cout,)),
            "b_pole": (b_pole, (cout,)),
        })
        dev = self._device(x)
        ring = symmetric.ring_buffer(mesh, axis_name, x.device, "v1" if self.v1 else "call")
        ring.reserve(b * 6 * n * cin * x.element_size(), self.library)
        # tc_plan's (h, cs, nw) and shared memory for x's dtype (the grid is
        # one block a tile, or sized by occupancy in the first design); its
        # walk keeps the weights resident, so a shape whose resident plan
        # does not fit raises here
        th, cs, nw, _, smem = fwd_plan(x.dtype, b, h, n, cin, cout, self._sm_count[dev],
                                       stream=False).args()
        out = torch.empty((b, 6, h, n, cout), dtype=x.dtype, device=x.device)
        ptrs = tuple(t.data_ptr() for t in (x, seam, wecols, k_eq, k_pole, b_eq, b_pole, out))
        if self.v1:
            me, right, left, cap, epoch, sent, timeout_ns, diag, coord = ring.ring()
            self._launch(
                "cs_band_overlap_v1_launch", dev, DTYPES[x.dtype], dev, *ptrs, me, right,
                left, cap, b, h, n, cin, cout, th, cs, nw, smem, int(first), int(last),
                _packed_corners(n), epoch, sent, timeout_ns, diag, coord, sizes=11,
            )
            return out
        call = ring.next_call()
        me, right, left, cap, epoch, consumed, ticket, value, lag = ring.launch_args(call)
        self._launch(
            "cs_band_overlap_launch", dev, DTYPES[x.dtype], dev, *ptrs, me, right, left, cap,
            b, h, n, cin, cout, th, cs, nw, smem, int(first), int(last), _packed_corners(n),
            epoch, consumed, ticket, value, lag, sizes=12,
        )
        ring.watch(call, 11, below=not first, above=not last)
        return out


# kernel #11: ``band_conv3x3_overlap(x, k_eq, k_pole, b_eq, b_pole, *, mesh, axis_name)``
band_conv3x3_overlap = _BandOverlapKernel("band_conv3x3_overlap", _LIB)
# its first design (one cooperative kernel that spins), a timing row
band_conv3x3_overlap_v1 = _BandOverlapKernel("band_conv3x3_overlap_v1", _LIB, v1=True)


def overlap_supported(x_shape, n_shards: int, dtype) -> bool:
    """Does kernel #11 take local bands of this shape and dtype?  It needs
    a ring (2 shards or more), a band (``h * n_shards == n``) and float32
    or bfloat16; its shared memory is the band kernel's, so no size gate."""
    _, nf, h, n, _ = x_shape
    return n_shards >= 2 and nf == 6 and h >= 1 and h * n_shards == n and dtype in _KERNEL_DTYPES


def make_overlap_conv3x3(mesh, axis_name: str = SPATIAL_AXIS):
    """Conv for :func:`~dlwp_cs_tpu_torch.ops.conv.use_conv3x3_impl`: every
    3x3 conv of a band through kernel #11; what it does not take (one shard,
    float64) through the band ring-fix conv."""
    n_shards = axis_size(mesh, axis_name)

    def conv(x, k_eq, k_pole, bias_eq, bias_pole):
        if not overlap_supported(x.shape, n_shards, x.dtype):
            return sharded_ringfix_conv3x3(x, k_eq, k_pole, bias_eq, bias_pole,
                                           mesh=mesh, axis_name=axis_name)
        zb = x.new_zeros(k_eq.shape[-1])
        return band_conv3x3_overlap(x, k_eq, k_pole, zb if bias_eq is None else bias_eq,
                                    zb if bias_pole is None else bias_pole,
                                    mesh=mesh, axis_name=axis_name)

    return conv
