"""Cubed-sphere halo exchange for a row-band decomposition.

The counterpart of ``dlwp_cs_tpu.parallel.halo``: activations ``(B, 6, H,
W, C)`` are decomposed by splitting the face rows over the mesh's
``spatial`` dimension, and each convolution's halo is assembled from
seam-shaped collectives (:mod:`~dlwp_cs_tpu_torch.parallel.collectives`):

* **band rows**: the ``w`` rows flanking a band, from its two neighbours
  (two ``ppermute`` s, or kernel #10's remote copies:
  :func:`use_band_exchange`);
* **equatorial W/E ghosts**: the equatorial ring seams are unreversed
  col<->col, so the partner columns of the local (and band-halo) rows are
  local after the band exchange;
* **polar W/E ghosts**: faces 4/5's W/E seams read the global N/S rows of
  faces 1/3: one ``psum`` of 4 row strips, each from one end shard;
* **row<->col S/N ghosts** (end shards): a tiled ``all_gather`` of the 4
  polar column strips;
* **row<->row S/N ghosts** (end shards): one ``ppermute`` on the pair
  ``{0 <-> S-1}``, where interior shards send and receive zeros.

The 8 cube corners are averaged on the end shards, as ``cs_pad`` does.
The reference selects with arithmetic masks on the shard index; here the
rank branches in Python, and every rank still issues every collective.

Installed with :func:`~dlwp_cs_tpu_torch.ops.padding.use_pad_impl`
(:func:`make_sharded_pad`), so the model's code runs unchanged on a band.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from dlwp_cs_tpu_torch.geometry.cubed_sphere import EDGE_E, EDGE_N, EDGE_S, EDGE_W
from dlwp_cs_tpu_torch.ops.padding import padding_plan
from dlwp_cs_tpu_torch.parallel.collectives import all_gather, axis_index, axis_size, ppermute, psum
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS
from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_plain, band_exchange_rdma

__all__ = [
    "halo_pieces",
    "make_sharded_pad",
    "sharded_cs_pad",
    "use_band_exchange",
]

# The band-row transport: "ppermute" (the collectives), "rdma" (kernel #10's
# remote copies, parallel/rdma_halo.py; "rdma_interpret" is the reference's
# name for the same) or "zero" (no transport: the band rows come back as
# zeros, for a conv that moves them itself).
_BAND_IMPL: contextvars.ContextVar = contextvars.ContextVar(
    "cs_band_exchange", default="ppermute"
)
_BAND_IMPLS = ("ppermute", "rdma", "rdma_interpret", "zero")


def check_band_impl(impl: str):
    """Raise unless ``impl`` is a band-row transport."""
    if impl not in _BAND_IMPLS:
        raise ValueError(f"unknown band exchange {impl!r}; want {_BAND_IMPLS}")


@contextlib.contextmanager
def use_band_exchange(impl: str):
    """Within this context, band-row halo transfers use ``impl``."""
    check_band_impl(impl)
    token = _BAND_IMPL.set(impl)
    try:
        yield
    finally:
        _BAND_IMPL.reset(token)


def _check_topology(table):
    """Assert the seam-shape invariants this routing relies on."""
    for f in range(4):
        for e in (EDGE_W, EDGE_E):
            link = table[f][e]
            assert link.face < 4 and not link.reverse and link.edge in (
                EDGE_W,
                EDGE_E,
            ), "equatorial ring seams must be col<->col, unreversed"
    # polar W/E seams read N/S rows of faces 1/3
    assert table[4][EDGE_W].face == 3 and table[4][EDGE_W].edge == EDGE_N
    assert table[4][EDGE_E].face == 1 and table[4][EDGE_E].edge == EDGE_N
    assert table[5][EDGE_W].face == 3 and table[5][EDGE_W].edge == EDGE_S
    assert table[5][EDGE_E].face == 1 and table[5][EDGE_E].edge == EDGE_S


def sharded_cs_pad(x, width: int, *, mesh, axis_name: str = SPATIAL_AXIS):
    """Halo-pad a row-band-sharded field (this rank's block).

    ``x`` ``(B, 6, h, n, C)`` holds rows ``[s*h, (s+1)*h)`` of every face,
    ``s`` this rank's coordinate along ``axis_name`` of ``mesh`` and ``h =
    n / S``; ``1 <= width <= h``.  Returns ``(B, 6, h + 2w, n + 2w, C)``,
    equal to the same rows of ``cs_pad`` of the gathered field.
    """
    bottom_full, top_full, west_mid, east_mid = halo_pieces(
        x, width, mesh=mesh, axis_name=axis_name
    )
    mid = torch.cat([west_mid, x, east_mid], dim=3)
    return torch.cat([bottom_full, mid, top_full], dim=2)


def halo_pieces(x, width: int, *, mesh, axis_name: str = SPATIAL_AXIS):
    """The halo of a row-band-sharded field as four strips, not assembled.

    Returns ``(bottom, top, west, east)`` for the band ``(B, 6, h, n, C)``:
    ``bottom``/``top`` ``(B, 6, w, n+2w, C)`` ghost rows below/above the band
    with the corner columns (global cube corners averaged as in ``cs_pad``),
    ``bottom`` ordered top-down (concatenable under the band);
    ``west``/``east`` ``(B, 6, h, w, C)`` ghost columns of the band's rows.
    """
    b, nf, h, n, c = x.shape
    if nf != 6:
        raise ValueError(f"expected (B, 6, h, n, C), got {tuple(x.shape)}")
    S = axis_size(mesh, axis_name)
    if h * S != n:
        raise ValueError(
            f"row-band sharding inconsistent: h={h} * shards={S} != n={n}"
        )
    w = int(width)
    if not (1 <= w <= h):
        raise ValueError(f"halo width {w} must be in [1, h={h}]")
    table = padding_plan(n, w).table
    _check_topology(table)
    s = axis_index(mesh, axis_name)
    first, last = s == 0, s == S - 1
    zero = x.new_zeros((b, w, n, c))

    # Strips in the [d, t] layout: d = distance from the edge (0 = the
    # face's outermost cells), t = position along the edge, ascending.
    def s_rows(f):  # (B, w, n, C): face f's global-south rows (on the first shard)
        return x[:, f, :w]

    def n_rows(f):  # on the last shard
        return torch.flip(x[:, f, h - w :], dims=(1,))

    def w_cols(f):  # (B, w, h, C), t = local row
        return x[:, f, :, :w].transpose(1, 2)

    def e_cols(f):
        return torch.flip(x[:, f, :, n - w :], dims=(2,)).transpose(1, 2)

    # ---- 1+2: band rows from the neighbour shards
    impl = _BAND_IMPL.get()
    if impl == "ppermute" or S == 1:
        below, above = band_exchange_plain(x, w, mesh=mesh, axis_name=axis_name)
    elif impl == "zero":
        below = torch.zeros_like(x[:, :, h - w :])
        above = torch.zeros_like(x[:, :, :w])
    else:  # kernel #10 (its plain version on a CPU tensor)
        below, above = band_exchange_rdma(x, w, mesh=mesh, axis_name=axis_name)

    # ---- 3: psum of the 4 polar-seam boundary rows [1S, 3S, 1N, 3N], each
    # contributed by one end shard
    bcast = torch.stack([
        s_rows(1) if first else zero,
        s_rows(3) if first else zero,
        n_rows(1) if last else zero,
        n_rows(3) if last else zero,
    ], dim=1)  # (B, 4, w, n, C)
    bcast = psum(bcast, mesh, axis_name)

    # ---- 4: tiled all_gather of the 4 polar column strips [4W, 4E, 5W, 5E]
    cols_local = torch.stack([w_cols(4), e_cols(4), w_cols(5), e_cols(5)], dim=1)
    cols = all_gather(cols_local, mesh, axis_name, axis=3)  # (B, 4, w, n, C)

    # ---- 5: the end pair {0 <-> S-1} swaps the 4 row<->row seam strips;
    # the first sends [0S, 4S, 0, 0], the last [0, 0, 5N, 0N]
    ex = torch.stack([
        s_rows(0) if first else zero,
        s_rows(4) if first else zero,
        n_rows(5) if last else zero,
        n_rows(0) if last else zero,
    ], dim=1)  # (B, 4, w, n, C)
    if S > 1:
        ex = ppermute(ex, mesh, axis_name, [(0, S - 1), (S - 1, 0)])

    # source strip (face, edge) -> (B, w, n, C) [d, t], valid where consumed
    src = {
        (1, EDGE_S): bcast[:, 0],
        (3, EDGE_S): bcast[:, 1],
        (1, EDGE_N): bcast[:, 2],
        (3, EDGE_N): bcast[:, 3],
        (4, EDGE_W): cols[:, 0],
        (4, EDGE_E): cols[:, 1],
        (5, EDGE_W): cols[:, 2],
        (5, EDGE_E): cols[:, 3],
        (0, EDGE_S): ex[:, 0],  # received on the last shard (ghost 5N)
        (4, EDGE_S): ex[:, 1],  # received on the last shard (ghost 0N)
        (5, EDGE_N): ex[:, 2],  # received on the first shard (ghost 0S)
        (0, EDGE_N): ex[:, 3],  # received on the first shard (ghost 4S)
        # row<->row seams whose ends share an end shard
        (2, EDGE_S): s_rows(2),
        (5, EDGE_S): s_rows(5),
        (2, EDGE_N): n_rows(2),
        (4, EDGE_N): n_rows(4),
    }

    def ghost_strip(f: int, e: int):
        """(B, w, n, C) [d, t] ghost strip beyond edge ``e`` of face ``f``."""
        link = table[f][e]
        st = src[(link.face, link.edge)]
        return torch.flip(st, dims=(2,)) if link.reverse else st

    # ---- the band-extended core; the end shards replace the wrapped band
    # rows with the topology's ghosts
    if first:
        below = torch.stack(
            [torch.flip(ghost_strip(f, EDGE_S), dims=(1,)) for f in range(6)], dim=1
        )
    if last:
        above = torch.stack([ghost_strip(f, EDGE_N) for f in range(6)], dim=1)
    bottom, top = below, above
    core = torch.cat([bottom, x, top], dim=2)  # (B, 6, h+2w, n, C)

    # ---- W/E ghost columns for all local rows, halo rows included
    rows_ext = (s * h - w + torch.arange(h + 2 * w, device=x.device)).clamp(0, n - 1)
    w_blocks, e_blocks = [], []
    for f in range(6):
        blocks = []
        for e in (EDGE_W, EDGE_E):
            link = table[f][e]
            if f < 4:
                # equatorial ring seam: the partner column is local in core;
                # ghost depth d = partner column n-1-d (E source) or d (W)
                if link.edge == EDGE_E:
                    gcol = torch.flip(core[:, link.face, :, n - w :], dims=(2,))
                else:
                    gcol = core[:, link.face, :, :w]
                g = gcol.transpose(1, 2)  # (B, w, h+2w, C) [d, row]
            else:
                # polar seam: the broadcast boundary row at the global rows
                # of the local rows (clamped; the end entries are replaced by
                # the corner step on the end shards)
                st = src[(link.face, link.edge)]
                if link.reverse:
                    st = torch.flip(st, dims=(2,))
                g = st.index_select(2, rows_ext)  # (B, w, h+2w, C) [d, row]
            blocks.append(g)
        gw, ge = blocks
        w_blocks.append(torch.flip(gw, dims=(1,)).transpose(1, 2))  # W: column w-1-d
        e_blocks.append(ge.transpose(1, 2))  # E: column w+n+d
    west = torch.stack(w_blocks, dim=1)  # (B, 6, h+2w, w, C)
    east = torch.stack(e_blocks, dim=1)

    # ---- the corner columns of the ghost rows: interior band boundaries
    # take the ghost columns at the halo rows; the 8 cube corners (end
    # shards) the mean of their two flanking edges, as cs_pad
    hw = h + w
    if first:
        bl = 0.5 * (bottom[:, :, :, 0:1] + west[:, :, w : w + 1, :])
        br = 0.5 * (bottom[:, :, :, n - 1 : n] + east[:, :, w : w + 1, :])
    else:
        bl, br = west[:, :, :w], east[:, :, :w]
    if last:
        tl = 0.5 * (top[:, :, :, 0:1] + west[:, :, hw - 1 : hw, :])
        tr = 0.5 * (top[:, :, :, n - 1 : n] + east[:, :, hw - 1 : hw, :])
    else:
        tl, tr = west[:, :, hw:], east[:, :, hw:]
    bottom_full = torch.cat([bl, bottom, br], dim=3)  # (B, 6, w, n+2w, C)
    top_full = torch.cat([tl, top, tr], dim=3)
    return bottom_full, top_full, west[:, :, w:hw], east[:, :, w:hw]


def make_sharded_pad(mesh, axis_name: str = SPATIAL_AXIS):
    """Pad for :func:`~dlwp_cs_tpu_torch.ops.padding.use_pad_impl` on a
    rank of ``mesh``, whose ``axis_name`` dimension splits the face rows::

        with use_pad_impl(make_sharded_pad(mesh)):
            out = model(x_band)   # every cs_pad now exchanges halos
    """

    def pad(x, width):
        return sharded_cs_pad(x, width, mesh=mesh, axis_name=axis_name)

    return pad
