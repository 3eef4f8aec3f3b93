"""Spatially decomposed model execution: the sharded forward.

The counterpart of ``dlwp_cs_tpu.parallel.sharding``.  The reference runs
a model under ``shard_map`` over ``('data', 'spatial'[, 'spatial_x'])``;
here every rank of a ``torch.distributed`` group runs the model on its own
block (one process per shard, SPMD) with the halo exchange installed under
every convolution:

* :func:`sharded_model_ctx` installs the halo-exchange pad and the shard's
  3x3 conv (:mod:`~dlwp_cs_tpu_torch.ops.padding`'s ``use_pad_impl``,
  :mod:`~dlwp_cs_tpu_torch.ops.conv`'s ``use_conv3x3_impl``);
* :func:`make_spatial_apply` wraps a model: every rank calls the result
  with the same global batch, runs the model on its block and returns the
  global output, all-gathered.

Only the forward is ported (serving).  The sharded training steps, the
data-parallel steps and ``AreaWeightedLoss.local_terms`` need gradients
through the collectives: they raise, naming ``ROADMAP.md``.
"""

from __future__ import annotations

import contextlib

import torch

from dlwp_cs_tpu_torch.ops.conv import use_conv3x3_impl
from dlwp_cs_tpu_torch.ops.padding import use_pad_impl
from dlwp_cs_tpu_torch.parallel.collectives import axis_size
from dlwp_cs_tpu_torch.parallel.halo import check_band_impl, make_sharded_pad, use_band_exchange
from dlwp_cs_tpu_torch.parallel.halo2d import make_sharded_pad_2d
from dlwp_cs_tpu_torch.parallel.hopper_band import make_sharded_pallas_conv3x3
from dlwp_cs_tpu_torch.parallel.hopper_tile import make_tile_pallas_conv3x3
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_X_AXIS, gather_blocks, local_block
from dlwp_cs_tpu_torch.parallel.overlap import make_sharded_conv3x3
from dlwp_cs_tpu_torch.parallel.overlap_band import make_overlap_conv3x3
from dlwp_cs_tpu_torch.parallel.symmetric import check_timeouts

__all__ = [
    "make_dp_eval_step",
    "make_dp_shardmap_train_step",
    "make_dp_train_step",
    "make_spatial_apply",
    "make_spatial_train_step",
    "shard_batch",
    "sharded_model_ctx",
]

_KERNEL_CONVS = ("pallas", "pallas_interpret")
_TRAINING = "ROADMAP.md queue 1, item 17 (the sharded training slice)"


def shard_batch(batch, mesh, *, spatial: bool = False):
    """This rank's block of each tensor of ``batch`` (a tensor or a tuple or
    list of them): the batch axis over ``data`` and, with ``spatial``, face
    rows over ``spatial`` and columns over ``spatial_x``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(t, mesh, spatial=spatial) for t in batch)
    return local_block(batch, mesh, spatial=spatial)


def sharded_model_ctx(mesh, *, overlap: bool = True, band_impl: str = "ppermute",
                      band_conv: str = "ringfix"):
    """Context-manager factory installing the sharded conv machinery for a
    rank of ``mesh``.

    Row bands (no ``spatial_x`` dimension): the seam-routed 1-D pad, and
    with ``overlap`` (the default) a 3x3 conv for every 3x3/stride-1 conv:
    ``band_conv='ringfix'`` the band ring-fix conv, ``'pallas'`` (or
    ``'pallas_interpret'``) the band kernel #8 on the exchanged ghost
    strips, ``'overlap'`` (or ``'overlap_interpret'``) kernel #11, the band
    conv with the band-row exchange in the launch.  ``band_impl``: the
    band-row transport of every exchange that moves band rows,
    ``'ppermute'`` (two collectives) or ``'rdma'`` (or ``'rdma_interpret'``;
    kernel #10's remote copies).  Kernels #10 and #11 map the ring
    neighbours' buffers by CUDA IPC (:mod:`parallel.symmetric`): the ranks
    of a dimension share one host.

    2-D tiles (``spatial_x > 1``): the 2-D exchange, every conv
    pad-then-VALID (``'ringfix'``) or every 3x3 through the tile kernel #9
    (``'pallas'``).

    Raises ``ValueError`` on an option that would be accepted and ignored:
    a ``band_impl`` other than ``'ppermute'`` or ``band_conv='overlap'`` on
    tiles, a ``band_conv`` without ``overlap``, and ``band_impl='zero'``.
    """
    n_spatial_x = axis_size(mesh, SPATIAL_X_AXIS)
    if n_spatial_x > 1:
        if band_impl != "ppermute":
            raise ValueError(
                f"band_impl {band_impl!r} does not apply to the 2-D row x column "
                "tiling (its exchange is parallel.halo2d); leave it at the "
                "default 'ppermute'"
            )
        pad2d = make_sharded_pad_2d(mesh)
        if band_conv in _KERNEL_CONVS:
            tile_conv = make_tile_pallas_conv3x3(mesh)

            @contextlib.contextmanager
            def ctx2d():
                with use_pad_impl(pad2d), use_conv3x3_impl(tile_conv):
                    yield

            return ctx2d
        if band_conv != "ringfix":
            raise ValueError(
                f"band_conv {band_conv!r} is not available on the 2-D row x "
                "column tiling; want 'ringfix' (pad-then-VALID) | 'pallas' | "
                "'pallas_interpret' (the tile kernel)"
            )
        return lambda: use_pad_impl(pad2d)
    check_band_impl(band_impl)
    if band_impl == "zero":
        raise ValueError(
            "band_impl 'zero' moves no band rows: every pad, and every conv but "
            "band_conv='overlap' (kernel #11, which moves them itself), would read "
            "the zeros"
        )
    pad_impl = make_sharded_pad(mesh)
    if not overlap:
        if band_conv != "ringfix":
            raise ValueError(
                f"band_conv {band_conv!r} requires overlap=True (with "
                "overlap=False every conv runs pad-then-VALID)"
            )

        @contextlib.contextmanager
        def pad_ctx():
            with use_band_exchange(band_impl), use_pad_impl(pad_impl):
                yield

        return pad_ctx
    if band_conv in _KERNEL_CONVS:
        conv_impl = make_sharded_pallas_conv3x3(mesh)
    elif band_conv in ("overlap", "overlap_interpret"):
        conv_impl = make_overlap_conv3x3(mesh)
    elif band_conv == "ringfix":
        conv_impl = make_sharded_conv3x3(mesh)
    else:
        raise ValueError(
            f"unknown band_conv {band_conv!r}; want 'ringfix' | 'pallas' | "
            "'pallas_interpret' | 'overlap' | 'overlap_interpret'"
        )

    @contextlib.contextmanager
    def ctx():
        with use_band_exchange(band_impl), use_pad_impl(pad_impl), use_conv3x3_impl(conv_impl):
            yield

    return ctx


def make_spatial_apply(model, mesh, *, overlap: bool = True, band_impl: str = "ppermute",
                       band_conv: str = "ringfix"):
    """The sharded forward of ``model`` (inputs ``(B, 6, n, n, C)`` ->
    outputs of the same layout): ``apply(inputs) -> outputs``.

    A collective call: every rank of ``mesh`` calls ``apply`` with the same
    global ``inputs``; each runs ``model`` on its block (the batch split
    over ``data``, which must divide it, face rows over ``spatial``,
    columns over ``spatial_x``) under :func:`sharded_model_ctx` and returns
    the global output.  No gradients (the training slice).  A wait of
    kernel #10 or #11 that runs out raises an error naming the rank, the
    call and what it waited for.
    """
    model_ctx = sharded_model_ctx(mesh, overlap=overlap, band_impl=band_impl,
                                  band_conv=band_conv)

    @torch.no_grad()
    def apply(inputs):
        local = shard_batch(inputs, mesh, spatial=True)
        with model_ctx():
            out = model(local)
        out = gather_blocks(out, mesh, spatial=True)
        check_timeouts()
        return out

    return apply


def make_spatial_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_spatial_train_step is not ported yet: {_TRAINING}")


def make_dp_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_dp_train_step is not ported yet: {_TRAINING}")


def make_dp_shardmap_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_dp_shardmap_train_step is not ported yet: {_TRAINING}")


def make_dp_eval_step(*args, **kwargs):
    raise NotImplementedError(f"make_dp_eval_step is not ported yet: {_TRAINING}")
