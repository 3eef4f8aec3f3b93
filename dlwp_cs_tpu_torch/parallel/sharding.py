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
  global output, all-gathered;
* :func:`make_spatial_train_step`: batch over ``data``, face rows (and
  columns) over ``spatial`` (``spatial_x``), the forward and backward on
  the rank's block through the differentiable halo exchange
  (:mod:`~dlwp_cs_tpu_torch.parallel.collectives`), then the gradients
  summed over every mesh dimension;
* the data-parallel steps (:func:`make_dp_train_step` and its variants):
  the single-device forward and backward on the rank's batch block, the
  fused kernels included (:func:`~dlwp_cs_tpu_torch.ops.conv.
  shard_local_region`), then the gradients averaged over ``data``.  The
  reference's GSPMD and ``shard_map`` variants are one per-rank step here:
  its GSPMD step leaves the fused kernel only because a ``pallas_call`` is
  opaque to its partitioner.

Each step all-reduces its gradients, with the loss terms, as one flat
buffer per dtype: one collective per step (counted in
``collectives.calls``).  Every rank applies the same optimizer update to
the same sums, so the parameters and the optimizer state stay bitwise
equal on every rank.
"""

from __future__ import annotations

import contextlib
import math

import torch

from dlwp_cs_tpu_torch.ops.conv import shard_local_region, use_conv3x3_impl
from dlwp_cs_tpu_torch.ops.padding import use_pad_impl
from dlwp_cs_tpu_torch.parallel import collectives
from dlwp_cs_tpu_torch.parallel.collectives import axis_size, psum
from dlwp_cs_tpu_torch.parallel.halo import check_band_impl, make_sharded_pad, use_band_exchange
from dlwp_cs_tpu_torch.parallel.halo2d import make_sharded_pad_2d
from dlwp_cs_tpu_torch.parallel.hopper_band import make_sharded_pallas_conv3x3
from dlwp_cs_tpu_torch.parallel.hopper_tile import make_tile_pallas_conv3x3
from dlwp_cs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    SPATIAL_X_AXIS,
    BlockSharding,
    gather_blocks,
    local_block,
)
from dlwp_cs_tpu_torch.parallel.overlap import make_sharded_conv3x3
from dlwp_cs_tpu_torch.parallel.overlap_band import make_overlap_conv3x3
from dlwp_cs_tpu_torch.parallel.symmetric import check_timeouts
from dlwp_cs_tpu_torch.train.train_step import apply_gradients, scan_steps

__all__ = [
    "make_dp_eval_step",
    "make_dp_scanned_train_step",
    "make_dp_shardmap_eval_step",
    "make_dp_shardmap_scanned_train_step",
    "make_dp_shardmap_train_step",
    "make_dp_train_step",
    "make_spatial_apply",
    "make_spatial_train_step",
    "mesh_axes",
    "pmean_update",
    "psum_bucket",
    "shard_batch",
    "sharded_model_ctx",
]

_KERNEL_CONVS = ("pallas", "pallas_interpret")


def shard_batch(batch, mesh, *, spatial: bool = False):
    """This rank's block of each tensor of ``batch`` (a tensor or a tuple or
    list of them): the batch axis over ``data`` and, with ``spatial``, face
    rows over ``spatial`` and columns over ``spatial_x``.  ``mesh`` may be a
    block descriptor (``batch_sharding(mesh)``, ...), whose spec then says
    which dimensions to cut (``spatial`` must stay False)."""
    if spatial and isinstance(mesh, BlockSharding):
        raise ValueError("spatial=True with a sharding descriptor: its spec says which "
                         "dimensions to cut (batch_spatial_sharding cuts the face rows)")
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
    conv with the band-row exchange around its passes.  ``band_impl``: the
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
    the global output.  No gradients (:func:`make_spatial_train_step`
    trains).  A wait of kernel #10 or #11 that runs out raises an error
    naming the rank, the call and what it waited for.
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


def mesh_axes(mesh) -> tuple:
    """The mesh's dimension names among ``('data', 'spatial',
    'spatial_x')``, in that order."""
    return tuple(a for a in (DATA_AXIS, SPATIAL_AXIS, SPATIAL_X_AXIS)
                 if a in mesh.mesh_dim_names)


def psum_bucket(values, mesh, names):
    """``psum`` over ``names`` of each tensor of ``values``, detached: one
    all-reduce of one flat buffer in the first tensor's dtype.  Returns
    the sums in order, each in its tensor's dtype."""
    with torch.no_grad():
        flat = torch.cat([v.reshape(-1).to(values[0].dtype) for v in values])
        parts = psum(flat, mesh, names).split([v.numel() for v in values])
    return [p.reshape(v.shape).to(v.dtype) for p, v in zip(parts, values)]


def pmean_update(optimizer, state, loss, grads, mesh, names):
    """``(state, metrics)`` after the optimizer step on ``grads`` (a list in
    ``state.params``' order) and ``loss`` averaged over the shards of
    ``names`` (``lax.pmean``): one bucket of the gradients and the loss.  A
    collective call."""
    n = math.prod(axis_size(mesh, a) for a in names)
    summed = psum_bucket([*grads, loss], mesh, names)
    mean = dict(zip(state.params, (g / n for g in summed[:-1])))
    return apply_gradients(optimizer, state, summed[-1] / n, mean)


def _dp_local_step(apply_fn, optimizer, loss_fn, mesh):
    """The per-rank data-parallel step: the single-device forward and
    backward on the rank's batch block (the installed sharded machinery
    cleared, so the fused kernels apply), then the gradients and the loss
    averaged over ``data``."""

    def step(state, inputs, targets):
        with shard_local_region():
            loss = loss_fn(apply_fn(state.params, inputs), targets)
        grads = list(torch.autograd.grad(loss, list(state.params.values())))
        return pmean_update(optimizer, state, loss, grads, mesh, (DATA_AXIS,))

    return step


def make_dp_train_step(apply_fn, optimizer, loss_fn, mesh):
    """Data-parallel train step ``step(state, inputs, targets) -> (state,
    metrics)``, where ``inputs`` / ``targets`` are this rank's block of the
    global batch (:func:`shard_batch`) and ``state`` is the same on every
    rank.  A collective call of every rank of ``mesh``: one all-reduce of
    the gradients and the loss over ``data``.  The reference's GSPMD step;
    here the same per-rank step as :func:`make_dp_shardmap_train_step`."""
    return _dp_local_step(apply_fn, optimizer, loss_fn, mesh)


def make_dp_shardmap_train_step(apply_fn, optimizer, loss_fn, mesh):
    """The reference's ``shard_map`` data-parallel step: as
    :func:`make_dp_train_step`."""
    return _dp_local_step(apply_fn, optimizer, loss_fn, mesh)


def make_dp_scanned_train_step(apply_fn, optimizer, loss_fn, mesh):
    """``k`` data-parallel steps over stacked batches ``(k, B/data, ...)``
    (this rank's block of each): ``step_k(state, inputs_k, targets_k) ->
    (state, metrics_k)``, the metrics as ``(k,)`` tensors."""
    return scan_steps(_dp_local_step(apply_fn, optimizer, loss_fn, mesh))


def make_dp_shardmap_scanned_train_step(apply_fn, optimizer, loss_fn, mesh):
    """The reference's ``shard_map`` scanned step: as
    :func:`make_dp_scanned_train_step`."""
    return scan_steps(_dp_local_step(apply_fn, optimizer, loss_fn, mesh))


def make_dp_eval_step(apply_fn, loss_fn, mesh):
    """Data-parallel eval step ``step(params, inputs_block, targets_block)
    -> {"loss": ...}``: the loss over the global batch (the blocks' losses
    averaged over ``data``), the same on every rank.  A collective call."""
    n = axis_size(mesh, DATA_AXIS)

    def step(params, inputs, targets):
        with torch.no_grad(), shard_local_region():
            loss = loss_fn(apply_fn(params, inputs), targets)
            return {"loss": psum(loss, mesh, DATA_AXIS) / n}

    return step


def make_dp_shardmap_eval_step(apply_fn, loss_fn, mesh):
    """The reference's ``shard_map`` eval step: as :func:`make_dp_eval_step`."""
    return make_dp_eval_step(apply_fn, loss_fn, mesh)


def make_spatial_train_step(apply_fn, optimizer, loss_fn, mesh, *, jit: bool = True,
                            overlap: bool = True, band_impl: str = "ppermute",
                            band_conv: str = "ringfix"):
    """Spatially decomposed train step ``step(state, inputs, targets) ->
    (state, metrics)``: every rank calls it with the same global batch and
    state; each takes its block (the batch over ``data``, which must divide
    it, face rows over ``spatial``, columns over ``spatial_x``) and runs the
    forward under :func:`sharded_model_ctx` and the backward through the
    exchanges.  A collective call.

    ``loss_fn`` is an unweighted elementwise mean (mse/mae), whose local
    means are averaged over all mesh dimensions (exact: every block holds
    as many elements), or a loss with the ``local_terms`` protocol
    (:class:`~dlwp_cs_tpu_torch.ops.losses.AreaWeightedLoss`): the local
    weighted error sum alone is differentiated, and the step divides the
    sums of its gradients and of the error sums by the sum of the weight
    sums, the global weighted mean exactly.  ``overlap``, ``band_impl``,
    ``band_conv``: :func:`sharded_model_ctx`.  ``jit`` is accepted and
    changes nothing.  Under ``band_impl='rdma'`` (kernel #10) the
    exchange carries no gradient, as the reference's: train it with
    ``band_conv='pallas'`` or ``'overlap'``, whose backward moves the band
    rows by the ``ppermute`` pair.
    """
    model_ctx = sharded_model_ctx(mesh, overlap=overlap, band_impl=band_impl,
                                  band_conv=band_conv)
    axes = mesh_axes(mesh)
    sx_axis = SPATIAL_X_AXIS if axis_size(mesh, SPATIAL_X_AXIS) > 1 else None
    weighted = hasattr(loss_fn, "local_terms")

    def step(state, inputs, targets):
        inputs, targets = shard_batch((inputs, targets), mesh, spatial=True)
        params = list(state.params.values())
        with collectives.recording() as rec:
            with model_ctx():
                pred = apply_fn(state.params, inputs)
            if weighted:
                value, wtot = loss_fn.local_terms(pred, targets, spatial_axis=SPATIAL_AXIS,
                                                  spatial_x_axis=sx_axis, mesh=mesh)
            else:
                value = loss_fn(pred, targets)
        grads = collectives.grad(rec, [value], params)
        check_timeouts()
        if not weighted:
            return pmean_update(optimizer, state, value, grads, mesh, axes)
        summed = psum_bucket([*grads, value.detach(), wtot.detach()], mesh, axes)
        total = summed[-1]
        mean = dict(zip(state.params, (g / total for g in summed[:-2])))
        return apply_gradients(optimizer, state, summed[-2] / total, mean)

    return step
