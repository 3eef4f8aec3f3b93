"""Device meshes and the canonical block layout of a batch.

The counterpart of ``dlwp_cs_tpu.parallel.mesh``: the mesh is
``('data', 'spatial'[, 'spatial_x'])``, where ``data`` carries batch data
parallelism and ``spatial`` (face rows, eta) and ``spatial_x`` (face
columns, xi) carry the domain decomposition of the cubed-sphere grid.  Here
it is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default ``torch.distributed`` process group, one rank per shard.

The reference's shardings become explicit slicing: every rank holds the
same global batch, :func:`local_block` cuts this rank's block out of it
(batch over ``data``, face rows over ``spatial``, columns over
``spatial_x``: ``batch_spatial_sharding``) and :func:`gather_blocks` puts
the blocks of all ranks back together on every rank.  The reference's
sharding names (:func:`batch_sharding`, :func:`batch_spatial_sharding`,
:func:`stacked_batch_sharding`, :func:`replicated`) return a
:class:`BlockSharding`: the mesh and, per dimension, the mesh axis that
cuts it (the reference's ``PartitionSpec``), which :func:`local_block`,
``parallel.shard_batch`` and ``prefetch_to_device(sharding=)`` take in
place of a mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.parallel.collectives import all_gather, axis_index, axis_size

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "SPATIAL_X_AXIS",
    "BlockSharding",
    "batch_sharding",
    "batch_spatial_sharding",
    "create_mesh",
    "gather_blocks",
    "local_block",
    "replicated",
    "stacked_batch_sharding",
]

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"  # face-row (eta) decomposition
SPATIAL_X_AXIS = "spatial_x"  # face-column (xi) decomposition (2-D tiling)


def create_mesh(data: int | None = None, spatial: int = 1, spatial_x: int = 1, *,
                device=None):
    """The canonical ``('data', 'spatial'[, 'spatial_x'])`` mesh over the
    ranks of the default process group, which must be initialized
    (:func:`~dlwp_cs_tpu_torch.parallel.multihost.initialize_distributed`).

    ``data=None`` takes the ranks that remain; ``data * spatial *
    spatial_x`` must equal the world size.  A third dimension exists only
    when ``spatial_x > 1``.  ``device`` as everywhere in the port: ``None``
    is the GPU (rank ``LOCAL_RANK``, else the rank modulo the cards of the
    host; several ranks may share one card), which must exist; ``"cpu"``
    runs on the CPU.
    """
    if device is None:
        resolve_device(None)  # raises without a GPU
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialized process group: call "
            "initialize_distributed() (or torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    sp = spatial * spatial_x
    if data is None:
        if world % sp:
            raise ValueError(f"{world} ranks not divisible by spatial={sp}")
        data = world // sp
    if data * sp != world:
        raise ValueError(f"mesh {data}x{sp} needs {data * sp} ranks, have {world}")
    if device is None:
        index = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        device_type = "cuda"
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        device_type = dev.type
    if spatial_x > 1:
        return init_device_mesh(device_type, (data, spatial, spatial_x),
                                mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS, SPATIAL_X_AXIS))
    return init_device_mesh(device_type, (data, spatial),
                            mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))


@dataclass(frozen=True)
class BlockSharding:
    """A rank's block layout: ``spec[d]`` names the mesh axis that dimension
    ``d`` is split over (``None``: whole on every rank); dimensions past the
    spec are whole.  The port's counterpart of a ``NamedSharding``: it
    cuts blocks (:func:`local_block`), it places nothing."""

    mesh: object
    spec: tuple


def batch_sharding(mesh, ndim: int = 5) -> BlockSharding:
    """The leading batch dimension over ``data``; the rest whole."""
    return BlockSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def batch_spatial_sharding(mesh, ndim: int = 5) -> BlockSharding:
    """The batch over ``data`` and the face rows (dimension 2 of ``(B, 6,
    H, W, C)``) over ``spatial``, plus the columns over ``spatial_x`` when
    the mesh has that dimension."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    if ndim >= 3:
        spec[2] = SPATIAL_AXIS
    if ndim >= 4 and SPATIAL_X_AXIS in mesh.mesh_dim_names:
        spec[3] = SPATIAL_X_AXIS
    return BlockSharding(mesh, tuple(spec))


def stacked_batch_sharding(mesh, ndim: int = 6) -> BlockSharding:
    """:func:`batch_sharding` of k-stacked batches ``(k, B, ...)``: the
    leading (step) dimension whole, dimension 1 over ``data``."""
    return BlockSharding(mesh, (None, DATA_AXIS) + (None,) * (ndim - 2))


def replicated(mesh) -> BlockSharding:
    """Every rank holds the whole tensor."""
    return BlockSharding(mesh, ())


def _cut(x, mesh, name, dim):
    size = axis_size(mesh, name)
    if x.shape[dim] % size:
        raise ValueError(
            f"axis {dim} of length {x.shape[dim]} does not split over "
            f"{name}={size}"
        )
    per = x.shape[dim] // size
    return x.narrow(dim, axis_index(mesh, name) * per, per)


def local_block(x, mesh, *, spatial: bool = True, rows_dim: int = 2):
    """This rank's block of the global ``x`` ``(B, 6, H, W, ...)``: the
    batch split over ``data`` and, with ``spatial``, face rows over
    ``spatial`` and columns over ``spatial_x``; contiguous.  ``rows_dim``:
    the face rows' dimension, the columns' the next (3 for a sequence
    batch ``(B, T, 6, H, W, C)``).

    ``mesh`` may be a :class:`BlockSharding` instead, whose spec alone then
    says which dimensions to cut (``spatial`` and ``rows_dim`` apply to a
    mesh); a spec longer than ``x``'s dimensions raises ``ValueError``."""
    if isinstance(mesh, BlockSharding):
        if len(mesh.spec) > x.ndim:
            raise ValueError(
                f"a sharding spec of {len(mesh.spec)} dimensions for a tensor of {x.ndim}")
        for dim, name in enumerate(mesh.spec):
            if name is not None:
                x = _cut(x, mesh.mesh, name, dim)
        return x.contiguous()
    x = _cut(x, mesh, DATA_AXIS, 0)
    if spatial:
        x = _cut(_cut(x, mesh, SPATIAL_AXIS, rows_dim), mesh, SPATIAL_X_AXIS, rows_dim + 1)
    return x.contiguous()


def gather_blocks(x, mesh, *, spatial: bool = True):
    """Inverse of :func:`local_block`: every rank's block, assembled into
    the global tensor on every rank."""
    if spatial:
        x = all_gather(x, mesh, SPATIAL_X_AXIS, axis=3)
        x = all_gather(x, mesh, SPATIAL_AXIS, axis=2)
    return all_gather(x, mesh, DATA_AXIS, axis=0)
