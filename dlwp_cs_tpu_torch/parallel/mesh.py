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
the blocks of all ranks back together on every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.parallel.collectives import all_gather, axis_index, axis_size

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "SPATIAL_X_AXIS",
    "create_mesh",
    "gather_blocks",
    "local_block",
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
    batch ``(B, T, 6, H, W, C)``)."""
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
