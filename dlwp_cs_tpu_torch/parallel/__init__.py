"""Distributed execution: meshes, halo exchange, the sharded forward.

The counterpart of ``dlwp_cs_tpu.parallel`` over ``torch.distributed``: one
process per shard, a ``DeviceMesh`` with the reference's axis names, and
the seam-routed halo exchange installed under every convolution.  Serving
is ported (``make_spatial_apply``, ``ForecastService(mesh=...)``, the band
and tile conv kernels #8 and #9, and on row bands the band-row exchange
kernel #10, ``band_impl="rdma"``, and the band conv with the exchange in
the launch #11, ``band_conv="overlap"``, which move the band rows between
the ranks of one host through buffers mapped by CUDA IPC:
``parallel.symmetric``).  So is training (``make_dp_train_step`` and its
variants, ``make_spatial_train_step``, gradients through the halo exchange:
``parallel.collectives``) and ``scaling.py``.  The GSPMD shardings become
explicit slicing (``shard_batch``): ``batch_sharding``,
``batch_spatial_sharding``, ``stacked_batch_sharding`` and ``replicated``
return a block descriptor (``parallel.mesh.BlockSharding``) that
``shard_batch`` and ``prefetch_to_device(sharding=)`` take in place of a
mesh.
"""

from dlwp_cs_tpu_torch.parallel.halo import make_sharded_pad, sharded_cs_pad
from dlwp_cs_tpu_torch.parallel.halo2d import make_sharded_pad_2d, sharded_cs_pad_2d
from dlwp_cs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    SPATIAL_X_AXIS,
    BlockSharding,
    batch_sharding,
    batch_spatial_sharding,
    create_mesh,
    replicated,
    stacked_batch_sharding,
)
from dlwp_cs_tpu_torch.parallel.multihost import (
    global_mesh,
    host_batch_slice,
    initialize_distributed,
)
from dlwp_cs_tpu_torch.parallel.scaling import ScalingResult, measure_scaling
from dlwp_cs_tpu_torch.parallel.sharding import (
    make_dp_eval_step,
    make_dp_scanned_train_step,
    make_dp_shardmap_eval_step,
    make_dp_shardmap_scanned_train_step,
    make_dp_shardmap_train_step,
    make_dp_train_step,
    make_spatial_apply,
    make_spatial_train_step,
    shard_batch,
)


__all__ = [
    "make_sharded_pad",
    "sharded_cs_pad",
    "make_sharded_pad_2d",
    "sharded_cs_pad_2d",
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "SPATIAL_X_AXIS",
    "BlockSharding",
    "batch_sharding",
    "batch_spatial_sharding",
    "create_mesh",
    "replicated",
    "stacked_batch_sharding",
    "global_mesh",
    "host_batch_slice",
    "initialize_distributed",
    "ScalingResult",
    "measure_scaling",
    "make_dp_eval_step",
    "make_dp_scanned_train_step",
    "make_dp_shardmap_eval_step",
    "make_dp_shardmap_scanned_train_step",
    "make_dp_shardmap_train_step",
    "make_dp_train_step",
    "make_spatial_apply",
    "make_spatial_train_step",
    "shard_batch",
]
