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
``parallel.collectives``) and ``scaling.py``.  The GSPMD shardings are not:
the port slices blocks explicitly (``shard_batch``), and
``batch_sharding``, ``batch_spatial_sharding`` and ``replicated`` raise
``NotImplementedError`` naming ``ROADMAP.md``.
"""

from dlwp_cs_tpu_torch.parallel.halo import make_sharded_pad, sharded_cs_pad
from dlwp_cs_tpu_torch.parallel.halo2d import make_sharded_pad_2d, sharded_cs_pad_2d
from dlwp_cs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    SPATIAL_X_AXIS,
    create_mesh,
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


def _not_ported(name: str, where: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md {where}")

    fn.__name__ = fn.__qualname__ = name
    return fn


_SHARDINGS = "queue 1, item 17 (GSPMD shardings; the port slices blocks: shard_batch)"
batch_sharding = _not_ported("batch_sharding", _SHARDINGS)
batch_spatial_sharding = _not_ported("batch_spatial_sharding", _SHARDINGS)
replicated = _not_ported("replicated", _SHARDINGS)

__all__ = [
    "make_sharded_pad",
    "sharded_cs_pad",
    "make_sharded_pad_2d",
    "sharded_cs_pad_2d",
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "SPATIAL_X_AXIS",
    "batch_sharding",
    "batch_spatial_sharding",
    "create_mesh",
    "replicated",
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
