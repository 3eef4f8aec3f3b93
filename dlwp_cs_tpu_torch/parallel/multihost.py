"""Multi-process bring-up helpers.

The counterpart of ``dlwp_cs_tpu.parallel.multihost``: the same
``('data', 'spatial')`` mesh spans every process of a ``torch.distributed``
group, across hosts or on one.  A single-process run is the degenerate
case, so one entry point runs everywhere.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dlwp_cs_tpu_torch.parallel.mesh import create_mesh

__all__ = ["global_mesh", "host_batch_slice", "initialize_distributed"]


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, *, backend: str | None = None) -> bool:
    """Initialize the default process group if running multi-process;
    returns True if so.

    With no arguments it reads the usual environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them)
    and returns False, initializing nothing, when ``WORLD_SIZE`` is absent
    or 1.  ``backend`` defaults to NCCL for CUDA tensors and gloo for host
    tensors (one rank per card); ranks that share a card need
    ``"cpu:gloo,cuda:gloo"``.  A second call returns at once.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and world_size is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        dist.init_process_group(backend, init_method="env://")
        return True
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def global_mesh(spatial: int = 1, *, device=None):
    """Mesh over every rank; the ``data`` dimension takes the rest."""
    return create_mesh(data=None, spatial=spatial, device=device)


def host_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of the global batch (per-process
    feeding); the whole batch in a single-process run."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_proc} processes"
        )
    per = global_batch // n_proc
    pid = dist.get_rank() if dist.is_initialized() else 0
    return slice(pid * per, (pid + 1) * per)
