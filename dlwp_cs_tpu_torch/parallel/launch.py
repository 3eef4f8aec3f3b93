"""Run a function on every rank of a process group spawned on this host.

    results = spawn_group(fn, 4, arg, workdir=tmp)   # fn(arg) on 4 ranks

Each rank is a fresh process (the ``spawn`` start method: it inherits no
threads and no imported JAX from its parent) that joins a process group
meeting through a ``FileStore`` under ``workdir``, so several groups can
run at once without a TCP port.  ``fn`` must be importable by name (a
module-level function).  Its return value comes back to the caller, one per
rank; an exception or a non-zero exit in any rank stops the others and
raises in the caller, and a collective that waits longer than 5 minutes
raises in its rank, so a rank that stops answering cannot hang the group.
A rank whose ``fn`` returns frees its ring buffers
(:func:`~dlwp_cs_tpu_torch.parallel.symmetric.release_all`, a collective
call) before the group ends.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dlwp_cs_tpu_torch.parallel import symmetric

__all__ = ["spawn_group"]

# Gloo for host tensors and for CUDA tensors: several ranks may share one
# card, which NCCL refuses.
GLOO = "cpu:gloo,cuda:gloo"
_TIMEOUT = datetime.timedelta(minutes=5)


def _rank_main(rank, fn, args, world_size, workdir):
    # the ranks of one host talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(str(Path(workdir) / "store"), world_size)
    dist.init_process_group(GLOO, store=store, rank=rank, world_size=world_size,
                            timeout=_TIMEOUT)
    try:
        result = fn(*args)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
        symmetric.release_all()  # the ring buffers of the band-row exchange kernels
    finally:
        dist.destroy_process_group()


def spawn_group(fn, world_size: int, *args, workdir):
    """``[fn(*args) on rank r for r in range(world_size)]``, each rank a
    spawned process of one gloo group.  ``workdir`` must be an empty
    directory; it receives the store and the results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    mp.start_processes(
        _rank_main, args=(fn, args, world_size, str(workdir)),
        nprocs=world_size, join=True, start_method="spawn",
    )
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]
