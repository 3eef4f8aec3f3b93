"""JAX's named-axis collectives over one dimension of a ``DeviceMesh``.

The reference runs its sharded code inside ``shard_map`` and reaches the
other shards through ``lax.axis_index``, ``lax.ppermute``, ``lax.psum`` and
``lax.all_gather`` on a named mesh axis.  Here every shard is a process of a
``torch.distributed`` group, and these functions are their counterparts
over the process group of one named dimension of a
:class:`~torch.distributed.device_mesh.DeviceMesh`, with the same semantics.

Every rank of a group must issue the same collectives in the same order,
with tensors of one shape.  A dimension of size 1, or a name the mesh does
not carry (a 1-D mesh has no ``spatial_x``), issues no collective: the
function is then the identity on the one shard, as in the reference.

Transport: :func:`ppermute` is a tiled :func:`all_gather` followed by a
select, on every backend.  Gloo (ranks sharing one card, or the CPU) and
NCCL both take it, and it moves ``S`` blocks where point-to-point sends
would move one; the halo strips it carries are thin, and point-to-point
transport is later work.

These collectives are not differentiable: a tensor that requires a gradient
under grad mode raises, since the result would silently carry none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "axis_index", "axis_size", "calls", "ppermute", "psum"]

# collectives of the process group issued by this process (all_gather and
# psum; a ppermute is an all_gather): a plain count for measurements
calls = 0


def axis_size(mesh, name: str) -> int:
    """Size of ``mesh``'s dimension ``name`` (1 when the mesh has none)."""
    names = mesh.mesh_dim_names
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (``lax.axis_index``)."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


def _no_grad(x, what: str):
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{what} carries no gradient: differentiating through the halo "
            "exchange is the training slice (ROADMAP.md queue 1, item 17)"
        )


def all_gather(x, mesh, name: str, *, axis: int = 0, tiled: bool = True):
    """``lax.all_gather(x, name, axis=axis, tiled=tiled)``: the shards' ``x``
    in coordinate order, concatenated along ``axis`` (``tiled``) or stacked
    as a new ``axis``."""
    global calls
    size = axis_size(mesh, name)
    if size == 1:
        return x if tiled else x.unsqueeze(axis)
    _no_grad(x, "all_gather")
    calls += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=mesh.get_group(name))
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def psum(x, mesh, names):
    """``lax.psum(x, names)``: the sum of ``x`` over the shards of one
    dimension name or of several (a sum over each in turn)."""
    global calls
    if isinstance(names, str):
        names = (names,)
    for name in names:
        if axis_size(mesh, name) > 1:
            _no_grad(x, "psum")
            calls += 1
            x = x.clone()
            dist.all_reduce(x, group=mesh.get_group(name))
    return x


def ppermute(x, mesh, name: str, perm):
    """``lax.ppermute(x, name, perm)``: shard ``dst`` receives ``x`` of the
    shard ``src`` for each ``(src, dst)`` of ``perm``; a shard that no pair
    names receives zeros."""
    if axis_size(mesh, name) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    source = {dst: src for src, dst in perm}
    gathered = all_gather(x, mesh, name, tiled=False)
    me = axis_index(mesh, name)
    return gathered[source[me]] if me in source else torch.zeros_like(x)
