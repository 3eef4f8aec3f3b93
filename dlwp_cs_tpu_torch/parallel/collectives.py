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

Gradients.  Each collective is a ``torch.autograd.Function`` whose backward
is its transpose over the joint state of all shards: ``ppermute`` the
inverse permutation, a tiled ``all_gather`` the sum of the cotangents over
the axis and then this shard's slice, ``psum`` the ``psum`` of the
cotangents.  Their backward passes are collectives too, so every rank must
run the same backward nodes in the same order.  Autograd runs the nodes of
one graph in decreasing creation order, and every rank creates its
collectives in the same order; but the halo code branches on the rank, so
a collective's input may need no gradient on one rank (zeros) and its
output may be read on another rank only.  Hence a differentiated sharded
forward runs under :func:`recording`: each collective made there takes the
recording's anchor (a leaf that requires a gradient) as an extra input and
is logged, and :func:`grad` asks autograd for the anchor's gradient too and
feeds a zero cotangent to every logged output, so every rank runs every
collective's backward.  A collective differentiated outside a recording
raises, as it would deadlock the group.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "axis_index",
    "axis_size",
    "calls",
    "grad",
    "ppermute",
    "psum",
    "recording",
]

# collectives of the process group issued by this process (all_gather and
# all_reduce, backward passes included; a ppermute is an all_gather): a plain
# count for measurements
calls = 0


def axis_size(mesh, name: str) -> int:
    """Size of ``mesh``'s dimension ``name`` (1 when the mesh has none)."""
    names = mesh.mesh_dim_names
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (``lax.axis_index``)."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


# ---- the transport, no autograd --------------------------------------------

def _gather(x, mesh, name, axis, tiled):
    global calls
    calls += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, x, group=mesh.get_group(name))
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def _reduce(x, mesh, names):
    """Sum over the shards of each named dimension of size > 1 (a clone):
    one all-reduce of the whole group where those dimensions span it, else
    one a dimension."""
    global calls
    x = x.clone()
    live = [name for name in names if axis_size(mesh, name) > 1]
    sizes = [axis_size(mesh, name) for name in live]
    if len(live) > 1 and math.prod(sizes) == dist.get_world_size():
        calls += 1
        dist.all_reduce(x)
        return x
    for name in live:
        calls += 1
        dist.all_reduce(x, group=mesh.get_group(name))
    return x


def _permute(x, mesh, name, perm):
    source = {dst: src for src, dst in perm}
    me = axis_index(mesh, name)
    gathered = _gather(x, mesh, name, 0, False)
    return gathered[source[me]] if me in source else torch.zeros_like(x)


# ---- the recording of a differentiated forward -----------------------------

class _Recording:
    def __init__(self):
        self.anchors: dict = {}  # device -> leaf
        self.outputs: list = []

    def anchor(self, device):
        if device not in self.anchors:
            self.anchors[device] = torch.zeros((), device=device, requires_grad=True)
        return self.anchors[device]


_RECORDING: contextvars.ContextVar = contextvars.ContextVar("collective_recording",
                                                            default=None)


@contextlib.contextmanager
def recording():
    """Log the collectives of a forward that :func:`grad` differentiates::

        with recording() as rec:
            loss = loss_fn(model(x_local), y_local)
        grads = grad(rec, [loss], params)
    """
    rec = _Recording()
    token = _RECORDING.set(rec)
    try:
        yield rec
    finally:
        _RECORDING.reset(token)


def grad(rec, outputs, inputs, grad_outputs=None):
    """``torch.autograd.grad(outputs, inputs, grad_outputs)`` for a forward
    made under :func:`recording` ``rec``: every collective logged there runs
    its backward on every rank, in the same order.  An input that gets no
    gradient gets zeros."""
    outputs, inputs = list(outputs), list(inputs)
    if grad_outputs is None:
        grad_outputs = [torch.ones_like(o) for o in outputs]
    logged = [o for o in rec.outputs if o.requires_grad]
    anchors = list(rec.anchors.values())
    got = torch.autograd.grad(
        outputs + logged, inputs + anchors,
        list(grad_outputs) + [torch.zeros_like(o) for o in logged],
        allow_unused=True,
    )
    return [torch.zeros_like(i) if g is None else g for i, g in zip(inputs, got)]


def _apply(fn, x, *args):
    """``fn.apply(x, anchor, *args)``: the recording's anchor under grad mode
    (None outside grad mode); the output is logged."""
    if not torch.is_grad_enabled():
        return fn.apply(x, None, *args)
    rec = _RECORDING.get()
    if rec is None:
        if x.requires_grad:
            raise RuntimeError(
                "a collective is differentiated outside collectives.recording(): "
                "its backward would run on the ranks whose inputs need a gradient "
                "only, and the group would wait forever; run the forward under "
                "recording() and differentiate it with collectives.grad (the "
                "train steps of parallel.sharding do)"
            )
        return fn.apply(x, None, *args)
    out = fn.apply(x, rec.anchor(x.device), *args)
    rec.outputs.append(out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, mesh, name, axis, tiled):
        ctx.mesh, ctx.name, ctx.axis, ctx.tiled = mesh, name, axis, tiled
        ctx.per = x.shape[axis] if tiled else 1
        return _gather(x, mesh, name, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        # the sum of the cotangents over the axis, then this shard's slice
        total = _reduce(g.contiguous(), ctx.mesh, (ctx.name,))
        me = axis_index(ctx.mesh, ctx.name)
        if ctx.tiled:
            dx = total.narrow(ctx.axis, me * ctx.per, ctx.per)
        else:
            dx = total.select(ctx.axis, me)
        return dx, None, None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return _reduce(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.mesh, ctx.names), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, mesh, name, perm):
        ctx.mesh, ctx.name, ctx.perm = mesh, name, perm
        return _permute(x, mesh, name, perm)

    @staticmethod
    def backward(ctx, g):
        # the inverse permutation: each source receives its destination's
        # cotangent
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g.contiguous(), ctx.mesh, ctx.name, inverse), None, None, None, None


def all_gather(x, mesh, name: str, *, axis: int = 0, tiled: bool = True):
    """``lax.all_gather(x, name, axis=axis, tiled=tiled)``: the shards' ``x``
    in coordinate order, concatenated along ``axis`` (``tiled``) or stacked
    as a new ``axis``."""
    if axis_size(mesh, name) == 1:
        return x if tiled else x.unsqueeze(axis)
    return _apply(_AllGather, x, mesh, name, axis, tiled)


def psum(x, mesh, names):
    """``lax.psum(x, names)``: the sum of ``x`` over the shards of one
    dimension name or of several (a sum over each in turn)."""
    if isinstance(names, str):
        names = (names,)
    names = tuple(n for n in names if axis_size(mesh, n) > 1)
    if not names:
        return x
    return _apply(_Psum, x, mesh, names)


def ppermute(x, mesh, name: str, perm):
    """``lax.ppermute(x, name, perm)``: shard ``dst`` receives ``x`` of the
    shard ``src`` for each ``(src, dst)`` of ``perm``; a shard that no pair
    names receives zeros."""
    if axis_size(mesh, name) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _apply(_Ppermute, x, mesh, name, tuple(perm))
