"""The named-axis collectives on the card: ``ppermute``, ``all_gather`` and
``psum`` of CUDA tensors between the ranks of one host.

The reference's collectives are XLA's device collectives; here a CUDA
tensor on a process group whose CUDA backend is gloo (every
:func:`~dlwp_cs_tpu_torch.parallel.launch.spawn_group`, where several ranks
may share one card, which NCCL refuses) moves through the group's
:class:`~dlwp_cs_tpu_torch.parallel.symmetric.GroupBuffer`: every rank's
buffer mapped into every peer by CUDA IPC, one slot per source in each of
two parities.  A call is a sequence on the caller's stream
(``csrc/cs_collectives.cu`` has the steps): a wait until the destinations
have read this rank's slab of two calls back, the send kernel storing the
slab into each destination's slot, the arrival signals, the waits for the
sources' arrivals (stream memory operations: no thread waits for another
rank), then the reduce kernel (``psum``: the ``S`` slabs summed in rank
order in the tensor's dtype, every rank the same bits) or the unpack kernel
(``all_gather``: tiled or stacked; ``ppermute``: the one slab received),
and the consumed signals.  ``ppermute`` is point to point: a rank stores
only into its destination's slot, and a rank that no pair names gets zeros
and waits on nothing.  The host watchdog of
:mod:`~dlwp_cs_tpu_torch.parallel.symmetric` bounds every call.

:func:`psum_plain`, :func:`all_gather_plain` and :func:`ppermute_plain` are
the plain versions: one ``dist.all_gather`` over the group, then the
rank-order sum, the ``cat`` or ``stack``, or the select.  CPU tensors take
them (over gloo), and the card's kernels are held against them.
:func:`route` says which transport a tensor takes on a group:
``"host"`` (a CPU tensor: the plain version), ``"device"`` (a CUDA tensor
on a gloo group: the kernels; an unmappable peer raises, there is no gloo
fallback) or ``"dist"`` (a CUDA tensor on an NCCL group: ``dist``'s own
collectives, which run on the device).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.distributed as dist

from dlwp_cs_tpu_torch.ops.cuda_build import I32, VP, CudaLibrary
from dlwp_cs_tpu_torch.parallel import symmetric
from dlwp_cs_tpu_torch.parallel.symmetric import I64, U64, RemoteCopyKernel

__all__ = [
    "KERNELS",
    "all_gather",
    "all_gather_plain",
    "collective_reduce",
    "collective_send",
    "collective_unpack",
    "cuda_backend",
    "ppermute",
    "ppermute_plain",
    "psum",
    "psum_dist",
    "psum_plain",
    "route",
]

_PP = ctypes.POINTER(VP)
LIB = CudaLibrary("cs_collectives.cu", {
    "cs_coll_send_launch": [I32, VP, I64, _PP, I32, VP],
    "cs_coll_unpack_launch": [I32, VP, _PP, I32, I64, I64, VP],
    "cs_coll_reduce_launch": [I32, I32, VP, _PP, I32, I64, VP],
    "cs_coll_wait": [_PP, ctypes.POINTER(U64), I32, VP],
    "cs_coll_signal": [_PP, I32, U64, VP],
}, "cs_collectives_error_string")

# the reduce kernel's element types, as its dtype code
REDUCE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2, torch.float16: 3,
                 torch.int32: 4, torch.int64: 5}
# the collectives as the timeout record names them
PPERMUTE, ALL_GATHER, PSUM = 20, 21, 22

# the three kernels; each counts one launch where it launches
collective_send = RemoteCopyKernel("collective_send", LIB)
collective_reduce = RemoteCopyKernel("collective_reduce", LIB)
collective_unpack = RemoteCopyKernel("collective_unpack", LIB)
KERNELS = {k.name: k for k in (collective_send, collective_reduce, collective_unpack)}


def cuda_backend(group) -> str:
    """The backend ``group`` uses for CUDA tensors (``"gloo"``,
    ``"nccl"``, ...)."""
    config = dist.get_backend_config(group)
    for part in config.split(","):
        device, _, name = part.partition(":")
        if device.strip() == "cuda":
            return name.strip()
    return config.strip()


def route(x, group) -> str:
    """The transport of ``x`` on ``group``: ``"host"``, ``"device"`` or
    ``"dist"`` (module docstring)."""
    if x.device.type != "cuda":
        return "host"
    return "device" if cuda_backend(group) == "gloo" else "dist"


# ---- the plain versions -----------------------------------------------------

def _gathered(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def psum_plain(x, group):
    """The sum of ``x`` over ``group``: ``((x_0 + x_1) + x_2) + ...`` in
    rank order, in ``x``'s dtype (a new tensor, the same bits on every
    rank)."""
    parts = _gathered(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def psum_dist(x, group):
    """``dist.all_reduce`` of a copy of ``x`` (an NCCL group's own sum)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_plain(x, group, axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` in rank order, concatenated along ``axis``
    (``tiled``) or stacked as a new ``axis``."""
    parts = _gathered(x, group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute_plain(x, group, perm):
    """Rank ``dst`` of ``group`` gets ``x`` of rank ``src`` for each ``(src,
    dst)`` of ``perm`` (group coordinates); a rank no pair names gets
    zeros."""
    source = {dst: src for src, dst in perm}
    me = dist.get_rank(group)
    parts = _gathered(x, group)
    return parts[source[me]] if me in source else torch.zeros_like(x)


# ---- the device transport ---------------------------------------------------

def _array(values, ctype=VP):
    return (ctype * max(len(values), 1))(*values)


def _check(err: int, what: str):
    if err != 0:
        msg = LIB.build().cs_collectives_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _wait(lib, waits, stream):
    if waits:
        _check(lib.cs_coll_wait(_array([a for a, _ in waits]),
                                _array([w for _, w in waits], U64), len(waits), stream),
               "cuStreamWaitValue64")


def _signal(lib, addresses, value, stream):
    if addresses:
        _check(lib.cs_coll_signal(_array(addresses), len(addresses), value, stream),
               "cuStreamWriteValue64")


class _Call:
    """One collective on the device, steps 1-4 enqueued at construction
    (the wait for the destinations' reads, the send, the arrival signals
    and waits, the ticket); :meth:`finish` enqueues step 6 and hands the
    call to the watchdog."""

    def __init__(self, x, group, dests, sources, kernel):
        err = symmetric.timeout_error()
        if err is not None:
            raise err
        self.buf = buf = symmetric.group_buffer(group, x.device)
        buf.reserve(x.numel() * x.element_size(), LIB)
        self.call = call = buf.next_call(dests, sources)
        self.kernel, self.dev = kernel, buf.device
        self.stream = torch.cuda.current_stream(buf.device).cuda_stream
        lib = LIB.build()
        p, me = call.parity, buf.coord
        if call.dests:
            _wait(lib, [(buf.address(me, buf.consumed_line(d)), w)
                        for d, w in zip(call.dests, call.consumed) if w], self.stream)
            slots = [buf.slot(d, p, me) for d in call.dests]
            collective_send._launch("cs_coll_send_launch", self.dev, self.dev, x.data_ptr(),
                                    x.numel() * x.element_size(), _array(slots), len(slots),
                                    sizes=2)
            _signal(lib, [buf.address(d, buf.arrived(me)) for d in call.dests], call.epoch,
                    self.stream)
        _wait(lib, [(buf.address(me, buf.arrived(s)), call.epoch) for s in call.sources],
              self.stream)
        if call.dests or call.sources:
            symmetric._check(symmetric.LIB.build().cs_sym_write(buf.ticket(), call.ticket,
                                                                self.stream),
                             "cuStreamWriteValue64")

    def slot(self, source: int) -> int:
        """My slot of this call's parity that ``source`` stored into."""
        return self.buf.slot(self.buf.coord, self.call.parity, source)

    def finish(self):
        buf, call = self.buf, self.call
        _signal(LIB.build(), [buf.address(s, buf.consumed_line(buf.coord)) for s in call.sources],
                call.epoch, self.stream)
        if call.dests or call.sources:
            buf.watch(call, self.kernel)


def _unpack(out, sources, outer: int, inner: int, dev: int):
    collective_unpack._launch("cs_coll_unpack_launch", dev, dev, out.data_ptr(),
                              _array(sources), len(sources), outer, inner, sizes=2)


def psum(x, group):
    """:func:`psum_plain` on the card: the reduce kernel over the slots of
    every peer and ``x`` itself, in rank order."""
    if x.dtype not in REDUCE_DTYPES:
        raise ValueError(f"device psum takes {sorted(map(str, REDUCE_DTYPES))}, not {x.dtype}")
    x = x.contiguous()
    S = dist.get_world_size(group)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    peers = range(S)
    c = _Call(x, group, peers, peers, PSUM)
    me = c.buf.coord
    sources = [x.data_ptr() if s == me else c.slot(s) for s in range(S)]
    collective_reduce._launch("cs_coll_reduce_launch", c.dev, c.dev, REDUCE_DTYPES[x.dtype],
                              out.data_ptr(), _array(sources), S, x.numel(), sizes=2)
    c.finish()
    return out


def all_gather(x, group, axis: int = 0, tiled: bool = True):
    """:func:`all_gather_plain` on the card: the unpack kernel interleaves
    the slabs as ``(outer, S, inner)``, which is both the ``cat`` and the
    ``stack`` along ``axis``."""
    x = x.contiguous()
    S = dist.get_world_size(group)
    axis = axis % (x.ndim if tiled else x.ndim + 1)
    shape = list(x.shape)
    if tiled:
        shape[axis] *= S
    else:
        shape.insert(axis, S)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    peers = range(S)
    c = _Call(x, group, peers, peers, ALL_GATHER)
    me = c.buf.coord
    outer = math.prod(x.shape[:axis])
    _unpack(out, [x.data_ptr() if s == me else c.slot(s) for s in range(S)], outer,
            x.numel() // outer * x.element_size(), c.dev)
    c.finish()
    return out


def ppermute(x, group, perm):
    """:func:`ppermute_plain` on the card, point to point: this rank stores
    ``x`` into its destination's slot only, and reads its source's."""
    x = x.contiguous()
    me = dist.get_rank(group)
    dest = {src: dst for src, dst in perm}
    source = {dst: src for src, dst in perm}
    if x.numel() == 0:
        return torch.zeros_like(x)
    c = _Call(x, group, [dest[me]] if me in dest else [],
              [source[me]] if me in source else [], PPERMUTE)
    if me not in source:
        out = torch.zeros_like(x)
    else:
        out = torch.empty_like(x)
        _unpack(out, [x.data_ptr() if source[me] == me else c.slot(source[me])], 1,
                x.numel() * x.element_size(), c.dev)
    c.finish()
    return out
