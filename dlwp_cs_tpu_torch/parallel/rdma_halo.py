"""The band-row halo exchange by remote copies: kernel #10.

The counterpart of ``dlwp_cs_tpu.parallel.rdma_halo``: the two
nearest-neighbour ``ppermute`` s of
:func:`~dlwp_cs_tpu_torch.parallel.halo.halo_pieces` (``below``, the -1
neighbour's top rows; ``above``, the +1 neighbour's bottom rows) as one
call of ``csrc/cs_band_xchg.cu``: a kernel stores each rank's rows straight
into its neighbours' buffers (:mod:`~dlwp_cs_tpu_torch.parallel.symmetric`,
mapped by CUDA IPC), the arrivals are signalled and awaited by stream
memory operations, and a second kernel copies the received rows out: no
host staging, no collective of the process group, no thread waiting on
another rank.  Selected with ``use_band_exchange("rdma")`` (or
``sharded_model_ctx(band_impl="rdma")``).  :data:`band_exchange_rdma_v1`
is the first design, one cooperative kernel that spins on the arrivals,
kept as a timing row.

:func:`band_exchange_plain` is the plain version, the two ``ppermute`` s,
which CPU tensors take.

No gradient: the reference's kernel has no VJP (JAX's ``pallas_call`` JVP
rule fails on its remote copies), so a tensor that requires a gradient
under grad mode raises here too.  Training under ``band_impl="rdma"`` works
where the reference's does: with ``band_conv="pallas"`` or ``"overlap"``,
whose backward differentiates the band ring-fix composition over the
``ppermute`` pair.
"""

from __future__ import annotations

import torch

from dlwp_cs_tpu_torch.ops.cuda_build import KernelWrapper
from dlwp_cs_tpu_torch.parallel import symmetric
from dlwp_cs_tpu_torch.parallel.collectives import axis_size, ppermute
from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS

__all__ = ["band_exchange_plain", "band_exchange_rdma", "band_exchange_rdma_v1"]


def band_exchange_plain(x, width: int, *, mesh, axis_name: str = SPATIAL_AXIS):
    """``(below, above)`` of the band ``x`` ``(B, 6, h, n, C)``, each ``(B,
    6, width, n, C)``, by two ``ppermute`` s over ``axis_name``."""
    h, w = x.shape[2], int(width)
    S = axis_size(mesh, axis_name)
    below = ppermute(x[:, :, h - w :], mesh, axis_name, [(i, (i + 1) % S) for i in range(S)])
    above = ppermute(x[:, :, :w], mesh, axis_name, [(i, (i - 1) % S) for i in range(S)])
    return below, above


class RemoteCopyKernel(KernelWrapper):
    """A kernel wrapper whose launch joins the ring of the band-row
    exchange: after a wait of an earlier call ran out, it raises that
    timeout in place of launching."""

    def _launch(self, fn_name, dev, *args, sizes: int = 6):
        err = symmetric.timeout_error()
        if err is not None:
            raise err
        super()._launch(fn_name, dev, *args, sizes=sizes)


class _BandExchangeKernel(RemoteCopyKernel):
    def __init__(self, name, library, v1: bool = False):
        super().__init__(name, library)
        self.v1 = v1

    def __call__(self, x, width: int, *, mesh, axis_name: str = SPATIAL_AXIS):
        """``(below, above)`` of this rank's band ``x`` ``(B, 6, h, n, C)``:
        ``below`` the -1 neighbour's top ``width`` rows, ``above`` the +1
        neighbour's bottom ``width`` rows, each ``(B, 6, width, n, C)``.  A
        collective call of every rank of ``axis_name``.  With one shard
        ``(top, bottom)`` of ``x`` itself, no launch; on a CPU tensor
        :func:`band_exchange_plain`."""
        b, nf, h, n, c = x.shape
        w = int(width)
        if nf != 6 or not 1 <= w <= h:
            raise ValueError(f"band_exchange_rdma: bad band {tuple(x.shape)} or width {w}")
        S = axis_size(mesh, axis_name)
        if S == 1:
            return x[:, :, h - w :], x[:, :, :w]
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "band_exchange_rdma (kernel #10) carries no gradient, as the "
                "reference's Pallas remote-copy exchange has none (its pallas_call "
                "has no JVP): differentiate band_impl='rdma' through "
                "band_conv='pallas' or 'overlap' (their backward runs the band "
                "ring-fix composition over the ppermute pair), or use "
                "band_impl='ppermute'"
            )
        if x.device.type == "cpu":
            return band_exchange_plain(x, w, mesh=mesh, axis_name=axis_name)
        if x.device.type != "cuda":
            raise ValueError(f"band_exchange_rdma runs on cuda or cpu, not {x.device}")
        x = x.contiguous()
        dev = self._device(x)
        ring = symmetric.ring_buffer(mesh, axis_name, x.device, "v1" if self.v1 else "call")
        ring.reserve(b * 6 * w * n * c * x.element_size(), self.library)
        below = torch.empty((b, 6, w, n, c), dtype=x.dtype, device=x.device)
        above = torch.empty_like(below)
        ptrs = (x.data_ptr(), below.data_ptr(), above.data_ptr())
        sizes = (b, h, n, c, w, x.element_size())
        if self.v1:
            me, right, left, cap, epoch, sent, timeout_ns, diag, coord = ring.ring()
            self._launch("cs_band_xchg_v1_launch", dev, dev, *ptrs, me, right, left, cap,
                         *sizes, epoch, sent, timeout_ns, diag, coord, sizes=10)
            return below, above
        call = ring.next_call()
        me, right, left, cap, epoch, consumed, ticket, value, lag = ring.launch_args(call)
        self._launch("cs_band_xchg_launch", dev, dev, *ptrs, me, right, left, cap, *sizes,
                     epoch, consumed, ticket, value, lag, sizes=11)
        ring.watch(call, 10)
        return below, above


# kernel #10: ``band_exchange_rdma(x, width, *, mesh, axis_name)``
band_exchange_rdma = _BandExchangeKernel("band_exchange_rdma", symmetric.LIB)
# its first design (one cooperative kernel that spins), a timing row
band_exchange_rdma_v1 = _BandExchangeKernel("band_exchange_rdma_v1", symmetric.LIB, v1=True)
