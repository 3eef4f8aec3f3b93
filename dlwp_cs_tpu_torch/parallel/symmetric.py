"""Symmetric device buffers: one per rank of a mesh dimension, mapped into
its ring neighbours by CUDA IPC.

The band-row exchange kernels (#10, ``csrc/cs_band_xchg.cu``, and #11,
``csrc/cs_band_overlap.cu``) store a rank's boundary rows straight into
its neighbours' buffers and signal them through counters there
(``csrc/cs_band_proto.cuh`` has the layout and the protocol).  This module
keeps the host's half:

* :func:`ring_buffer` returns the rank's :class:`RingBuffer` for one
  dimension of a mesh, made on first use;
* :meth:`RingBuffer.reserve` grows its receive slots to the largest slab
  met so far: a collective call, made by every rank of the dimension at the
  same point of the program, since every rank sees the same shapes (SPMD);
* :meth:`RingBuffer.ring` numbers each call (its epoch) and hands a launch
  the pointers it needs;
* :func:`release_all` closes and frees every buffer, collectively, at the
  end of the process group (``parallel/launch.py`` calls it).

A buffer comes from ``cudaMalloc`` in the kernels' own library, not from
PyTorch's caching allocator, which sub-allocates: an IPC handle names a
whole allocation.  The 64-byte handles and the host names travel once per
allocation, in one ``all_gather`` of a uint8 tensor over the dimension's
group (gloo).  A neighbour on another host, or a handle that CUDA refuses
to map, raises with the reason: there is no other transport behind this
one.  Several ranks may share one card (their contexts then take turns on
it); the card's compute mode must not be ``EXCLUSIVE_PROCESS``.

A wait in the kernels that runs out (:data:`SPIN_TIMEOUT_S`) writes what it
waited for into a host-mapped record, makes the call's other waits give up
and ends the kernel, whose outputs are then garbage (a trap, which would
poison the context, stalled a neighbour's context on a shared card).  The
record stays: :func:`timeout_error` reads it, every later launch of the
kernels raises it, and :func:`check_timeouts` raises it once the device
has finished, naming the rank, the epoch and the counter.
"""

from __future__ import annotations

import ctypes
import socket
import threading

import torch
import torch.distributed as dist

from dlwp_cs_tpu_torch.ops.cuda_build import I32, VP, CudaLibrary

__all__ = [
    "SPIN_TIMEOUT_S",
    "RingBuffer",
    "check_timeouts",
    "live_buffers",
    "release_all",
    "ring_buffer",
    "timeout_error",
]

# Bound of every wait in the exchange kernels.  Ranks that share one card
# wait out each other's time slices (milliseconds); a rank that does not
# arrive at all is a fault.
SPIN_TIMEOUT_S = 10.0

I64, U64 = ctypes.c_longlong, ctypes.c_ulonglong
_HEADER = 1024  # bytes of counters before the slots (cs_band_proto.cuh)
_MIN_SLOT = 1 << 16
_HANDLE, _HOST = 64, 64  # bytes of an IPC handle, of a host name
_COUNTERS = ("the -1 neighbour's barrier signal", "the +1 neighbour's barrier signal",
             "the -1 neighbour's top rows (below)", "the +1 neighbour's bottom rows (above)",
             "this grid's own sends")

LIB = CudaLibrary("cs_band_xchg.cu", {
    "cs_sym_alloc": [I32, I64, ctypes.POINTER(VP), VP],
    "cs_sym_open": [I32, VP, ctypes.POINTER(VP)],
    "cs_sym_close": [I32, VP],
    "cs_sym_free": [I32, VP],
    "cs_sym_live": [ctypes.POINTER(I32), ctypes.POINTER(I32)],
    "cs_sym_diag": [ctypes.POINTER(VP)],
    "cs_band_xchg_launch": [I32, VP, VP, VP, VP, VP, VP, I64] + [I32] * 6
    + [U64, ctypes.POINTER(U64), I64, VP, I32, VP],
}, "cs_band_xchg_error_string")

_BUFFERS: dict = {}
_LOCK = threading.Lock()
_DIAG: list = []  # [(record, address)] once allocated


def _check(err: int, what: str):
    if err != 0:
        msg = LIB.build().cs_band_xchg_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _diag() -> int:
    """The address of this process's host-mapped timeout record (8 int64,
    allocated at the first call)."""
    with _LOCK:
        if not _DIAG:
            ptr = VP()
            _check(LIB.build().cs_sym_diag(ctypes.byref(ptr)),
                   "cudaHostAlloc of the timeout record")
            _DIAG.append(((ctypes.c_longlong * 8).from_address(ptr.value), ptr.value))
        return _DIAG[0][1]


def timeout_error():
    """The error of this process's first exchange wait that ran out, or
    None."""
    if not _DIAG or _DIAG[0][0][0] == 0:
        return None
    _, rank, epoch, counter, seen, want, timeout_ns, kernel = _DIAG[0][0]
    return RuntimeError(
        f"band-row exchange timed out in kernel #{kernel} on the rank at coordinate "
        f"{rank}: epoch {epoch}, after {timeout_ns / 1e9:g} s waiting on "
        f"{_COUNTERS[counter] if counter < len(_COUNTERS) else counter} (counter "
        f"{counter}) at {seen}, want >= {want}; a neighbour did not reach this call, "
        "whose outputs are garbage"
    )


def check_timeouts():
    """Raise :func:`timeout_error` when an exchange wait of this process
    ran out, once the device has finished the work given to it."""
    if _DIAG:
        torch.cuda.synchronize()
        err = timeout_error()
        if err is not None:
            raise err


class RingBuffer:
    """This rank's buffer for the ring of one mesh dimension, and its two
    neighbours' buffers mapped here.  Made by :func:`ring_buffer`."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.size = len(self.ranks)
        self.coord = self.ranks.index(dist.get_rank())
        self.device = device.index if device.index is not None else torch.cuda.current_device()
        self.cap = 0  # bytes of each slot
        self.epoch = 0  # calls so far; never reset
        self.sent = U64(0)  # SENT target of the last call (reset with the buffer)
        self.me = self.right = self.left = None
        self._opened: list[int] = []

    def _exchange(self, handle: bytes):
        """Every rank's (handle, host name), in coordinate order."""
        host = socket.gethostname().encode()[:_HOST]
        mine = torch.zeros(_HANDLE + _HOST, dtype=torch.uint8)
        mine[:_HANDLE] = torch.frombuffer(bytearray(handle), dtype=torch.uint8)
        mine[_HANDLE : _HANDLE + len(host)] = torch.frombuffer(bytearray(host), dtype=torch.uint8)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return [(bytes(p[:_HANDLE].tolist()), bytes(p[_HANDLE:].tolist()).rstrip(b"\0"))
                for p in parts]

    def reserve(self, slot_bytes: int, library: CudaLibrary):
        """Grow the slots to hold ``slot_bytes`` each (a power of two from
        64 KB), and load the kernel's ``library``.  Collective where either
        happens: every rank of the dimension calls it with the same size
        and library.  A library is loaded behind a barrier, so that no rank
        is still compiling while its neighbours' kernels wait for it."""
        if library._lib is None:
            library.build()
            dist.barrier(group=self.group)
        if slot_bytes <= self.cap:
            return
        cap = max(_MIN_SLOT, 1 << (int(slot_bytes) - 1).bit_length())
        lib = LIB.build()
        if self.me is not None:
            self._release()
        ptr, handle = VP(), ctypes.create_string_buffer(_HANDLE)
        _check(lib.cs_sym_alloc(self.device, _HEADER + 2 * cap, ctypes.byref(ptr), handle),
               f"cudaMalloc/cudaIpcGetMemHandle of {_HEADER + 2 * cap} bytes")
        self.me, self.cap, self.sent = ptr.value, cap, U64(0)
        peers = self._exchange(handle.raw)
        here = socket.gethostname().encode()[:_HOST]
        right, left = (self.coord + 1) % self.size, (self.coord - 1) % self.size
        mapped = {}
        for c in {right, left}:
            handle_c, host = peers[c]
            if host != here:
                raise RuntimeError(
                    f"band-row exchange: the neighbour at coordinate {c} (rank "
                    f"{self.ranks[c]}) runs on host {host.decode()!r}, not {here.decode()!r}; "
                    "CUDA IPC maps buffers between processes of one host only"
                )
            p = VP()
            err = lib.cs_sym_open(self.device, handle_c, ctypes.byref(p))
            if err != 0:
                raise RuntimeError(
                    f"band-row exchange: cudaIpcOpenMemHandle refused the buffer of the "
                    f"neighbour at coordinate {c} (rank {self.ranks[c]}): "
                    f"{lib.cs_band_xchg_error_string(err).decode()} ({err}); the ranks "
                    "must share a host, and the card's compute mode must allow several "
                    "processes"
                )
            mapped[c] = p.value
            self._opened.append(p.value)
        self.right, self.left = mapped[right], mapped[left]

    def ring(self):
        """The next call's ``(me, right, left, cap, epoch, sent, timeout_ns,
        diag, coord)`` for a launch (``sent`` by reference: the launch
        raises it)."""
        self.epoch += 1
        return (self.me, self.right, self.left, self.cap, self.epoch, ctypes.byref(self.sent),
                int(SPIN_TIMEOUT_S * 1e9), _diag(), self.coord)

    def _release(self):
        """Close the peers' mappings and free mine, collectively: after
        every rank's kernels have finished (a barrier), and the frees after
        every rank has closed its mappings (a second one)."""
        lib = LIB.build()
        try:
            torch.cuda.synchronize(self.device)
            lost = False
        except RuntimeError:  # the context is gone: nothing to close or free
            lost = True
        dist.barrier(group=self.group)
        for p in self._opened:
            if not lost:
                _check(lib.cs_sym_close(self.device, p), "cudaIpcCloseMemHandle")
        self._opened = []
        dist.barrier(group=self.group)
        if not lost:
            _check(lib.cs_sym_free(self.device, self.me), "cudaFree of the ring buffer")
        self.me = self.right = self.left = None
        self.cap = 0


def ring_buffer(mesh, axis_name: str, device) -> RingBuffer:
    """This rank's :class:`RingBuffer` for dimension ``axis_name`` of
    ``mesh`` on ``device`` (made on first use; collective then only
    through the first :meth:`~RingBuffer.reserve`)."""
    group = mesh.get_group(axis_name)
    dev = torch.device(device)
    key = (tuple(dist.get_process_group_ranks(group)),
           dev.index if dev.index is not None else torch.cuda.current_device())
    with _LOCK:
        if key not in _BUFFERS:
            _BUFFERS[key] = RingBuffer(group, dev)
        return _BUFFERS[key]


def release_all():
    """Close and free every ring buffer of this process: a collective call
    of every rank that made one, at the end of the process group."""
    with _LOCK:
        buffers = sorted(_BUFFERS.items())
        _BUFFERS.clear()
    for _, buf in buffers:
        if buf.me is not None:
            buf._release()


def live_buffers() -> tuple[int, int]:
    """``(allocated, mapped)``: this process's buffers not yet freed and
    peers' buffers still mapped (0, 0 before any exchange kernel)."""
    if LIB._lib is None:
        return 0, 0
    a, o = I32(), I32()
    LIB.build().cs_sym_live(ctypes.byref(a), ctypes.byref(o))
    return a.value, o.value
