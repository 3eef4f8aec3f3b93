"""Symmetric device buffers: one per rank of a mesh dimension, mapped into
its ring neighbours by CUDA IPC, and the host's half of the band-row
exchange protocol.

The band-row exchange kernels (#10, ``csrc/cs_band_xchg.cu``, and #11,
``csrc/cs_band_overlap.cu``) store a rank's boundary rows straight into
its neighbours' buffers and signal them through counters there
(``csrc/cs_band_proto.cuh`` has the layout and the protocol).  No thread of
theirs waits for another rank: each call is a sequence on the caller's
stream whose waits on the neighbours are stream memory operations
(``cuStreamWaitValue64``), held in the GPU's front end, so the contexts of
ranks that share one card give each other the card instead of spinning
through their time slices.  Each buffer holds its receive slots in two
parities (epoch ``e`` uses parity ``e % 2``): a sender waits until the
neighbour has consumed the last epoch that used the parity (normally ``e -
2``, long done), so no call needs a neighbour barrier.  This module keeps
the host's half:

* :func:`ring_buffer` returns the rank's :class:`RingBuffer` for one
  dimension of a mesh, made on first use;
* :meth:`RingBuffer.reserve` grows its four receive slots to the largest
  slab met so far: a collective call, made by every rank of the dimension
  at the same point of the program, since every rank sees the same shapes
  (SPMD);
* :meth:`RingBuffer.next_call` numbers each call (its epoch), picks its
  parity and the consumed epoch its sender waits for, and hands a launch the
  pointers it needs; :meth:`RingBuffer.watch` bounds the call's waits;
* :func:`release_all` closes and frees every buffer, collectively, at the
  end of the process group (``parallel/launch.py`` calls it).

A buffer comes from ``cudaMalloc`` in the kernels' own library, not from
PyTorch's caching allocator, which sub-allocates: an IPC handle names a
whole allocation.  The 64-byte handles and the host names travel once per
allocation, in one ``all_gather`` of a uint8 tensor over the dimension's
group (gloo).  A neighbour on another host, a handle that CUDA refuses to
map, or a card without 64-bit stream memory operations raises with the
reason: there is no other transport behind this one.  Several ranks may
share one card (their contexts then take turns on it); the card's compute
mode must not be ``EXCLUSIVE_PROCESS``.

A stream wait has no timeout of its own, so a :class:`Watchdog` thread
bounds every call (:data:`SPIN_TIMEOUT_S`): each call writes a ticket into
a host-mapped word once its waits have passed; when a call's ticket has not
come after the bound, the watchdog writes what the call waited for into a
host-mapped record, tells both neighbours (their ``GAVE_UP_*`` counters)
and releases the stream by writing the awaited values from a second
stream, and from then on releases every call of the process at once.  The
outputs of such a call are garbage.  The record stays: :func:`timeout_error`
reads it, every later launch of the kernels raises it, and
:func:`check_timeouts`, at the end of a block of work, waits until both
neighbours have consumed this rank's last rows, raises the record, and
raises too where a neighbour gave up: naming the rank, the epoch and the
counter.  The first design's kernels (``*_v1``, timing rows on buffers of
their own) spin on the counters inside the kernel and bound their waits
there.

The named-axis collectives (``parallel/device_collectives.py``) take a
:class:`GroupBuffer` of the group instead (:func:`group_buffer`): one slot
per source rank in each parity, every peer of the group mapped, an arrival
counter per source and a consumed counter per destination
(``csrc/cs_collectives.cu`` has the layout).  It follows the same rules:
its handles travel in the same ``all_gather``, :meth:`GroupBuffer.reserve`
is collective and grows to the largest slab met so far, the watchdog bounds
every call, and :func:`check_timeouts` and :func:`release_all` cover it.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import socket
import threading
import time

import torch
import torch.distributed as dist

from dlwp_cs_tpu_torch.ops.cuda_build import I32, VP, CudaLibrary, KernelWrapper

__all__ = [
    "SPIN_TIMEOUT_S",
    "Call",
    "GroupBuffer",
    "GroupCall",
    "RemoteCopyKernel",
    "RingBuffer",
    "Watchdog",
    "check_timeouts",
    "group_buffer",
    "live_buffers",
    "release_all",
    "ring_buffer",
    "timeout_error",
]

# Bound of every wait of the exchange kernels: the watchdog's for the
# stream waits, the v1 kernels' own for their spins.  A rank that does not
# arrive at all is a fault.
SPIN_TIMEOUT_S = 10.0
# Nanoseconds a one-thread kernel holds this rank's stream between a call's
# arrival wait and its read of the received rows: 0 but in tests that make
# a rank lag behind its neighbours.
READ_LAG_NS = 0

I64, U64 = ctypes.c_longlong, ctypes.c_ulonglong
# the layout of cs_band_proto.cuh: counters, one per 128-byte line, before
# four slots (below and above in two parities)
_HEADER, _LINE, _SLOTS = 2048, 128, 4
(READY_FROM_LEFT, READY_FROM_RIGHT, ARRIVED_BELOW, ARRIVED_ABOVE, SENT, TIMEOUTS, ABORT,
 CONSUMED_BY_RIGHT, CONSUMED_BY_LEFT, GAVE_UP_LEFT, GAVE_UP_RIGHT) = range(11)
_NCOUNTERS = 11
_COUNTERS = ("the -1 neighbour's barrier signal", "the +1 neighbour's barrier signal",
             "the -1 neighbour's top rows (below)", "the +1 neighbour's bottom rows (above)",
             "this grid's own sends", "", "",
             "the +1 neighbour's read of my top rows", "the -1 neighbour's read of my bottom rows",
             "the -1 neighbour's give-up signal", "the +1 neighbour's give-up signal")
_GAVE_UP = {GAVE_UP_LEFT: "the -1 neighbour", GAVE_UP_RIGHT: "the +1 neighbour"}
_DIAG_LEN = 8  # flag, rank, epoch, counter, seen, want, timeout_ns, kernel
_MIN_SLOT = 1 << 16
_HANDLE, _HOST = 64, 64  # bytes of an IPC handle, of a host name
_POLL_S = 0.05  # the watchdog's period while calls are in flight

LIB = CudaLibrary("cs_band_xchg.cu", {
    "cs_sym_alloc": [I32, I64, ctypes.POINTER(VP), VP],
    "cs_sym_open": [I32, VP, ctypes.POINTER(VP)],
    "cs_sym_close": [I32, VP],
    "cs_sym_free": [I32, VP],
    "cs_sym_live": [ctypes.POINTER(I32), ctypes.POINTER(I32)],
    "cs_sym_host_alloc": [I64, ctypes.POINTER(VP)],
    "cs_sym_memops": [I32, ctypes.POINTER(I32)],
    "cs_sym_write": [VP, U64, VP],
    "cs_sym_wait": [VP, U64, VP],
    "cs_sym_side_read": [I32, VP, VP, I64],
    "cs_sym_side_write": [I32, VP, U64],
    "cs_sym_round": [VP, VP, VP, U64, VP],
    "cs_sym_spin_round": [VP, VP, VP, U64, I64, VP, I32, VP],
    "cs_band_xchg_launch": [I32, VP, VP, VP, VP, VP, VP, I64] + [I32] * 6
    + [U64, U64, VP, U64, I64, VP],
    "cs_band_xchg_v1_launch": [I32, VP, VP, VP, VP, VP, VP, I64] + [I32] * 6
    + [U64, ctypes.POINTER(U64), I64, VP, I32, VP],
}, "cs_band_xchg_error_string")

_BUFFERS: dict = {}
_LOCK = threading.Lock()
_DIAG: list = []  # [(record, address)] once allocated


def _check(err: int, what: str):
    if err != 0:
        msg = LIB.build().cs_band_xchg_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _host_words(n: int):
    """``n`` zeroed 64-bit words of host memory mapped for the device: the
    ctypes array and its address (also the device's)."""
    ptr = VP()
    _check(LIB.build().cs_sym_host_alloc(8 * n, ctypes.byref(ptr)),
           "cudaHostAlloc of mapped host memory")
    return (ctypes.c_longlong * n).from_address(ptr.value), ptr.value


def _diag() -> int:
    """The address of this process's host-mapped timeout record (8 int64,
    allocated at the first call)."""
    with _LOCK:
        if not _DIAG:
            _DIAG.append(_host_words(_DIAG_LEN))
        return _DIAG[0][1]


def _record(rank, epoch, counter, seen, want, timeout_ns, kernel):
    """Write the timeout record, unless one is there (the first stays)."""
    _diag()
    rec = _DIAG[0][0]
    if rec[0] == 0:
        rec[1:_DIAG_LEN] = [rank, epoch, counter, seen, want, timeout_ns, kernel]
        rec[0] = 1


def timeout_error():
    """The error of this process's first exchange wait that ran out, or
    None."""
    if not _DIAG or _DIAG[0][0][0] == 0:
        return None
    _, rank, epoch, counter, seen, want, timeout_ns, kernel = _DIAG[0][0]
    if kernel in _COLLECTIVES:
        return _collective_error(rank, epoch, counter, seen, want, timeout_ns, kernel)
    name = _COUNTERS[counter] if counter < len(_COUNTERS) else str(counter)
    head = (f"band-row exchange timed out in kernel #{kernel} on the rank at coordinate "
            f"{rank}: epoch {epoch}, ")
    if counter in _GAVE_UP:
        return RuntimeError(
            head + f"where {_GAVE_UP[counter]}'s wait ran out after {timeout_ns / 1e9:g} s "
            f"(counter {counter} at {seen}); a rank of the ring did not reach this call, whose "
            "outputs are garbage")
    return RuntimeError(
        head + f"after {timeout_ns / 1e9:g} s waiting on {name} (counter {counter}) at "
        f"{seen}, want >= {want}; a neighbour did not reach this call, whose outputs are "
        "garbage")


# the group buffers' records: the kernel field names the collective, the
# counter field the counter by kind and coordinate (kind * 100 + coordinate)
_COLLECTIVES = {20: "ppermute", 21: "all_gather", 22: "psum"}
ARRIVED_CODE, CONSUMED_CODE, GAVE_UP_CODE = 100, 200, 300


def _collective_error(rank, epoch, counter, seen, want, timeout_ns, kernel):
    kind, coord = divmod(counter, 100)
    op = _COLLECTIVES[kernel]
    head = f"collective {op} timed out on rank {rank}: epoch {epoch}, "
    if kind * 100 == GAVE_UP_CODE:
        return RuntimeError(
            head + f"where the wait of the rank at coordinate {coord} of the group ran out "
            f"(its give-up counter GAVE_UP[{coord}], counter {counter}, at {seen}); a rank of "
            "the group did not reach this call, whose outputs are garbage")
    what = {ARRIVED_CODE: f"the arrival of the slab of the rank at coordinate {coord} "
                          f"(ARRIVED[{coord}])",
            CONSUMED_CODE: f"the read of my slab by the rank at coordinate {coord} "
                           f"(CONSUMED[{coord}])"}[kind * 100]
    return RuntimeError(
        head + f"after {timeout_ns / 1e9:g} s waiting on {what}, counter {counter}, at "
        f"{seen}, want >= {want}; a rank of the group did not reach this call, whose "
        "outputs are garbage")


@dataclasses.dataclass
class _Entry:
    """One call's waits, as the watchdog holds them."""

    ticket: int
    epoch: int
    kernel: int
    targets: tuple  # ((counter, want), ...)
    start: float
    bound: float


class Watchdog:
    """Bounds the stream waits of the calls in flight.  Each ring hands it
    one entry per call (:meth:`add`); the ring's ``passed()`` is the last
    ticket its stream wrote.  An entry expires ``bound`` seconds after the
    later of its start and the ring's last progress (a ticket that came);
    then ``ring.give_up(entry, pending)`` records it and releases the
    stream (False: the counters show every wait met, nothing to release)
    and from then on every entry of every ring is released at the next
    :meth:`poll` (``ring.release(pending)``).  ``clock`` is the time source
    (seconds); :meth:`poll` is what the thread runs every ``period``
    seconds while entries are in flight."""

    def __init__(self, clock=time.monotonic, period: float = _POLL_S):
        self.clock = clock
        self.period = period
        self.fired = False
        self._pending: dict = {}  # ring -> deque of _Entry
        self._progress: dict = {}  # ring -> (last ticket seen, when)
        self._cond = threading.Condition()
        self._thread = None

    def add(self, ring, ticket: int, epoch: int, kernel: int, targets, bound: float):
        with self._cond:
            self._pending.setdefault(ring, collections.deque()).append(
                _Entry(ticket, epoch, kernel, tuple(targets), self.clock(), bound))
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="band-xchg-watchdog",
                                                daemon=True)
                self._thread.start()
            self._cond.notify()

    def forget(self, ring):
        with self._cond:
            self._pending.pop(ring, None)
            self._progress.pop(ring, None)

    def in_flight(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._pending.values())

    def poll(self):
        """Drop the entries whose tickets came; give up on the oldest entry
        of a ring past its deadline; after a give-up, release every entry."""
        now = self.clock()
        expired, pending = [], []
        with self._cond:
            for ring, queue in list(self._pending.items()):
                passed = ring.passed()
                last, _ = self._progress.get(ring, (0, now))
                if passed > last:
                    self._progress[ring] = (passed, now)
                while queue and queue[0].ticket <= passed:
                    queue.popleft()
                if not queue:
                    del self._pending[ring]
                    continue
                head = queue[0]
                since = max(head.start, self._progress.get(ring, (0, head.start))[1])
                if self.fired:
                    pending.append((ring, list(queue)))
                elif now - since > head.bound:
                    expired.append((ring, list(queue)))
        for ring, queue in expired:
            if ring.give_up(queue[0], queue):
                self.fired = True
        if self.fired:
            for ring, queue in pending:
                ring.release(queue)

    def _run(self):
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
            time.sleep(self.period)
            try:
                self.poll()
            except Exception:  # a dead context: the callers' own CUDA calls raise
                pass


WATCHDOG = Watchdog()


@dataclasses.dataclass(frozen=True)
class Call:
    """One call of the protocol: its epoch, the consumed epoch its sender
    waits for (0: none), and the ticket it writes once its waits passed."""

    epoch: int
    consumed: int
    ticket: int

    @property
    def parity(self) -> int:
        return self.epoch % 2


def _memops_ok(device: int):
    ok = I32()
    err = LIB.build().cs_sym_memops(device, ctypes.byref(ok))
    if err != 0 or not ok.value:
        why = (LIB.build().cs_band_xchg_error_string(err).decode() if err
               else "the attribute is 0")
        raise RuntimeError(
            f"band-row exchange: device {device} lacks 64-bit stream memory operations "
            f"(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS: {why}); the exchange "
            "kernels' waits are cuStreamWaitValue64")


def _exchange(group, size: int, handle: bytes):
    """Every rank's (IPC handle, host name) in ``group``, in coordinate
    order: one ``all_gather`` of a uint8 tensor (gloo)."""
    host = socket.gethostname().encode()[:_HOST]
    mine = torch.zeros(_HANDLE + _HOST, dtype=torch.uint8)
    mine[:_HANDLE] = torch.frombuffer(bytearray(handle), dtype=torch.uint8)
    mine[_HANDLE : _HANDLE + len(host)] = torch.frombuffer(bytearray(host), dtype=torch.uint8)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine, group=group)
    return [(bytes(p[:_HANDLE].tolist()), bytes(p[_HANDLE:].tolist()).rstrip(b"\0"))
            for p in parts]


def _open_peer(device: int, peer, coord: int, rank: int, what: str, who: str) -> int:
    """Map the buffer of the peer at ``coord`` (global ``rank``) from its
    (handle, host): its address here.  Raises with the reason where the
    peer runs on another host or CUDA refuses the handle."""
    handle, host = peer
    here = socket.gethostname().encode()[:_HOST]
    if host != here:
        raise RuntimeError(
            f"{what}: the {who} at coordinate {coord} (rank {rank}) runs on host "
            f"{host.decode()!r}, not {here.decode()!r}; CUDA IPC maps buffers between "
            "processes of one host only"
        )
    lib = LIB.build()
    p = VP()
    err = lib.cs_sym_open(device, handle, ctypes.byref(p))
    if err != 0:
        raise RuntimeError(
            f"{what}: cudaIpcOpenMemHandle refused the buffer of the {who} at coordinate "
            f"{coord} (rank {rank}): {lib.cs_band_xchg_error_string(err).decode()} ({err}); "
            "the ranks must share a host, and the card's compute mode must allow several "
            "processes"
        )
    return p.value


def _free(buf):
    """Close ``buf``'s mappings of its peers' buffers and free its own,
    collectively: after every rank's work has finished (a barrier), and the
    frees after every rank has closed its mappings (a second one)."""
    lib = LIB.build()
    try:
        torch.cuda.synchronize(buf.device)
        lost = False
    except RuntimeError:  # the context is gone: nothing to close or free
        lost = True
    WATCHDOG.forget(buf)
    dist.barrier(group=buf.group)
    for p in buf._opened:
        if not lost:
            _check(lib.cs_sym_close(buf.device, p), "cudaIpcCloseMemHandle")
    buf._opened = []
    dist.barrier(group=buf.group)
    if not lost:
        _check(lib.cs_sym_free(buf.device, buf.me), "cudaFree of a symmetric buffer")
    buf.me = None
    buf.cap = 0


def _grow(buf, slab_bytes: int, library: CudaLibrary, memops: bool = True):
    """The common part of a buffer's ``reserve``: load ``library`` (behind
    a barrier), and where ``slab_bytes`` outgrows the slots, free the old
    buffer and allocate one whose slots hold a power of two from 64 KB.
    Returns the new buffer's IPC handle, or None where nothing grew."""
    if library._lib is None:
        library.build()
        dist.barrier(group=buf.group)
    if slab_bytes <= buf.cap:
        return None
    cap = max(_MIN_SLOT, 1 << (int(slab_bytes) - 1).bit_length())
    lib = LIB.build()
    if memops:
        _memops_ok(buf.device)
    if buf._ticket is None:
        buf._ticket = _host_words(1)
    if buf.me is not None:
        buf._release()
    ptr, handle = VP(), ctypes.create_string_buffer(_HANDLE)
    size = buf.buffer_bytes(cap)
    _check(lib.cs_sym_alloc(buf.device, size, ctypes.byref(ptr), handle),
           f"cudaMalloc/cudaIpcGetMemHandle of {size} bytes")
    buf.me, buf.cap = ptr.value, cap
    buf._reset_calls()
    return handle.raw


class RingBuffer:
    """This rank's buffer for the ring of one mesh dimension, and its two
    neighbours' buffers mapped here.  Made by :func:`ring_buffer`; ``kind``
    ``"v1"`` (the first design's timing rows) and ``"probe"``
    (``tools/xchg_probe.py``) get buffers of their own."""

    def __init__(self, group, device: torch.device, kind: str = "call"):
        self.group = group
        self.kind = kind
        self.ranks = dist.get_process_group_ranks(group)
        self.size = len(self.ranks)
        self.coord = self.ranks.index(dist.get_rank())
        self.device = device.index if device.index is not None else torch.cuda.current_device()
        self.cap = 0  # bytes of each slot
        self.epoch = 0  # calls so far; never reset
        self.sent = U64(0)  # v1: SENT target of the last call (reset with the buffer)
        self.me = self.right = self.left = None
        self._opened: list[int] = []
        self._reset_calls()
        self._ticket = None  # (host-mapped word, address), made with the buffer
        self.tickets = 0  # tickets handed out
        self.last_kernel = 0

    def _reset_calls(self):
        self.last_use = [0, 0]  # per parity: the last epoch that used its slots
        self.last_epoch = 0  # the last call on this buffer
        self.flushed = 0  # the last epoch check_timeouts waited to be consumed
        self.gave_up_seen = 0  # the last neighbour give-up already raised

    @staticmethod
    def buffer_bytes(cap: int) -> int:
        """Bytes of a buffer whose slots hold ``cap`` each: the counters and
        four slots."""
        return _HEADER + _SLOTS * cap

    @staticmethod
    def slot_offset(parity: int, above: bool, cap: int) -> int:
        """Where the ``below`` (or ``above``) slot of ``parity`` starts."""
        return _HEADER + (2 * parity + int(above)) * cap

    @staticmethod
    def counter_offset(counter: int) -> int:
        return counter * _LINE

    def reserve(self, slot_bytes: int, library: CudaLibrary):
        """Grow the slots to hold ``slot_bytes`` each (a power of two from
        64 KB), and load the kernel's ``library``.  Collective where either
        happens: every rank of the dimension calls it with the same size
        and library.  A library is loaded behind a barrier, so that no rank
        is still compiling while its neighbours' calls wait for it."""
        handle = _grow(self, slot_bytes, library, memops=self.kind != "v1")
        if handle is None:
            return
        self.sent = U64(0)
        peers = _exchange(self.group, self.size, handle)
        right, left = (self.coord + 1) % self.size, (self.coord - 1) % self.size
        mapped = {c: _open_peer(self.device, peers[c], c, self.ranks[c], "band-row exchange",
                                "neighbour") for c in {right, left}}
        self._opened += list(mapped.values())
        self.right, self.left = mapped[right], mapped[left]

    def next_call(self) -> Call:
        """Number the next call: its epoch, the consumed epoch its sender
        waits for (the last that used its parity's slots) and its ticket."""
        self.epoch += 1
        self.tickets += 1
        p = self.epoch % 2
        call = Call(self.epoch, self.last_use[p], self.tickets)
        self.last_use[p] = self.last_epoch = self.epoch
        return call

    def launch_args(self, call: Call) -> tuple:
        """``(me, right, left, cap, epoch, consumed, ticket address, ticket,
        lag_ns)`` for a launch of ``call``."""
        return (self.me, self.right, self.left, self.cap, call.epoch, call.consumed,
                self._ticket[1], call.ticket, READ_LAG_NS)

    def watch(self, call: Call, kernel: int, below: bool = True, above: bool = True):
        """Bound ``call``'s waits, once it is enqueued: the consumed epoch
        and the arrivals it waits for (``below``, ``above``)."""
        self.last_kernel = kernel
        targets = []
        if call.consumed:
            targets += [(CONSUMED_BY_RIGHT, call.consumed), (CONSUMED_BY_LEFT, call.consumed)]
        targets += [(c, call.epoch) for c, on in ((ARRIVED_BELOW, below), (ARRIVED_ABOVE, above))
                    if on]
        WATCHDOG.add(self, call.ticket, call.epoch, kernel, targets, SPIN_TIMEOUT_S)

    def ring(self):
        """v1: the next call's ``(me, right, left, cap, epoch, sent,
        timeout_ns, diag, coord)`` for a launch of a first-design kernel
        (``sent`` by reference: the launch raises it)."""
        self.epoch += 1
        return (self.me, self.right, self.left, self.cap, self.epoch, ctypes.byref(self.sent),
                int(SPIN_TIMEOUT_S * 1e9), _diag(), self.coord)

    # -- the watchdog's side --

    def passed(self) -> int:
        return self._ticket[0][0] if self._ticket is not None else 0

    def counters(self) -> list:
        """My counters, read on the side stream (the caller's may be held)."""
        out = (ctypes.c_ulonglong * (_NCOUNTERS * _LINE // 8))()
        _check(LIB.build().cs_sym_side_read(self.device, self.me, ctypes.addressof(out),
                                            ctypes.sizeof(out)), "reading the ring's counters")
        return [out[c * _LINE // 8] for c in range(_NCOUNTERS)]

    def _side_write(self, base: int, counter: int, value: int):
        _check(LIB.build().cs_sym_side_write(self.device, base + self.counter_offset(counter),
                                             value), "releasing a band-row exchange wait")

    def give_up(self, entry: _Entry, pending) -> bool:
        """``entry``'s waits ran out: record the first unmet one, tell both
        neighbours, release every pending call.  False when every wait is
        met after all (the stream is late, not stuck)."""
        seen = self.counters()
        unmet = [(c, want) for c, want in entry.targets if seen[c] < want]
        if not unmet:
            return False
        c, want = unmet[0]
        _record(self.coord, entry.epoch, c, seen[c], want, int(entry.bound * 1e9), entry.kernel)
        self._side_write(self.right, GAVE_UP_LEFT, entry.epoch)
        self._side_write(self.left, GAVE_UP_RIGHT, entry.epoch)
        self.release(pending, seen)
        return True

    def release(self, pending, seen=None):
        """Write every awaited value of the ``pending`` calls that my
        counters have not reached, from the side stream."""
        seen = self.counters() if seen is None else seen
        want: dict = {}
        for entry in pending:
            for c, w in entry.targets:
                want[c] = max(want.get(c, 0), w)
        for c, w in sorted(want.items()):
            if seen[c] < w:
                self._side_write(self.me, c, w)

    # -- check_timeouts' side --

    def flush(self):
        """Enqueue, on the current stream, a wait until both neighbours
        have consumed my rows of the last call (bounded as a call)."""
        if self.kind != "call" or self.me is None or self.last_epoch <= self.flushed:
            return
        e = self.flushed = self.last_epoch
        lib = LIB.build()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        self.tickets += 1
        for c in (CONSUMED_BY_RIGHT, CONSUMED_BY_LEFT):
            _check(lib.cs_sym_wait(self.me + self.counter_offset(c), e, stream),
                   "cuStreamWaitValue64")
        _check(lib.cs_sym_write(self._ticket[1], self.tickets, stream), "cuStreamWriteValue64")
        WATCHDOG.add(self, self.tickets, e, self.last_kernel,
                     [(CONSUMED_BY_RIGHT, e), (CONSUMED_BY_LEFT, e)], SPIN_TIMEOUT_S)

    def check_neighbours(self):
        """Record a neighbour's give-up not raised yet (after the device
        has finished)."""
        if self.kind != "call" or self.me is None:
            return
        seen = self.counters()
        for c in _GAVE_UP:
            if seen[c] > self.gave_up_seen:
                self.gave_up_seen = seen[c]
                _record(self.coord, seen[c], c, seen[c], seen[c],
                        int(SPIN_TIMEOUT_S * 1e9), self.last_kernel)

    def _release(self):
        _free(self)
        self.right = self.left = None


MAX_GROUP = 16  # ranks of a group buffer (cs_collectives.cu::MAX_PEERS)


@dataclasses.dataclass(frozen=True)
class GroupCall:
    """One collective on a :class:`GroupBuffer`: its epoch and ticket, the
    coordinates it stores into (``dests``) with the consumed epoch it waits
    for at each (0: none), and the coordinates it reads from the slots
    (``sources``; never this rank's own)."""

    epoch: int
    ticket: int
    dests: tuple
    consumed: tuple
    sources: tuple

    @property
    def parity(self) -> int:
        return self.epoch % 2


class GroupBuffer:
    """This rank's buffer for the collectives of one process group, and
    every peer's buffer mapped here: ``csrc/cs_collectives.cu``'s layout,
    counters ``ARRIVED[s]`` (line ``s``), ``CONSUMED[d]`` (line ``S + d``)
    and ``GAVE_UP[s]`` (line ``2S + s``), then the slots ``[parity][source]``.
    Made by :func:`group_buffer`."""

    kind = "group"

    def __init__(self, group, device: torch.device):
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.size = len(self.ranks)
        if self.size > MAX_GROUP:
            raise ValueError(f"device collectives: a group of {self.size} ranks; the kernels "
                             f"take at most {MAX_GROUP}")
        self.coord = self.ranks.index(dist.get_rank())
        self.device = device.index if device.index is not None else torch.cuda.current_device()
        self.cap = 0  # bytes of each slot
        self.epoch = 0  # calls so far; never reset
        self.me = None
        self.peers: list = [None] * self.size  # every buffer's base here (mine at coord)
        self._opened: list[int] = []
        self._ticket = None
        self.tickets = 0
        self.last_kernel = 20
        self._reset_calls()

    def _reset_calls(self):
        S = self.size
        self.last_use = [[0] * S, [0] * S]  # [parity][dest]: last epoch stored there
        self.last_sent = [0] * S  # per dest: the last epoch stored into its slots
        self.flushed = [0] * S  # per dest: the last epoch check_timeouts waited for
        self.gave_up_seen = [0] * S

    # -- the layout --

    @staticmethod
    def header_bytes(size: int) -> int:
        """The counters: three lines a rank, rounded up to 1 KB."""
        return -(-3 * size * _LINE // 1024) * 1024

    def buffer_bytes(self, cap: int) -> int:
        return self.header_bytes(self.size) + 2 * self.size * cap

    def arrived(self, c: int) -> int:
        return c

    def consumed_line(self, c: int) -> int:
        return self.size + c

    def gave_up(self, c: int) -> int:
        return 2 * self.size + c

    @staticmethod
    def slot_offset(parity: int, source: int, cap: int, size: int) -> int:
        return GroupBuffer.header_bytes(size) + (parity * size + source) * cap

    def code(self, line: int) -> int:
        """A counter line as the timeout record names it."""
        kind, c = divmod(line, self.size)
        return (ARRIVED_CODE, CONSUMED_CODE, GAVE_UP_CODE)[kind] + c

    def reserve(self, slab_bytes: int, library: CudaLibrary):
        """Grow the slots to hold ``slab_bytes`` each and load
        ``library``: collective where either happens (every rank of the
        group calls it with the same size).  Maps every peer's buffer."""
        handle = _grow(self, slab_bytes, library)
        if handle is None:
            return
        peers = _exchange(self.group, self.size, handle)
        self.peers = [self.me if c == self.coord else
                      _open_peer(self.device, peers[c], c, self.ranks[c], "device collectives",
                                 "rank") for c in range(self.size)]
        self._opened += [p for c, p in enumerate(self.peers) if c != self.coord]

    # -- one call --

    def next_call(self, dests, sources) -> GroupCall:
        """Number the next call, which stores this rank's slab into the
        slots of ``dests`` and reads those of ``sources`` (coordinates, this
        rank's own left out)."""
        self.epoch += 1
        self.tickets += 1
        e, p = self.epoch, self.epoch % 2
        dests = tuple(d for d in dests if d != self.coord)
        consumed = tuple(self.last_use[p][d] for d in dests)
        for d in dests:
            self.last_use[p][d] = self.last_sent[d] = e
        return GroupCall(e, self.tickets, dests, consumed,
                         tuple(s for s in sources if s != self.coord))

    def address(self, coord: int, line: int) -> int:
        """The counter ``line`` in the buffer of the rank at ``coord``."""
        return self.peers[coord] + line * _LINE

    def slot(self, coord: int, parity: int, source: int) -> int:
        """Slot ``[parity][source]`` in the buffer of the rank at ``coord``."""
        return self.peers[coord] + self.slot_offset(parity, source, self.cap, self.size)

    def ticket(self) -> int:
        return self._ticket[1]

    def watch(self, call: GroupCall, kernel: int):
        """Bound ``call``'s waits once it is enqueued: the consumed epochs
        of its destinations and the arrivals of its sources."""
        self.last_kernel = kernel
        targets = [(self.consumed_line(d), w) for d, w in zip(call.dests, call.consumed) if w]
        targets += [(self.arrived(s), call.epoch) for s in call.sources]
        WATCHDOG.add(self, call.ticket, call.epoch, kernel, targets, SPIN_TIMEOUT_S)

    # -- the watchdog's side --

    def passed(self) -> int:
        return self._ticket[0][0] if self._ticket is not None else 0

    def counters(self) -> list:
        n = 3 * self.size
        out = (ctypes.c_ulonglong * (n * _LINE // 8))()
        _check(LIB.build().cs_sym_side_read(self.device, self.me, ctypes.addressof(out),
                                            ctypes.sizeof(out)), "reading a group's counters")
        return [out[c * _LINE // 8] for c in range(n)]

    def _side_write(self, addr: int, value: int):
        _check(LIB.build().cs_sym_side_write(self.device, addr, value),
               "releasing a device collective's wait")

    def give_up(self, entry: _Entry, pending) -> bool:
        """``entry``'s waits ran out: record the first unmet one, tell every
        peer, release every pending call.  False when every wait is met
        after all."""
        seen = self.counters()
        unmet = [(c, want) for c, want in entry.targets if seen[c] < want]
        if not unmet:
            return False
        c, want = unmet[0]
        _record(self.ranks[self.coord], entry.epoch, self.code(c), seen[c], want,
                int(entry.bound * 1e9), entry.kernel)
        for p in range(self.size):
            if p != self.coord:
                self._side_write(self.address(p, self.gave_up(self.coord)), entry.epoch)
        self.release(pending, seen)
        return True

    def release(self, pending, seen=None):
        """Write every awaited value of the ``pending`` calls that my
        counters have not reached, from the side stream."""
        seen = self.counters() if seen is None else seen
        want: dict = {}
        for entry in pending:
            for c, w in entry.targets:
                want[c] = max(want.get(c, 0), w)
        for c, w in sorted(want.items()):
            if seen[c] < w:
                self._side_write(self.me + c * _LINE, w)

    # -- check_timeouts' side --

    def flush(self):
        """Enqueue, on the current stream, a wait until every destination
        has read the last slab this rank stored into its slots (bounded as
        a call)."""
        if self.me is None:
            return
        waits = [(self.consumed_line(d), e) for d, e in enumerate(self.last_sent)
                 if e > self.flushed[d]]
        if not waits:
            return
        self.flushed = list(self.last_sent)
        lib = LIB.build()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        self.tickets += 1
        for line, e in waits:
            _check(lib.cs_sym_wait(self.me + line * _LINE, e, stream), "cuStreamWaitValue64")
        _check(lib.cs_sym_write(self._ticket[1], self.tickets, stream), "cuStreamWriteValue64")
        WATCHDOG.add(self, self.tickets, max(e for _, e in waits), self.last_kernel, waits,
                     SPIN_TIMEOUT_S)

    def check_neighbours(self):
        """Record a peer's give-up not raised yet (after the device has
        finished)."""
        if self.me is None:
            return
        seen = self.counters()
        for s in range(self.size):
            got = seen[self.gave_up(s)]
            if got > self.gave_up_seen[s]:
                self.gave_up_seen[s] = got
                _record(self.ranks[self.coord], got, GAVE_UP_CODE + s, got, got,
                        int(SPIN_TIMEOUT_S * 1e9), self.last_kernel)

    def _release(self):
        _free(self)
        self.peers = [None] * self.size


class RemoteCopyKernel(KernelWrapper):
    """A kernel wrapper whose launch joins the protocol of these buffers:
    after a wait of an earlier call ran out, it raises that timeout in
    place of launching."""

    def _launch(self, fn_name, dev, *args, sizes: int = 6):
        err = timeout_error()
        if err is not None:
            raise err
        super()._launch(fn_name, dev, *args, sizes=sizes)


def check_timeouts():
    """Raise :func:`timeout_error` when an exchange or collective wait of
    this process, or of a peer, ran out, once the device has finished the
    work given to it and the peers have consumed this rank's last slabs."""
    with _LOCK:
        rings = [b for b in _BUFFERS.values()
                 if b.me is not None and b.kind in ("call", "group")]
    if not rings and not _DIAG:
        return
    for ring in rings:
        ring.flush()
    torch.cuda.synchronize()
    for ring in rings:
        ring.check_neighbours()
    err = timeout_error()
    if err is not None:
        raise err


def ring_buffer(mesh, axis_name: str, device, kind: str = "call") -> RingBuffer:
    """This rank's :class:`RingBuffer` of ``kind`` for dimension
    ``axis_name`` of ``mesh`` on ``device`` (made on first use; collective
    then only through the first :meth:`~RingBuffer.reserve`)."""
    group = mesh.get_group(axis_name)
    dev = torch.device(device)
    key = (tuple(dist.get_process_group_ranks(group)),
           dev.index if dev.index is not None else torch.cuda.current_device(), kind)
    with _LOCK:
        if key not in _BUFFERS:
            _BUFFERS[key] = RingBuffer(group, dev, kind)
        return _BUFFERS[key]


def group_buffer(group, device) -> GroupBuffer:
    """This rank's :class:`GroupBuffer` for the process ``group`` on
    ``device`` (made on first use; collective then only through the first
    :meth:`~GroupBuffer.reserve`).  Groups of the same ranks share it."""
    dev = torch.device(device)
    key = (tuple(dist.get_process_group_ranks(group)),
           dev.index if dev.index is not None else torch.cuda.current_device(), "group")
    with _LOCK:
        if key not in _BUFFERS:
            _BUFFERS[key] = GroupBuffer(group, dev)
        return _BUFFERS[key]


def release_all():
    """Close and free every ring and group buffer of this process: a
    collective call of every rank that made one, at the end of the process
    group (in the order of their ranks, the same on every rank)."""
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
