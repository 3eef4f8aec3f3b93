"""The host's half of the band-row exchange protocol (``parallel/
symmetric.py``), with no CUDA: the slots in two parities and the offsets a
launch gets, the counters each call's waits target, the 4-slot buffer that
``reserve`` allocates, and the watchdog that bounds the stream waits, on a
fake clock.  The kernels themselves run in ``tests/test_torch_cuda.py``.
"""

import ctypes
import types

import pytest
import torch

from dlwp_cs_tpu_torch.parallel import symmetric
from dlwp_cs_tpu_torch.parallel.symmetric import (
    ARRIVED_ABOVE,
    ARRIVED_BELOW,
    CONSUMED_BY_LEFT,
    CONSUMED_BY_RIGHT,
    GAVE_UP_LEFT,
    GAVE_UP_RIGHT,
    RingBuffer,
    Watchdog,
)


class _FakeLib:
    """The entry points ``reserve`` calls, recording the sizes; host words
    are ctypes arrays kept alive here."""

    def __init__(self):
        self.allocs, self.opened, self.keep = [], [], []
        self.next_ptr = 1 << 40

    def build(self):
        return self

    def cs_sym_memops(self, device, ok):
        ok._obj.value = 1
        return 0

    def cs_sym_host_alloc(self, nbytes, ptr):
        words = (ctypes.c_longlong * (nbytes // 8))()
        self.keep.append(words)
        ptr._obj.value = ctypes.addressof(words)
        return 0

    def cs_sym_alloc(self, device, nbytes, ptr, handle):
        self.allocs.append(nbytes)
        ptr._obj.value = self.next_ptr
        self.next_ptr += 1 << 32
        return 0

    def cs_sym_open(self, device, handle, ptr):
        ptr._obj.value = self.next_ptr + len(self.opened)
        self.opened.append(handle)
        return 0


def _fake_dist(world, rank):
    def all_gather(parts, mine, group=None):
        for p in parts:
            p.copy_(mine)

    return types.SimpleNamespace(
        get_process_group_ranks=lambda group: list(range(world)),
        get_rank=lambda: rank, barrier=lambda group=None: None, all_gather=all_gather)


class _Recorder:
    """Stands in for the process's watchdog: the entries handed to it."""

    def __init__(self):
        self.entries = []

    def add(self, ring, ticket, epoch, kernel, targets, bound):
        self.entries.append((ticket, epoch, kernel, dict(targets), bound))


@pytest.fixture
def ring(monkeypatch):
    """Rank 1 of a ring of 4, its buffer reserved through the fake entry
    points (no CUDA, no process group)."""
    lib = _FakeLib()
    monkeypatch.setattr(symmetric, "LIB", lib)
    monkeypatch.setattr(symmetric, "dist", _fake_dist(4, 1))
    monkeypatch.setattr(symmetric, "WATCHDOG", _Recorder())
    monkeypatch.setattr(symmetric, "_DIAG", [])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    buf = RingBuffer(object(), torch.device("cuda", 0))
    buf.lib = lib
    return buf


def test_slots_come_in_two_parities_after_the_counters():
    cap = 1 << 16
    offsets = {(p, above): RingBuffer.slot_offset(p, above, cap)
               for p in (0, 1) for above in (False, True)}
    assert offsets == {(0, False): 2048, (0, True): 2048 + cap,
                       (1, False): 2048 + 2 * cap, (1, True): 2048 + 3 * cap}
    assert RingBuffer.buffer_bytes(cap) == 2048 + 4 * cap == max(offsets.values()) + cap
    # every counter on a 128-byte line of its own, inside the header
    lines = [RingBuffer.counter_offset(c) for c in range(symmetric._NCOUNTERS)]
    assert lines == [128 * c for c in range(symmetric._NCOUNTERS)]
    assert lines[-1] + 128 <= 2048


@pytest.mark.parametrize("slot_bytes,cap", [(1, 1 << 16), (1 << 16, 1 << 16),
                                            ((1 << 16) + 1, 1 << 17), (3 << 20, 4 << 20)])
def test_reserve_allocates_the_counters_and_four_slots(ring, slot_bytes, cap):
    lib = ring.lib
    library = types.SimpleNamespace(_lib=object())
    ring.reserve(slot_bytes, library)
    assert ring.cap == cap
    assert lib.allocs == [2048 + 4 * cap]
    assert len(lib.opened) == 2  # the two neighbours of a ring of 4
    ring.reserve(slot_bytes, library)  # no growth: no collective, no allocation
    assert lib.allocs == [2048 + 4 * cap]


def test_reserve_maps_one_peer_on_a_ring_of_two(monkeypatch, ring):
    monkeypatch.setattr(symmetric, "dist", _fake_dist(2, 0))
    buf = RingBuffer(object(), torch.device("cuda", 0))
    buf.reserve(10, types.SimpleNamespace(_lib=object()))
    assert buf.right == buf.left and len(ring.lib.opened) == 1


def test_calls_alternate_parities_and_wait_for_the_last_use_of_theirs(ring):
    ring.reserve(1000, types.SimpleNamespace(_lib=object()))
    calls = [ring.next_call() for _ in range(6)]
    assert [c.epoch for c in calls] == [1, 2, 3, 4, 5, 6]
    assert [c.parity for c in calls] == [1, 0, 1, 0, 1, 0]
    # the sender of e waits until the neighbours consumed e - 2 (none before 3)
    assert [c.consumed for c in calls] == [0, 0, 1, 2, 3, 4]
    assert [c.ticket for c in calls] == [1, 2, 3, 4, 5, 6]
    me, right, left, cap, epoch, consumed, ticket, value, lag = ring.launch_args(calls[3])
    assert (me, right, left, cap) == (ring.me, ring.right, ring.left, ring.cap)
    assert (epoch, consumed, value, lag) == (4, 2, 4, 0) and ticket == ring._ticket[1]


def test_a_new_buffer_starts_its_parities_afresh(ring):
    ring.reserve(1000, types.SimpleNamespace(_lib=object()))
    for _ in range(3):
        ring.next_call()
    ring._release = lambda: None  # the collective free of the old buffer
    ring.reserve(1 << 20, types.SimpleNamespace(_lib=object()))
    call = ring.next_call()
    assert (call.epoch, call.consumed) == (4, 0)  # epochs go on; no slot of it used yet
    assert [ring.next_call().consumed for _ in range(3)] == [0, 4, 5]


def test_each_call_watches_its_consumed_and_arrival_counters(ring):
    ring.reserve(1000, types.SimpleNamespace(_lib=object()))
    for e in range(1, 5):
        ring.watch(ring.next_call(), 10)
    last = ring.next_call()
    ring.watch(last, 11, below=False)  # the first shard of #11 reads no `below`
    entries = symmetric.WATCHDOG.entries
    assert [(t, e, k) for t, e, k, _, _ in entries] == [(1, 1, 10), (2, 2, 10), (3, 3, 10),
                                                         (4, 4, 10), (5, 5, 11)]
    assert entries[0][3] == {ARRIVED_BELOW: 1, ARRIVED_ABOVE: 1}
    assert entries[3][3] == {CONSUMED_BY_RIGHT: 2, CONSUMED_BY_LEFT: 2, ARRIVED_BELOW: 4,
                             ARRIVED_ABOVE: 4}
    assert entries[4][3] == {CONSUMED_BY_RIGHT: 3, CONSUMED_BY_LEFT: 3, ARRIVED_ABOVE: 5}
    assert all(bound == symmetric.SPIN_TIMEOUT_S for *_, bound in entries)


class _FakeRing:
    """What the watchdog asks of a ring: the last ticket passed, and what it
    does on giving up and releasing."""

    def __init__(self, name, met=False):
        self.name, self.ticket, self.met = name, 0, met
        self.gave_up, self.released = [], []

    def passed(self):
        return self.ticket

    def give_up(self, entry, pending):
        if self.met:
            return False
        self.gave_up.append((entry.epoch, [e.ticket for e in pending]))
        return True

    def release(self, pending):
        self.released.append([e.ticket for e in pending])


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_watchdog_gives_up_after_the_bound_and_then_releases_everything():
    clock = _Clock()
    dog = Watchdog(clock=clock)
    dog._thread = object()  # polled by hand here, no thread
    a, b = _FakeRing("a"), _FakeRing("b")
    for t in (1, 2, 3):
        dog.add(a, t, t, 10, [(ARRIVED_BELOW, t)], bound=2.0)
    dog.add(b, 1, 7, 11, [(ARRIVED_ABOVE, 7)], bound=2.0)
    clock.now += 1.0
    a.ticket = 1  # a's first call passed: progress restarts its clock
    dog.poll()
    assert dog.in_flight() == 3 and not a.gave_up
    clock.now += 1.5  # 2.5 s after b's start, 1.5 s after a's progress
    dog.poll()
    assert b.gave_up == [(7, [1])] and not a.gave_up and dog.fired
    dog.poll()  # after a give-up every call in flight is released at once
    assert a.released == [[2, 3]] and b.released == [[1]] and not a.gave_up
    a.ticket, b.ticket = 3, 1
    dog.poll()
    assert dog.in_flight() == 0


def test_watchdog_waits_on_while_the_counters_show_the_waits_met():
    clock = _Clock()
    dog = Watchdog(clock=clock)
    dog._thread = object()
    late = _FakeRing("late", met=True)
    dog.add(late, 1, 1, 10, [(ARRIVED_BELOW, 1)], bound=2.0)
    clock.now += 5.0
    dog.poll()
    assert not dog.fired and dog.in_flight() == 1  # late, not stuck
    late.ticket = 1
    dog.poll()
    assert dog.in_flight() == 0 and not dog.fired


def test_watchdog_deadline_starts_at_the_later_of_start_and_progress():
    clock = _Clock()
    dog = Watchdog(clock=clock)
    dog._thread = object()
    r = _FakeRing("r")
    dog.add(r, 1, 1, 10, [(ARRIVED_BELOW, 1)], bound=2.0)
    dog.add(r, 2, 2, 10, [(ARRIVED_BELOW, 2)], bound=2.0)
    clock.now += 1.9
    r.ticket = 1
    dog.poll()
    clock.now += 1.9  # 3.8 s after call 2 was enqueued, 1.9 s after call 1 passed
    dog.poll()
    assert not r.gave_up
    clock.now += 0.2
    dog.poll()
    assert r.gave_up == [(2, [2])]


def test_timeout_messages_name_the_rank_the_epoch_and_the_counter(monkeypatch):
    record = (ctypes.c_longlong * 8)()
    monkeypatch.setattr(symmetric, "_DIAG", [(record, ctypes.addressof(record))])
    assert symmetric.timeout_error() is None
    symmetric._record(2, 5, ARRIVED_ABOVE, 4, 5, 2_000_000_000, 10)
    symmetric._record(3, 9, ARRIVED_BELOW, 0, 9, 1, 11)  # the first record stays
    msg = str(symmetric.timeout_error())
    assert "timed out in kernel #10" in msg and "coordinate 2" in msg and "epoch 5" in msg
    assert "the +1 neighbour's bottom rows (above) (counter 3) at 4, want >= 5" in msg
    assert "after 2 s" in msg
    record[0] = 0
    for counter, who in ((GAVE_UP_LEFT, "-1"), (GAVE_UP_RIGHT, "+1")):
        record[0] = 0
        symmetric._record(1, 2, counter, 2, 2, 2_000_000_000, 11)
        msg = str(symmetric.timeout_error())
        assert "timed out in kernel #11" in msg and "coordinate 1" in msg and "epoch 2" in msg
        assert f"the {who} neighbour's wait ran out" in msg


def test_check_timeouts_without_a_ring_touches_no_device(monkeypatch):
    monkeypatch.setattr(symmetric, "_DIAG", [])
    monkeypatch.setattr(symmetric, "_BUFFERS", {})
    symmetric.check_timeouts()  # no CUDA here: it must not synchronise
