"""The host's half of the device collectives (``parallel/symmetric.py``'s
``GroupBuffer``, ``parallel/device_collectives.py``) and the transport
dispatch of ``parallel/collectives.py``, with no CUDA: a fake library for
the entry points, a fake process group and a fake clock.  The group
buffer's slots by parity and source, the epochs and the consumed waits,
``reserve``'s growth, the watchdog's coverage of the new waits and the
order in which a call enqueues the protocol's steps; which transport a
tensor takes.  The kernels run in ``tests/test_torch_cuda.py``; the plain
versions in ``tests/test_torch_parallel.py``'s group.
"""

import ctypes
import types

import pytest
import torch

from dlwp_cs_tpu_torch.parallel import collectives
from dlwp_cs_tpu_torch.parallel import device_collectives as dc
from dlwp_cs_tpu_torch.parallel import symmetric
from dlwp_cs_tpu_torch.parallel.symmetric import GroupBuffer, Watchdog

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

WORLD = 4


def _values(arr, n):
    return [int(v or 0) for v in list(arr)[:n]]


class _FakeSymLib:
    """The buffers' entry points: allocations, mappings, host words, and a
    side stream whose counter reads return ``counters`` and whose writes are
    recorded."""

    def __init__(self, refuse=()):
        self.allocs, self.opened, self.keep, self.ops = [], [], [], []
        self.next_ptr = 1 << 40
        self.refuse = set(refuse)  # handles cs_sym_open refuses
        self.counters = {}

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
        handle.raw = bytes([len(self.allocs)]) + bytes(63)
        self.next_ptr += 1 << 32
        return 0

    def cs_sym_open(self, device, handle, ptr):
        if handle[0] in self.refuse:
            return 201
        ptr._obj.value = (1 << 50) + (len(self.opened) << 32)
        self.opened.append(handle)
        return 0

    def cs_band_xchg_error_string(self, err):
        return b"invalid device context"

    def cs_sym_write(self, addr, value, stream):
        self.ops.append(("ticket", addr, value))
        return 0

    def cs_sym_wait(self, addr, value, stream):
        self.ops.append(("sym_wait", addr, value))
        return 0

    def cs_sym_side_read(self, device, src, dst, nbytes):
        words = (ctypes.c_ulonglong * (nbytes // 8)).from_address(dst)
        for line, v in self.counters.items():
            words[line * 16] = v
        return 0

    def cs_sym_side_write(self, device, addr, value):
        self.ops.append(("side_write", addr, value))
        return 0


class _FakeCollLib:
    """``cs_collectives.cu``'s entry points, recording what each enqueues."""

    _lib = object()  # built: reserve loads no library

    def __init__(self, sym):
        self.ops = sym.ops  # one order for both libraries

    def build(self):
        return self

    def cs_coll_wait(self, addrs, wants, n, stream):
        self.ops.append(("wait", list(zip(_values(addrs, n), _values(wants, n)))))
        return 0

    def cs_coll_signal(self, addrs, n, value, stream):
        self.ops.append(("signal", _values(addrs, n), value))
        return 0

    def cs_coll_send_launch(self, dev, x, nbytes, dsts, n, stream):
        self.ops.append(("send", x, nbytes, _values(dsts, n)))
        return 0

    def cs_coll_unpack_launch(self, dev, out, srcs, n, outer, inner, stream):
        self.ops.append(("unpack", _values(srcs, n), outer, inner))
        return 0

    def cs_coll_reduce_launch(self, dev, dtype, out, srcs, n, numel, stream):
        self.ops.append(("reduce", dtype, _values(srcs, n), numel))
        return 0

    def cs_collectives_error_string(self, err):
        return b"error"


def _fake_dist(world, rank, config="cpu:gloo,cuda:gloo"):
    def all_gather(parts, mine, group=None):
        for p in parts:
            p.copy_(mine)

    return types.SimpleNamespace(
        get_process_group_ranks=lambda group: list(range(world)),
        get_rank=lambda group=None: rank, get_world_size=lambda group=None: world,
        barrier=lambda group=None: None, all_gather=all_gather,
        get_backend_config=lambda group=None: config, group=types.SimpleNamespace(WORLD="world"))


class _Recorder:
    def __init__(self):
        self.entries = []

    def add(self, ring, ticket, epoch, kernel, targets, bound):
        self.entries.append((ticket, epoch, kernel, dict(targets), bound))

    def forget(self, ring):
        pass


@pytest.fixture
def fakes(monkeypatch):
    """Rank 1 of a group of 4 through fake entry points: no CUDA, no
    process group."""
    sym = _FakeSymLib()
    coll = _FakeCollLib(sym)
    fake = _fake_dist(WORLD, 1)
    monkeypatch.setattr(symmetric, "LIB", sym)
    monkeypatch.setattr(symmetric, "dist", fake)
    monkeypatch.setattr(symmetric, "WATCHDOG", _Recorder())
    monkeypatch.setattr(symmetric, "_DIAG", [])
    monkeypatch.setattr(symmetric, "_BUFFERS", {})
    monkeypatch.setattr(dc, "dist", fake)
    monkeypatch.setattr(dc, "LIB", coll)
    for w in dc.KERNELS.values():
        monkeypatch.setattr(w, "library", coll)
        monkeypatch.setattr(w, "launches", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    return types.SimpleNamespace(sym=sym, coll=coll, ops=sym.ops)


def _buffer(fakes, nbytes=1000):
    buf = GroupBuffer("g", torch.device("cuda", 0))
    buf.reserve(nbytes, fakes.coll)
    return buf


# ---- the group buffer -------------------------------------------------------

@pytest.mark.parametrize("size,header", [(2, 1024), (4, 2048), (8, 3072), (16, 6144)])
def test_group_slots_come_by_parity_and_source_after_the_counters(size, header):
    cap = 1 << 16
    assert GroupBuffer.header_bytes(size) == header
    offsets = [GroupBuffer.slot_offset(p, s, cap, size) for p in (0, 1) for s in range(size)]
    assert offsets == [header + i * cap for i in range(2 * size)]
    # three counter lines a rank (ARRIVED, CONSUMED, GAVE_UP), inside the header
    assert 3 * size * 128 <= header and header % 1024 == 0


@pytest.mark.parametrize("slab,cap", [(1, 1 << 16), (1 << 16, 1 << 16), ((1 << 16) + 1, 1 << 17),
                                      (3 << 20, 4 << 20)])
def test_group_reserve_maps_every_peer_and_grows_to_the_largest_slab(fakes, slab, cap):
    buf = _buffer(fakes, slab)
    assert buf.cap == cap and buf.size == WORLD and buf.coord == 1
    assert fakes.sym.allocs == [2048 + 2 * WORLD * cap]
    assert len(fakes.sym.opened) == WORLD - 1  # every peer, not only two neighbours
    assert buf.peers[1] == buf.me and len(set(buf.peers)) == WORLD
    buf.reserve(slab, fakes.coll)  # no growth: no collective, no allocation
    assert len(fakes.sym.allocs) == 1
    released = []
    buf._release = lambda: released.append(buf.cap)  # the collective free of the old buffer
    buf.reserve(2 * cap + 1, fakes.coll)
    assert released == [cap] and buf.cap == 4 * cap
    assert fakes.sym.allocs[-1] == 2048 + 2 * WORLD * 4 * cap


def test_groups_of_the_same_ranks_share_one_buffer(fakes):
    a = symmetric.group_buffer("spatial", "cuda:0")
    assert symmetric.group_buffer("world", torch.device("cuda", 0)) is a
    assert symmetric.ring_buffer(types.SimpleNamespace(get_group=lambda name: "g"), "spatial",
                                 "cuda:0") is not a


def test_group_calls_wait_for_the_last_use_of_their_slots(fakes):
    buf = _buffer(fakes)
    everyone = range(WORLD)
    calls = [buf.next_call(everyone, everyone) for _ in range(4)]
    assert [c.epoch for c in calls] == [1, 2, 3, 4]
    assert [c.parity for c in calls] == [1, 0, 1, 0]
    assert all(c.dests == (0, 2, 3) and c.sources == (0, 2, 3) for c in calls)  # not my own
    # the sender of e waits until each destination read e - 2 (none before 3)
    assert [c.consumed for c in calls] == [(0, 0, 0), (0, 0, 0), (1, 1, 1), (2, 2, 2)]
    # point to point: a destination's wait is the last epoch that stored into
    # its slot of the parity, however long ago
    e5 = buf.next_call([2], [0])
    e6 = buf.next_call([], [3])
    e7 = buf.next_call([2], [])
    e9 = (buf.next_call([3], []), buf.next_call([2], [2]))[1]
    assert (e5.epoch, e5.dests, e5.consumed, e5.sources) == (5, (2,), (3,), (0,))
    assert (e6.dests, e6.consumed, e6.sources) == ((), (), (3,))
    assert (e7.dests, e7.consumed) == ((2,), (5,))
    assert (e9.epoch, e9.dests, e9.consumed, e9.sources) == (9, (2,), (7,), (2,))
    assert buf.last_sent == [4, 0, 9, 8]


def test_group_watch_bounds_the_consumed_and_arrival_waits(fakes):
    buf = _buffer(fakes)
    everyone = range(WORLD)
    for _ in range(3):
        buf.watch(buf.next_call(everyone, everyone), dc.PSUM)
    buf.watch(buf.next_call([3], [0]), dc.PPERMUTE)
    entries = symmetric.WATCHDOG.entries
    assert [(t, e, k) for t, e, k, _, _ in entries] == [(1, 1, 22), (2, 2, 22), (3, 3, 22),
                                                         (4, 4, 20)]
    # lines: ARRIVED[s] = s, CONSUMED[d] = 4 + d
    assert entries[0][3] == {0: 1, 2: 1, 3: 1}
    assert entries[2][3] == {4: 1, 6: 1, 7: 1, 0: 3, 2: 3, 3: 3}
    assert entries[3][3] == {7: 2, 0: 4}
    assert all(bound == symmetric.SPIN_TIMEOUT_S for *_, bound in entries)


def test_group_give_up_records_tells_every_peer_and_releases(fakes, monkeypatch):
    buf = _buffer(fakes)
    call = buf.next_call(range(WORLD), range(WORLD))
    buf.watch(call, dc.ALL_GATHER)
    _, epoch, kernel, targets, bound = symmetric.WATCHDOG.entries[0]
    fakes.sym.counters = {0: 1, 2: 0, 3: 1}  # the rank at coordinate 2 never stored
    entry = symmetric._Entry(call.ticket, epoch, kernel, tuple(targets.items()), 0.0, bound)
    assert buf.give_up(entry, [entry])
    writes = [op[1:] for op in fakes.ops if op[0] == "side_write"]
    gave_up = [buf.address(p, buf.gave_up(1)) for p in (0, 2, 3)]
    assert writes == [(a, 1) for a in gave_up] + [(buf.me + 2 * 128, 1)]
    msg = str(symmetric.timeout_error())
    assert "collective all_gather timed out on rank 1: epoch 1" in msg
    assert "the rank at coordinate 2 (ARRIVED[2]), counter 102, at 0, want >= 1" in msg
    # every wait met after all: late, not stuck
    fakes.sym.counters = {0: 1, 2: 1, 3: 1}
    assert not buf.give_up(entry, [entry])


def test_group_check_neighbours_raises_a_peers_give_up(fakes):
    buf = _buffer(fakes)
    fakes.sym.counters = {2 * WORLD + 3: 6}  # GAVE_UP[3]: the rank at coordinate 3, epoch 6
    buf.check_neighbours()
    msg = str(symmetric.timeout_error())
    assert "collective ppermute timed out on rank 1: epoch 6" in msg
    assert "the rank at coordinate 3 of the group ran out" in msg and "counter 303" in msg


def test_check_timeouts_flushes_the_group_buffers(fakes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    buf = _buffer(fakes)
    symmetric._BUFFERS["k"] = buf
    buf.next_call([0, 2], [])
    buf.next_call([2], [])
    fakes.ops.clear()
    symmetric.check_timeouts()
    # wait until coordinates 0 and 2 read the last slabs sent them, then a ticket
    assert fakes.ops == [("sym_wait", buf.me + 4 * 128, 1), ("sym_wait", buf.me + 6 * 128, 2),
                         ("ticket", buf.ticket(), 3)]
    assert symmetric.WATCHDOG.entries[-1][3] == {4: 1, 6: 2}
    fakes.ops.clear()
    symmetric.check_timeouts()  # nothing sent since: no wait
    assert fakes.ops == []


def test_watchdog_releases_a_group_call_after_the_bound():
    class Group:
        def __init__(self):
            self.gave_up = []

        def passed(self):
            return 0

        def give_up(self, entry, pending):
            self.gave_up.append(entry.epoch)
            return True

        def release(self, pending):
            pass

    now = [0.0]
    dog = Watchdog(clock=lambda: now[0])
    dog._thread = object()
    g = Group()
    dog.add(g, 1, 4, dc.PSUM, [(0, 4)], bound=2.0)
    now[0] = 1.9
    dog.poll()
    assert not g.gave_up
    now[0] = 2.1
    dog.poll()
    assert g.gave_up == [4] and dog.fired


@pytest.mark.parametrize("host,refused,match", [
    ("elsewhere", False, "runs on host 'elsewhere'"),
    (None, True, "cudaIpcOpenMemHandle refused the buffer of the rank at coordinate 0"),
])
def test_an_unmappable_peer_raises(fakes, monkeypatch, host, refused, match):
    if refused:
        fakes.sym.refuse = {1}  # the handle every rank sent (one alloc: its first byte)
    if host is not None:
        monkeypatch.setattr(symmetric, "_exchange", lambda group, size, handle: [
            (handle, host.encode() if c != 1 else symmetric.socket.gethostname().encode())
            for c in range(size)])
    with pytest.raises(RuntimeError, match=match):
        _buffer(fakes)


# ---- one call's steps, in the order they are enqueued -----------------------

def test_device_psum_enqueues_the_protocol_in_order(fakes):
    x = torch.arange(10.0)
    dc.psum(x, "g")
    buf = symmetric.group_buffer("g", "cuda:0")
    slots = [buf.slot(d, 1, 1) for d in (0, 2, 3)]
    mine = [buf.slot(1, 1, s) for s in range(WORLD)]
    assert fakes.ops == [
        ("send", x.data_ptr(), 40, slots),
        ("signal", [buf.address(d, buf.arrived(1)) for d in (0, 2, 3)], 1),
        ("wait", [(buf.address(1, buf.arrived(s)), 1) for s in (0, 2, 3)]),
        ("ticket", buf.ticket(), 1),
        # my own slab read from the input, the others from my slots, in rank order
        ("reduce", 0, [mine[0], x.data_ptr(), mine[2], mine[3]], 10),
        ("signal", [buf.address(s, buf.consumed_line(1)) for s in (0, 2, 3)], 1),
    ]
    fakes.ops.clear()
    dc.psum(x.to(torch.bfloat16), "g")
    dc.psum(x.double(), "g")
    assert [op[1] for op in fakes.ops if op[0] == "reduce"] == [1, 2]
    # epoch 3 reuses parity 1: first the wait until every destination read epoch 1
    assert fakes.ops[[op[0] for op in fakes.ops].index("send", 1) - 1] == (
        "wait", [(buf.address(1, buf.consumed_line(d)), 1) for d in (0, 2, 3)])
    assert {k: w.launches for k, w in dc.KERNELS.items()} == {
        "collective_send": 3, "collective_reduce": 3, "collective_unpack": 0}


@pytest.mark.parametrize("axis,tiled,outer,shape", [
    (0, True, 1, (8, 3, 5)), (1, True, 2, (2, 12, 5)), (1, False, 2, (2, 4, 3, 5)),
    (3, False, 30, (2, 3, 5, 4)),
])
def test_device_all_gather_unpacks_outer_by_source(fakes, axis, tiled, outer, shape):
    x = torch.zeros((2, 3, 5), dtype=torch.bfloat16)
    out = dc.all_gather(x, "g", axis, tiled)
    assert tuple(out.shape) == shape
    buf = symmetric.group_buffer("g", "cuda:0")
    unpack = [op for op in fakes.ops if op[0] == "unpack"]
    srcs = [x.data_ptr() if s == 1 else buf.slot(1, 1, s) for s in range(WORLD)]
    assert unpack == [("unpack", srcs, outer, 30 // outer * 2)]


@pytest.mark.parametrize("perm,sends,reads", [
    ([(i, (i + 1) % WORLD) for i in range(WORLD)], [2], 0),
    ([(0, 3), (3, 0)], [], None),  # rank 1 neither sends nor receives: zeros
    ([(1, 3), (2, 0)], [3], None),  # sends only
    ([(2, 1)], [], 2),  # receives only
    ([(1, 1)], [], 1),  # its own slab: a copy, no wait
])
def test_device_ppermute_is_point_to_point(fakes, perm, sends, reads):
    x = torch.ones(6)
    out = dc.ppermute(x, "g", perm)
    buf = symmetric.group_buffer("g", "cuda:0")
    kinds = [op[0] for op in fakes.ops]
    assert buf.epoch == 1  # every rank numbers every call, even one with nothing to do
    assert [op[3] for op in fakes.ops if op[0] == "send"] == ([[buf.slot(sends[0], 1, 1)]]
                                                             if sends else [])
    waits = [op[1] for op in fakes.ops if op[0] == "wait"]
    if reads in (None, 1):
        assert waits == []
    else:
        assert waits == [[(buf.address(1, buf.arrived(reads)), 1)]]
        assert fakes.ops[-1] == ("signal", [buf.address(reads, buf.consumed_line(1))], 1)
    if reads is None:
        assert "unpack" not in kinds and not out.any()
    else:
        src = x.data_ptr() if reads == 1 else buf.slot(1, 1, reads)
        assert [op for op in fakes.ops if op[0] == "unpack"] == [("unpack", [src], 1, 24)]
    watched = symmetric.WATCHDOG.entries
    assert len(watched) == (1 if sends or reads not in (None, 1) else 0)


def test_device_psum_refuses_a_type_it_cannot_sum(fakes):
    with pytest.raises(ValueError, match="device psum takes"):
        dc.psum(torch.zeros(3, dtype=torch.bool), "g")


def test_a_recorded_timeout_raises_before_the_next_call(fakes):
    record = (ctypes.c_longlong * 8)()
    symmetric._DIAG.append((record, ctypes.addressof(record)))
    symmetric._record(1, 4, 102, 3, 4, 2_000_000_000, dc.PSUM)
    with pytest.raises(RuntimeError, match="collective psum timed out on rank 1: epoch 4"):
        dc.all_gather(torch.ones(2), "g")
    assert fakes.ops == []


# ---- the dispatch -----------------------------------------------------------

class _FakeCuda:
    """Stands in for a CUDA tensor where only its device is read."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("config,want", [("cpu:gloo,cuda:gloo", "gloo"),
                                         ("cpu:gloo,cuda:nccl", "nccl"), ("nccl", "nccl")])
def test_cuda_backend_reads_the_groups_config(monkeypatch, config, want):
    monkeypatch.setattr(dc, "dist", _fake_dist(WORLD, 0, config))
    assert dc.cuda_backend("g") == want


@pytest.mark.parametrize("tensor,config,route", [
    (torch.zeros(1), "cpu:gloo,cuda:gloo", "host"),
    (torch.zeros(1), "cpu:gloo,cuda:nccl", "host"),
    (_FakeCuda(), "cpu:gloo,cuda:gloo", "device"),
    (_FakeCuda(), "cpu:gloo,cuda:nccl", "dist"),
])
def test_route_by_device_and_backend(monkeypatch, tensor, config, route):
    monkeypatch.setattr(dc, "dist", _fake_dist(WORLD, 0, config))
    assert dc.route(tensor, "g") == route


class _Mesh:
    mesh_dim_names = ("data", "spatial", "spatial_x")
    shape = (1, 2, 2)

    def get_group(self, name):
        return name

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("way", ["host", "device", "dist"])
def test_collectives_dispatch_by_route_and_count(monkeypatch, way):
    calls = []
    for name in ("all_gather", "all_gather_plain", "psum", "psum_plain", "psum_dist",
                 "ppermute", "ppermute_plain"):
        monkeypatch.setattr(dc, name, lambda x, group, *a, _n=name: calls.append((_n, group)) or x)
    monkeypatch.setattr(dc, "route", lambda x, group: way)
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group=None: 4)
    for counter in ("calls", "device_calls", "host_calls"):
        monkeypatch.setattr(collectives, counter, 0)
    x, mesh = torch.ones(2), _Mesh()
    collectives._gather(x, mesh, "spatial", 0, True)
    collectives._reduce(x, mesh, ("spatial", "spatial_x"))  # spans the world: one sum
    collectives._reduce(x, mesh, ("spatial",))
    collectives._permute(x, mesh, "spatial_x", [(0, 1)])
    suffix = {"host": "_plain", "device": "", "dist": "_plain"}[way]
    psum = {"host": "psum_plain", "device": "psum", "dist": "psum_dist"}[way]
    assert calls == [(f"all_gather{suffix}", "spatial"), (psum, collectives.dist.group.WORLD),
                     (psum, "spatial"), (f"ppermute{suffix}", "spatial_x")]
    assert collectives.calls == 4
    assert (collectives.device_calls, collectives.host_calls) == ((0, 4) if way == "host"
                                                                  else (4, 0))
