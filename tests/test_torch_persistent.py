"""The persistent halo exchange: ``Communicator.neighbor_alltoallv_init``
and the halo step built on it (``make_halo_step``), which on the card
capture one exchange per state buffer into a CUDA graph and replay it.

On the CPU the request and the step run the eager exchange, equal to
``halo_exchange`` over alternating buffers; each condition that keeps an
exchange eager is named in the request's ``blockers``; the step's
bookkeeping (a buffer seen once is never captured, at most
``CAPTURED_BUFFERS`` requests, wire counters that read as many exchanges
as were made, kernel launches counted only where a wrapper launches) is
held with the graph stood in for by the eager call.  The ``cuda``-marked
tests replay real graphs on the card, bit for bit against eager
exchanges, and skip with a reason elsewhere::

    PYTHONPATH=src python -m pytest tests/test_torch_persistent.py -m cuda -q
"""

import collections
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import (Communicator, LocalMeshTransport, NeighborRequest,
                              PersistentRequest, Topology, collective_payload_bytes, reschedule)
from repro_torch.comm.api import ClassRequest
from repro_torch.fleet import ExchangeTelemetry
from repro_torch.halo import HaloSpec, from_reference, halo_exchange, make_halo_plan, make_halo_step
from repro_torch.halo.exchange import CAPTURED_BUFFERS
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.graphs import GraphCall
from repro_torch.obs import Tracer

SPEC = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)


def _state(spec, seed, device="cpu"):
    start = np.random.default_rng(seed).normal(size=(spec.nranks,) + spec.alloc)
    return from_reference(start.astype(np.float32), spec, device=device)


def _bump(x, spec, k):
    """Change every interior cell, so the next exchange has new halos."""
    (rz, ry, rx), (nz, ny, nx) = spec.radii, spec.interior
    x[:, rz:rz + nz, ry:ry + ny, rx:rx + nx] += float(k + 1)


def _alternate(step, spec, bufs, calls):
    """``calls`` exchanges through ``step``, taking ``bufs`` in turn and
    changing each buffer's interior before its exchange."""
    for k in range(calls):
        x = bufs[k % len(bufs)]
        _bump(x, spec, k)
        assert step(x) is x
    return bufs


class _StandIn:
    """A graph stood in for on the CPU: recording runs the call (as a
    capture runs its Python; the side stream's join is the card's), a
    launch does nothing."""

    @staticmethod
    def record(fn, device):
        fn()
        return _StandIn()

    def replay(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """Let CPU requests capture, with :class:`_StandIn` for the graph."""
    monkeypatch.setattr(Communicator, "_fixed_blockers", lambda self, *a: frozenset())
    monkeypatch.setattr(GraphCall, "_record", staticmethod(_StandIn.record))
    monkeypatch.setattr(PersistentRequest, "_joined",
                        lambda self: self.comm.neighbor_alltoallv(self.buf, *self._args))
    reset_launch_counts()
    yield
    reset_launch_counts()


# ---------------------------------------------------------------------------
# the CPU: eager, and equal to halo_exchange
# ---------------------------------------------------------------------------

def test_step_over_alternating_buffers_equals_halo_exchange_on_the_cpu():
    step = make_halo_step(SPEC, device="cpu")
    want_comm = Communicator(device="cpu")
    plan = make_halo_plan(SPEC, want_comm)
    got = _alternate(step, SPEC, [_state(SPEC, 1), _state(SPEC, 2)], 6)
    want = _alternate(lambda x: halo_exchange(x, SPEC, want_comm, plan=plan), SPEC,
                      [_state(SPEC, 1), _state(SPEC, 2)], 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts()["graph_captures"] == launch_counts()["graph_replays"] == 0
    assert len(step.requests) == 2
    assert all(r.blockers == {"device"} for r in step.requests.values())


def test_request_starts_equal_halo_exchange_on_the_cpu():
    comm = Communicator(device="cpu")
    plan = make_halo_plan(SPEC, comm, schedule_policy="exact")
    x, want = _state(SPEC, 3), _state(SPEC, 3)
    req = comm.neighbor_alltoallv_init(x, plan.send_cts, plan.recv_cts, plan.perms,
                                       plan=plan.wire, strategies=plan.strategies)
    for k in range(3):
        _bump(x, SPEC, k)
        _bump(want, SPEC, k)
        assert req.start() is x
        halo_exchange(want, SPEC, Communicator(device="cpu"), plan=plan)
        assert torch.equal(x, want)
    with pytest.raises(ValueError, match="align"):
        comm.neighbor_alltoallv_init(x, plan.send_cts, plan.recv_cts[:-1], plan.perms,
                                     plan=plan.wire, strategies=plan.strategies)


# ---------------------------------------------------------------------------
# what keeps an exchange eager
# ---------------------------------------------------------------------------

def _request(comm, plan, wire=None, strategies=None):
    x = _state(SPEC, 4)
    return comm.neighbor_alltoallv_init(x, plan.send_cts, plan.recv_cts, plan.perms,
                                        plan=wire or plan.wire,
                                        strategies=strategies or plan.strategies)


def _blockers(cond):
    comm = Communicator(device="cpu")
    plan = make_halo_plan(SPEC, comm, schedule_policy="exact")
    if cond == "transport":
        comm.transport.capturable = False
    elif cond == "varlen":
        stream = tuple(max(1, g.nbytes // 2) for g in plan.wire.groups)
        return _request(comm, plan, wire=reschedule(plan.wire.with_stream_bytes(stream),
                                                    "varlen")).blockers
    elif cond == "compressor":
        rle = comm.strategies.get("rlewire")
        strats, wire = comm.plan_neighbor(plan.send_cts, plan.perms,
                                          strategies=(rle,) * len(plan.send_cts),
                                          schedule_policy="exact")
        return _request(comm, plan, wire=wire, strategies=strats).blockers
    elif cond == "tracer":
        comm.tracer = Tracer()
    elif cond == "telemetry":
        comm.telemetry = ExchangeTelemetry()
    elif cond == "recorder":
        req, seen = _request(comm, plan), []
        collective_payload_bytes(lambda: seen.append(req.blockers))
        assert req.blockers == {"device"}  # the recorder is closed again
        return seen[0]
    return _request(comm, plan).blockers


@pytest.mark.parametrize("cond", [None, "transport", "varlen", "compressor", "tracer",
                                  "telemetry", "recorder"])
def test_each_condition_keeps_the_exchange_eager(cond):
    """A CPU buffer is always a blocker (``device``); each other
    condition adds its own, and only it."""
    assert _blockers(cond) == {"device"} | ({cond} if cond else set())


def test_a_disabled_tracer_does_not_block():
    comm = Communicator(device="cpu", tracer=Tracer(enabled=False))
    assert _request(comm, make_halo_plan(SPEC, comm)).blockers == {"device"}


# ---------------------------------------------------------------------------
# the step's bookkeeping, the graph stood in for
# ---------------------------------------------------------------------------

def test_a_buffer_seen_once_is_never_captured(stand_in):
    step = make_halo_step(SPEC, device="cpu")
    a, b, c = _state(SPEC, 5), _state(SPEC, 6), _state(SPEC, 7)
    seen = []
    for x in (a, b, a, a, c, b, a):
        step(x)
        counts = launch_counts()
        seen.append((counts["graph_captures"], counts["graph_replays"]))
    # a: eager, captured, replayed twice; b: eager, captured; c: eager
    assert seen == [(0, 0), (0, 0), (1, 0), (1, 1), (1, 1), (2, 1), (2, 2)]


def test_counters_read_as_many_exchanges_as_were_made(stand_in):
    """Replays advance the transport's ops and bytes and the per-class
    counts by what the captured exchange moved; the drain positions are
    the captured exchange's."""
    step = make_halo_step(SPEC, device="cpu", schedule_policy="exact")
    _alternate(step, SPEC, [_state(SPEC, 8), _state(SPEC, 9)], 7)
    eager = Communicator(device="cpu")
    plan = make_halo_plan(SPEC, eager, schedule_policy="exact")
    for _ in range(7):
        halo_exchange(_state(SPEC, 8), SPEC, eager, plan=plan)
    comm = step.comm
    assert (comm.wire_ops, comm.wire_payload_bytes) == (eager.wire_ops, eager.wire_payload_bytes)
    assert comm.wire_class_ops == eager.wire_class_ops
    assert set(comm.wire_class_ops.values()) == {7}
    assert comm.wire_class_bytes == eager.wire_class_bytes
    assert comm.wire_class_drains == eager.wire_class_drains
    counts = launch_counts()
    assert (counts["graph_captures"], counts["graph_replays"]) == (2, 3)


def test_the_step_keeps_at_most_its_number_of_requests(stand_in):
    step = make_halo_step(SPEC, device="cpu")
    bufs = [_state(SPEC, 10 + i) for i in range(CAPTURED_BUFFERS + 2)]
    for x in bufs:
        step(x)
        assert len(step.requests) <= CAPTURED_BUFFERS
    assert [r.buf for r in step.requests.values()] == bufs[2:]
    step(bufs[2])  # the least recently used goes first
    step(bufs[0])
    assert [r.buf for r in step.requests.values()] == bufs[4:] + [bufs[2], bufs[0]]
    assert launch_counts()["graph_captures"] == 1  # bufs[2], seen twice


def test_a_replay_counts_no_launch_and_the_call_keeps_its_own(stand_in):
    """The wrappers' counts move only where a wrapper launches: the
    captured call's launches are counted once, as it runs, and kept on
    the call; a replay adds to ``graph_replays`` and the call's
    ``replays``, and to no kernel's count."""
    def fn():
        KERNELS["pack_rows"].launches += 3
        KERNELS["unpack_dma"].launches += 1

    call = GraphCall(fn, torch.device("cpu"))
    assert call.launches == {"pack_rows": 3, "unpack_dma": 1}
    call.replay()
    call.replay()
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "pack_rows": 3, "unpack_dma": 1, "graph_captures": 1, "graph_replays": 2}
    assert call.replays == 2
    reset_launch_counts()
    assert not any(launch_counts().values())


def test_a_dropped_request_frees_its_graph_without_the_cycle_collector(stand_in):
    """Nothing holds a captured call in a reference cycle: a request the
    step lets go, or a dropped step, frees its graph at once, with the
    cyclic collector off (a graph freed by a later collection could be
    freed inside another capture, which would end it)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        step = make_halo_step(SPEC, device="cpu")
        bufs = [_state(SPEC, 70 + i) for i in range(CAPTURED_BUFFERS + 1)]
        step(bufs[0])
        step(bufs[0])
        graph = weakref.ref(step.requests[next(iter(step.requests))].graph)
        for x in bufs[1:]:
            step(x)
        assert graph() is None  # bufs[0]'s request, the least recently used, let go
        step(bufs[1])
        graph = weakref.ref(step.requests[next(reversed(step.requests))].graph)
        assert graph() is not None
        del step
        assert graph() is None
    finally:
        if collecting:
            gc.enable()


def test_the_cycle_collector_is_off_during_a_capture(monkeypatch):
    seen = []

    def record(fn, device):
        seen.append(gc.isenabled())
        return _StandIn()

    monkeypatch.setattr(GraphCall, "_record", staticmethod(record))
    assert gc.isenabled()
    GraphCall(lambda: None, torch.device("cpu"))
    assert seen == [False] and gc.isenabled()
    reset_launch_counts()


def test_the_transport_keeps_each_ragged_plans_index():
    """A graph captured under a ragged plan reads the transport's index
    by address on every replay: exchanges under another ragged plan
    leave it in place, the same tensor, and the first plan's next
    exchange makes no new one."""
    comm = Communicator(device="cpu")
    wires = [reschedule(make_halo_plan(HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=r),
                                       comm, schedule_policy="exact").wire, "ragged")
             for r in (1, 2)]
    t = LocalMeshTransport("cpu")
    first = t._index(wires[0], "cpu")
    for w in (wires[1], wires[0], wires[1]):
        t.exchange(torch.zeros((w.nranks, w.wire_bytes), dtype=torch.uint8), w)
    assert t._index(wires[0], "cpu")[0] is first[0]
    assert t._index(wires[1], "cpu")[0] is not first[0]


class _Unqueryable:
    def query(self):
        raise AssertionError("an event was queried while a graph is captured")


def _drain(self, buf):
    self.applied = True
    return buf


@pytest.mark.parametrize("capturing", [False, True])
def test_wait_any_drains_in_plan_order_while_capturing(monkeypatch, capturing):
    """An event recorded on a capturing stream cannot be queried: under
    a capture the classes drain in plan order, asking no event; else the
    first finished class drains first."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    monkeypatch.setattr(ClassRequest, "unpack_into", _drain)
    events = [_Unqueryable(), _Done(), _Done()] if capturing else [_Pending(), _Done(), _Done()]
    classes = [ClassRequest(g, torch.zeros(1), (g,), 1, None, event=e)
               for g, e in enumerate(events)]
    buf = torch.zeros(3)
    req = NeighborRequest(buf, classes)
    assert req.wait() is buf
    assert req.drained == ([0, 1, 2] if capturing else [1, 2, 0])


class _Done:
    def query(self):
        return True


class _Pending:
    def query(self):
        return False


# ---------------------------------------------------------------------------
# the card: real graphs
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _randn(spec, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((spec.nranks,) + spec.alloc, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("schedule", ["grouped", "uniform", "ragged", "tiered"])
def test_replays_are_bit_exact_to_eager_exchanges(radius, schedule):
    """Eight exchanges over two buffers, each interior changed before
    its exchange: the first two eager, the next two captured, the rest
    replayed, every one ``torch.equal`` to an eager exchange."""
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(12, 10, 8), radius=radius)
    topo = Topology.blocked(8, 4) if schedule == "tiered" else None
    comm, eager = Communicator(device=dev, topology=topo), Communicator(device=dev, topology=topo)
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    plan = dataclasses.replace(plan, wire=reschedule(plan.wire, schedule))
    bufs = [_state(spec, 20, dev), _state(spec, 21, dev)]
    want = [b.clone() for b in bufs]
    reqs = [comm.neighbor_alltoallv_init(b, plan.send_cts, plan.recv_cts, plan.perms,
                                         plan=plan.wire, strategies=plan.strategies)
            for b in bufs]
    reset_launch_counts()
    for k in range(8):
        _bump(bufs[k % 2], spec, k)
        _bump(want[k % 2], spec, k)
        assert reqs[k % 2].start() is bufs[k % 2]
        halo_exchange(want[k % 2], spec, eager, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(bufs[k % 2], want[k % 2]), (k, schedule)
    counts = launch_counts()
    assert (counts["graph_captures"], counts["graph_replays"]) == (2, 4)
    assert all(not r.blockers for r in reqs)


def _device_kernels(fn):
    """The card's activities during ``fn()`` under ``torch.profiler``, by
    name and count (the profiler names each kernel a graph launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
def test_replayed_counters_equal_eager_counters_at_the_main_path_shape():
    """The main path's radius-2 exchange at the bench cell's shape (8
    ranks of 512^3, the model's plan), 8 calls over two buffers.  The
    wrappers count what they launch: the two eager starts and the two
    captures, 16 / 10 / 16 / 10 an exchange, each graph keeping one
    exchange's launches; replays count none.  The profiler sees one
    replay launch the kernels of one eager exchange, by name and count.
    The transport's ops and bytes read as 8 eager exchanges'."""
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(512, 512, 512), radius=2)
    calls = 8
    step = make_halo_step(spec, device=dev)
    eager = Communicator(device=dev)
    plan = make_halo_plan(spec, eager)
    assert plan.wire.fingerprint == step.plan.wire.fingerprint
    bufs = [_randn(spec, 30, dev), _randn(spec, 31, dev)]
    reset_launch_counts()
    _alternate(step, spec, bufs, calls)
    torch.cuda.synchronize()
    got = launch_counts()
    reset_launch_counts()
    want_bufs = [_randn(spec, 30, dev), _randn(spec, 31, dev)]
    _alternate(lambda x: halo_exchange(x, spec, eager, plan=plan), spec, want_bufs, calls)
    torch.cuda.synchronize()
    want = launch_counts()
    for g, w in zip(bufs, want_bufs):
        assert torch.equal(g, w)
    names = ("pack_rows", "pack_dma", "unpack_rows", "unpack_dma")
    per = {k: want[k] // calls for k in names}
    assert per == dict(zip(names, (16, 10, 16, 10)))
    assert {k: want[k] for k in names} == {k: calls * n for k, n in per.items()}
    assert (got["graph_captures"], got["graph_replays"]) == (2, calls - 4)
    assert {k: got[k] for k in names} == {k: 4 * n for k, n in per.items()}
    graphs = [r.graph for r in step.requests.values()]
    assert [g.launches for g in graphs] == [per, per]
    assert [g.replays for g in graphs] == [2, 2]
    # the graph holds the kernels: one replay launches one eager exchange's
    x = bufs[0]
    assert _device_kernels(lambda: step(x)) == \
        _device_kernels(lambda: halo_exchange(x, spec, eager, plan=plan))
    # both communicators have made calls + 1 exchanges now
    comm = step.comm
    assert (comm.wire_ops, comm.wire_payload_bytes) == (eager.wire_ops, eager.wire_payload_bytes)
    assert comm.wire_payload_bytes == (calls + 1) * plan.wire.issued_bytes
    assert comm.wire_class_ops == eager.wire_class_ops
    assert comm.wire_class_bytes == eager.wire_class_bytes
    # a drain position is the order the classes were drained in: the
    # eager call takes the first finished class, the graph plan order
    assert sorted(comm.wire_class_drains.values()) == list(range(1, plan.wire.ngroups + 1))


@pytest.mark.cuda
def test_a_replay_survives_another_ragged_plan_on_the_same_communicator():
    """A graph captured under ragged plan A reads the transport's index
    for A by address.  Exchanges under ragged plan B on the same
    communicator, and memory filled with junk after them, leave A's
    replays ``torch.equal`` to eager exchanges."""
    dev = _card()
    comm, eager = Communicator(device=dev), Communicator(device=dev)
    specs = [HaloSpec(grid=(2, 2, 2), interior=(12, 10, 8), radius=r) for r in (1, 2)]
    plans = []
    for spec in specs:
        plan = make_halo_plan(spec, comm, schedule_policy="exact")
        plans.append(dataclasses.replace(plan, wire=reschedule(plan.wire, "ragged")))
    (spec_a, spec_b), (plan_a, plan_b) = specs, plans
    x, want = _state(spec_a, 50, dev), _state(spec_a, 50, dev)
    req = comm.neighbor_alltoallv_init(x, plan_a.send_cts, plan_a.recv_cts, plan_a.perms,
                                       plan=plan_a.wire, strategies=plan_a.strategies)
    for k in range(6):
        _bump(x, spec_a, k)
        _bump(want, spec_a, k)
        req.start()
        halo_exchange(want, spec_a, eager, plan=plan_a)
        y = _state(spec_b, 60 + k, dev)
        halo_exchange(y, spec_b, comm, plan=plan_b)
        junk = [torch.full((1 << 20,), -1, dtype=torch.long, device=dev) for _ in range(4)]
        del y, junk
        torch.cuda.synchronize()
        assert torch.equal(x, want), k
    assert req.graph is not None and req.graph.replays == 4


@pytest.mark.cuda
@pytest.mark.parametrize("observer", ["tracer", "telemetry"])
def test_an_observed_step_stays_eager_on_the_card(observer):
    dev = _card()
    kw = {"tracer": Tracer()} if observer == "tracer" else {"telemetry": ExchangeTelemetry()}
    comm = Communicator(device=dev, **kw)
    step = make_halo_step(SPEC, comm, device=dev)
    reset_launch_counts()
    bufs = _alternate(step, SPEC, [_state(SPEC, 40, dev), _state(SPEC, 41, dev)], 6)
    assert launch_counts()["graph_captures"] == launch_counts()["graph_replays"] == 0
    assert all(r.blockers == {observer} for r in step.requests.values())
    # detached, the same requests go on: one more eager exchange each,
    # then a capture, then replays
    setattr(comm, observer, None)
    want = [b.clone() for b in bufs]
    _alternate(step, SPEC, bufs, 6)
    _alternate(lambda x: halo_exchange(x, SPEC, Communicator(device=dev)), SPEC, want, 6)
    torch.cuda.synchronize()
    assert all(torch.equal(b, w) for b, w in zip(bufs, want))
    assert (launch_counts()["graph_captures"], launch_counts()["graph_replays"]) == (2, 2)
