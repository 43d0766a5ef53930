"""The port's observability layer against the JAX reference, on the CPU.

* The Tracer: nesting, a disabled tracer, the span cap and its dropped
  count, attributes mutable until exit, ``add_manual`` — each scenario
  gives the reference's spans.
* The capture guard: the reference records nothing inside ``jit`` /
  ``shard_map``; the port records nothing while a CUDA graph is being
  captured.  Here the capture check is forced on (the card test under a
  real ``torch.cuda.graph`` is in ``tests/test_torch_cuda.py``): spans,
  a traced ``sendrecv`` and a program iteration record nothing, and the
  results equal the untraced ones.
* Span trees: ``sendrecv``, ``neighbor_alltoallv`` (planned inside the
  call and planned before) and the s = 2 program iteration on a 2x2x2
  grid of 6^3 blocks, under the reference's analytic table and a seeded
  synthetic one mapped with ``SystemParams.from_reference``: the port's
  span names, nesting and non-timing attributes equal the reference's,
  and every ``pred`` agrees to 1e-12.  The reference runs eagerly on one
  rank's block with its collectives stubbed to identities (spans and
  predictions do not read the bytes); the port runs all 8 ranks.
* ``stats()`` after the same calls: the reference's keys and counters,
  and ``publish_comm_stats`` snapshots equal.
* ``attribute_program_iteration``, the Chrome-trace export, aggregation,
  the flamechart summary and ``validate``: equal to the reference's on
  the same spans; traces and ``metrics.json`` written by either package
  load in the other; torch and numpy scalars export as numbers.
* ``python -m repro_torch.obs validate|summary`` prints what the
  reference's CLI prints, apart from paths.
* Tracer -> ``phase_aggregates`` -> ``DriftDetector.audit`` end to end,
  and ``production_communicator(telemetry=True, tracer=True)``.
* Untraced, the exchange, ``sendrecv`` and the program iteration
  synchronize nothing; nor does either with a disabled tracer attached.
  Traced or not, a call issues the same bytes and ops, and a blocking
  exchange packs once and issues its wire once.  Under a tracer the
  blocking halo step records the whole ``exchange`` tree.  The leaf
  tables of a codec plan carry the codec's encoder and decoder, those of
  a ``tempi`` plan none.
* The ``tempi.*`` ranges on a CPU ``torch.profiler`` timeline: host
  ``cpu_op`` events, not user annotations; one ``tempi.exchange`` a
  blocking halo step around two ``prep``, one ``pack``, one ``wire`` and
  one ``unpack`` a wire class; one ``tempi.stencil`` an application;
  one ``tempi.exchange`` an untraced ``sendrecv`` around ``pack``,
  ``wire`` and ``unpack``.

The reference's ``test_run_smoother_traced_exchanges_bounded_by_iterations``
and the smoother half of ``test_tracer_aggregates_feed_audit_end_to_end``
are ported in ``tests/test_torch_smoother.py``; here the audit is fed
from traced program iterations.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import repro.comm.perfmodel as rpm
import repro.fleet as rfleet
import repro.halo as rhalo
import repro.halo.program as rprogram
import repro.obs as robs
import repro.obs.__main__ as robs_cli
from repro.comm import api as rapi
from repro.comm.wireplan import reschedule as ref_reschedule
from repro.core import FLOAT as REF_FLOAT, Vector as RefVector
from repro.measure.decisions import DecisionCache as RefDecisionCache
from repro_torch.comm import Communicator, SystemParams, reschedule
from repro_torch.core import FLOAT, Vector
from repro_torch.fleet import DriftDetector, ExchangeTelemetry, predict_program_phases
from repro_torch.halo import HaloSpec, build_halo_program, make_halo_step, make_halo_types
from repro_torch.halo.exchange import DIRECTIONS
from repro_torch.measure import DecisionCache, production_communicator
from repro_torch.obs import (
    MetricsRegistry,
    Tracer,
    aggregate_events,
    aggregate_spans,
    attribute_program_iteration,
    load_chrome_trace,
    publish_comm_stats,
    save_chrome_trace,
    summary,
    to_chrome_trace,
    validate,
)
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import trace as trace_mod
from test_torch_fleet import ref_stubs  # noqa: F401  (fixture)
from test_torch_overlap import param_pair, stencil_fields

GRID, INTERIOR = (2, 2, 2), (6, 6, 6)
TABLES = ("tpu_v5e", "synthetic_stencil")
#: each span-tree case under one or both tables (the reference's eager
#: exchange takes seconds a run, so each run is made once and shared)
CASES = (("sendrecv", "tpu_v5e"), ("sendrecv", "synthetic_stencil"),
         ("exchange_planned", "tpu_v5e"), ("exchange_given", "synthetic_stencil"),
         ("program", "synthetic_stencil"))


def _params(table):
    if table == "tpu_v5e":
        return rpm.TPU_V5E, SystemParams.from_json(rpm.TPU_V5E.to_json())
    return param_pair(table)


def _close(a, b):
    return a == pytest.approx(b, rel=1e-12, abs=0.0)


# ---------------------------------------------------------------------------
# the Tracer
# ---------------------------------------------------------------------------

def _nesting(tr):
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
        with tr.span("inner2") as sp:
            sp.attrs.update(fingerprint="fp", strategy="wire/uniform")


def _disabled(tr):
    tr.enabled = False
    with tr.span("x") as sp:
        assert sp is None
    assert tr.add_manual("y", 0.0, 1.0) is None


def _cap(tr):
    tr.max_spans = 2
    for _ in range(5):
        with tr.span("s"):
            pass


def _manual(tr):
    with tr.span("exchange") as ex:
        tr.add_manual("plan", 0.0, 1e-4, nsegments=3)
    tr.add_manual("pack", 0.0, 1e-5, parent=ex)
    tr.add_manual("loose", 0.0, 1e-5)


def _cleared(tr):
    _cap(tr)
    tr.clear()
    tr.max_spans = 10
    _manual(tr)


SCENARIOS = {"nesting": _nesting, "disabled": _disabled, "cap": _cap, "manual": _manual,
             "cleared": _cleared}


def _shape(tr):
    return [(s.name, s.span_id, s.parent_id, s.attrs) for s in tr.spans], tr.dropped, len(tr)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tracer_semantics_match_the_reference(scenario):
    mine, ref = Tracer(), robs.Tracer()
    SCENARIOS[scenario](mine)
    SCENARIOS[scenario](ref)
    assert _shape(mine) == _shape(ref)
    for a, b in zip(mine.spans, ref.spans):
        assert a.duration >= 0.0 and b.duration >= 0.0
    if scenario == "nesting":
        outer, inner = mine.spans[:2]
        assert outer.duration >= inner.duration
        assert mine.spans[2].attrs["fingerprint"] == "fp"


# ---------------------------------------------------------------------------
# the capture guard
# ---------------------------------------------------------------------------

def test_nothing_captures_on_the_cpu():
    assert not trace_mod._capturing()
    assert Tracer().active


def test_no_spans_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(trace_mod, "_capturing", lambda: True)
    tr = Tracer()
    assert not tr.active
    with tr.span("should-not-record") as sp:
        assert sp is None
    assert len(tr) == 0
    # add_manual records explicit timing whatever the stream does, as the
    # reference's does inside a jax trace
    assert tr.add_manual("manual", 0.0, 1e-6) is not None


def _program_pair(comm, ref_comm, policy="exact"):
    prog = build_halo_program(GRID, INTERIOR, comm, steps=2, schedule_policy=policy)
    ref = rprogram.build_halo_program(GRID, INTERIOR, ref_comm, steps=2, schedule_policy=policy)
    if policy == "exact":
        prog = dataclasses.replace(prog, plan=dataclasses.replace(
            prog.plan, wire=reschedule(prog.plan.wire, "grouped")))
        ref = dataclasses.replace(ref, plan=dataclasses.replace(
            ref.plan, wire=ref_reschedule(ref.plan.wire, "grouped")))
    return prog, ref


def _state(spec_alloc, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((8,) + spec_alloc).astype(np.float32))


def test_capture_flag_records_nothing_on_the_comm_paths(monkeypatch):
    tr = Tracer()
    comm = Communicator(device="cpu", tracer=tr)
    plain = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, comm, steps=2)
    prog_plain = build_halo_program(GRID, INTERIOR, plain, steps=2)
    tr.clear()
    monkeypatch.setattr(trace_mod, "_capturing", lambda: True)
    x = _state(prog.spec.alloc)
    got, want = prog.iteration(x.clone(), comm), prog_plain.iteration(x.clone(), plain)
    ct = comm.commit(Vector(3, 2, 4, FLOAT))
    src = torch.arange(96, dtype=torch.float32).view(8, 12)
    ring = [(r, (r + 1) % 8) for r in range(8)]
    out = comm.sendrecv(src, torch.zeros_like(src), ct, ring)
    assert len(tr) == 0
    assert torch.equal(got, want)
    assert torch.equal(out, plain.sendrecv(src, torch.zeros_like(src),
                                           plain.commit(Vector(3, 2, 4, FLOAT)), ring))


# ---------------------------------------------------------------------------
# span trees against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _run_case(case, table):
    """The case through both packages with a tracer and telemetry
    attached: (port comm, port tracer, port output), the same for the
    reference.  Called under the ``ref_stubs`` fixture."""
    ref_params, params = _params(table)
    tr, ref_tr = Tracer(), robs.Tracer()
    comm = Communicator(params=params, device="cpu", tracer=tr, telemetry=ExchangeTelemetry(),
                        decisions=DecisionCache())
    ref_comm = rapi.Communicator(axis_name="x", params=ref_params, tracer=ref_tr,
                                 telemetry=rfleet.ExchangeTelemetry(),
                                 decisions=RefDecisionCache())
    if case == "sendrecv":
        ct, ref_ct = comm.commit(Vector(3, 2, 4, FLOAT)), ref_comm.commit(
            RefVector(3, 2, 4, REF_FLOAT))
        src = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 12)).astype(
            np.float32))
        out = comm.sendrecv(src, torch.zeros_like(src), ct, [(r, (r + 1) % 8) for r in range(8)])
        ref_comm.sendrecv(jnp.asarray(src[0].numpy()), jnp.zeros(12, jnp.float32), ref_ct,
                          [(0, 0)])
        return comm, tr, out, ref_comm, ref_tr
    if case == "program":
        prog, ref_prog = _program_pair(comm, ref_comm)
        tr.clear()
        ref_tr.clear()
        out = prog.iteration(_state(prog.spec.alloc), comm)
        ref_prog.iteration(jnp.zeros(ref_prog.spec.alloc, jnp.float32), ref_comm, "x")
        return comm, tr, out, ref_comm, ref_tr
    spec = HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    ref_spec = rhalo.HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    types, ref_types = make_halo_types(spec, comm), rhalo.make_halo_types(ref_spec, ref_comm)
    args = ([types[d][0] for d in DIRECTIONS], [types[d][1] for d in DIRECTIONS],
            [tuple(spec.perm(d)) for d in DIRECTIONS])
    ref_args = ([ref_types[d][0] for d in DIRECTIONS], [ref_types[d][1] for d in DIRECTIONS],
                [tuple(ref_spec.perm(d)) for d in DIRECTIONS])
    kw, ref_kw = {}, {}
    if case == "exchange_given":
        strats, plan = comm.plan_neighbor(args[0], args[2])
        ref_strats, ref_plan = ref_comm.plan_neighbor(ref_args[0], ref_args[2])
        kw, ref_kw = dict(plan=plan, strategies=strats), dict(plan=ref_plan,
                                                              strategies=ref_strats)
        tr.clear()
        ref_tr.clear()
    out = comm.neighbor_alltoallv(_state(spec.alloc), *args, **kw)
    ref_comm.neighbor_alltoallv(jnp.zeros(ref_spec.alloc, jnp.float32), *ref_args, "x", **ref_kw)
    return comm, tr, out, ref_comm, ref_tr


def _tree(tr):
    return [(s.name, s.span_id, s.parent_id,
             {k: v for k, v in s.attrs.items() if k != "pred"}) for s in tr.spans]


@pytest.mark.parametrize("case,table", CASES)
def test_span_trees_match_the_reference(ref_stubs, case, table):
    comm, tr, _, ref_comm, ref_tr = _run_case(case, table)
    assert _tree(tr) == _tree(ref_tr)
    for a, b in zip(tr.spans, ref_tr.spans):
        assert ("pred" in a.attrs) == ("pred" in b.attrs), a.name
        if "pred" in a.attrs:
            assert _close(a.attrs["pred"], b.attrs["pred"]), a.name
    names = [s.name for s in tr.spans]
    assert "exchange" in names and {"pack", "wire", "unpack"} <= set(names)
    assert validate(to_chrome_trace(tr)) == []
    # every span closes inside its parent; a wire_class span runs from
    # the wire's issue to its class's drain, so it lies inside the call
    # that issued it (the exchange), not inside the unpack it drained in
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        p = by_id.get(s.parent_id)
        if p is not None and s.name == "wire_class":
            p = by_id[p.parent_id]
        if p is not None:
            assert p.start <= s.start and s.start + s.duration <= p.start + p.duration
    # the telemetry holds the reference's keys and predictions
    tel, ref_tel = comm.telemetry, ref_comm.telemetry
    assert sorted(tel._by_key) == sorted(ref_tel._by_key)
    for key in tel._by_key:
        assert tel.get(key).count == ref_tel.get(key).count, key
        assert _close(tel.get(key).predicted, ref_tel.get(key).predicted), key


@pytest.mark.parametrize("case,table", CASES)
def test_stats_match_the_reference(ref_stubs, case, table):
    comm, _, _, ref_comm, _ = _run_case(case, table)
    got, want = comm.stats(), ref_comm.stats()
    assert got.keys() == want.keys()
    assert got == want
    mine, ref = MetricsRegistry(), robs.MetricsRegistry()
    publish_comm_stats(got, comm.telemetry, registry=mine)
    robs.publish_comm_stats(got, ref_comm.telemetry, registry=ref)
    assert mine.snapshot().keys() == ref.snapshot().keys()
    assert mine.snapshot()["counters"] == ref.snapshot()["counters"]
    assert mine.report().splitlines()[0] == ref.report().splitlines()[0]
    # stats() publishes into the process registry
    from repro_torch.obs import default_metrics

    assert default_metrics().counter("comm.exchanges") == got["wire_ops"]


def test_traced_exchange_equals_the_untraced_one_and_untraced_synchronizes_nothing(
        monkeypatch):
    import repro_torch.comm.api as api

    calls = []
    monkeypatch.setattr(api, "synchronize", lambda t: calls.append(t))
    plain = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, plain, steps=2)
    x = _state(prog.spec.alloc)
    want = prog.iteration(x.clone(), plain)
    want = prog.iteration(want, plain)
    assert calls == []
    traced = Communicator(device="cpu", tracer=Tracer(), telemetry=ExchangeTelemetry())
    tprog = build_halo_program(GRID, INTERIOR, traced, steps=2)
    got = tprog.iteration(tprog.iteration(x.clone(), traced), traced)
    assert torch.equal(got, want)
    assert calls  # the traced path synchronizes at its span boundaries
    assert plain.transport.ops == traced.transport.ops


def _ring_sendrecv(comm):
    src = torch.arange(96, dtype=torch.float32).view(8, 12)
    ring = [(r, (r + 1) % 8) for r in range(8)]
    return comm.sendrecv(src, torch.zeros_like(src), comm.commit(Vector(3, 2, 4, FLOAT)), ring)


def test_traced_sendrecv_equals_the_untraced_one_and_untraced_synchronizes_nothing(
        monkeypatch):
    import repro_torch.comm.api as api

    calls = []
    monkeypatch.setattr(api, "synchronize", lambda t: calls.append(t))
    plain = Communicator(device="cpu")
    want = _ring_sendrecv(plain)
    assert calls == []
    tr = Tracer()
    traced = Communicator(device="cpu", tracer=tr, telemetry=ExchangeTelemetry())
    got = _ring_sendrecv(traced)
    assert torch.equal(got, want)
    assert calls  # the traced path synchronizes at its span boundaries
    assert [s.name for s in tr.spans] == ["exchange", "pack", "wire", "unpack"]
    assert (plain.transport.ops, plain.transport.bytes) == (
        traced.transport.ops, traced.transport.bytes)
    assert plain.stats()["model_lookups"] == traced.stats()["model_lookups"]


def _halo_args(spec, comm):
    types = make_halo_types(spec, comm)
    return ([types[d][0] for d in DIRECTIONS], [types[d][1] for d in DIRECTIONS],
            [tuple(spec.perm(d)) for d in DIRECTIONS])


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_each_blocking_exchange_packs_once_and_issues_its_wire_once(monkeypatch, traced):
    import repro_torch.comm.api as api

    calls = {"pack": 0, "exchange": 0}

    def counting(name, fn):
        def spy(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return spy

    spec = HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    x = _state(spec.alloc)
    plain = Communicator(device="cpu")
    want = plain.neighbor_alltoallv(x.clone(), *_halo_args(spec, plain))
    monkeypatch.setattr(api, "pack_compress_ragged",
                        counting("pack", api.pack_compress_ragged))
    tr = Tracer() if traced else None
    comm = Communicator(device="cpu", tracer=tr)
    monkeypatch.setattr(comm.transport, "exchange", counting("exchange", comm.transport.exchange))
    args = _halo_args(spec, comm)
    for n in (1, 2):
        got = comm.neighbor_alltoallv(x.clone(), *args)
        assert calls == {"pack": n, "exchange": n}
        assert torch.equal(got, want)
    if traced:
        assert [s.name for s in tr.spans].count("exchange") == 2


def test_the_untraced_sendrecv_lies_in_tempi_ranges_on_the_profiler_timeline(tmp_path):
    comm = Communicator(device="cpu")
    ranges = _tempi_ranges(lambda: _ring_sendrecv(comm), tmp_path)
    (ex,) = [e for e in ranges if e.name == "tempi.exchange"]
    inner = sorted((e for e in ranges if e is not ex), key=lambda e: e.time_range.start)
    assert all(_inside(e, ex) for e in inner)
    assert [e.name for e in inner] == ["tempi.pack", "tempi.wire", "tempi.unpack"]


@pytest.mark.parametrize("codec", ["int8wire", "rlewire", "tempi"])
def test_leaf_tables_carry_the_codec_only_on_a_codec_plan(codec):
    import repro_torch.comm.api as api
    from repro_torch.comm.compress import Int8Wire, RleWire

    comm = Communicator(device="cpu")
    spec = HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    send_cts, recv_cts, perms = _halo_args(spec, comm)
    strat = {"int8wire": Int8Wire(), "rlewire": RleWire(), "tempi": None}[codec]
    strats, plan = comm.plan_neighbor(
        send_cts, perms, strategies=None if strat is None else [strat] * len(send_cts))
    sends = api._send_leaves(plan, strats, send_cts)
    tables = api._class_leaves(comm, plan, strats, send_cts, recv_cts)
    assert [(off, nbytes) for off, nbytes, _, _ in sends] == [
        (seg.offset, seg.nbytes) for seg in plan.segments]
    assert len(tables) == plan.ngroups
    assert [len(t) for t in tables] == [len(g.transfers) for g in plan.groups]
    encoders = [enc for _, _, _, enc in sends]
    decoders = [dec for table in tables for _, _, dec, _ in table]
    if strat is None:
        assert encoders == [None] * len(send_cts) and decoders == [None] * len(send_cts)
    else:
        assert encoders == [strat.encode_wire] * len(send_cts)
        assert [dec.func for dec in decoders] == [strat.decode_wire] * len(send_cts)


def test_a_disabled_tracer_synchronizes_nothing(monkeypatch):
    import repro_torch.comm.api as api

    calls = []
    monkeypatch.setattr(api, "synchronize", lambda t: calls.append(t))
    plain = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, plain, steps=2)
    x = _state(prog.spec.alloc)
    want = prog.iteration(x.clone(), plain)
    tr = Tracer(enabled=False)
    off = Communicator(device="cpu", tracer=tr)
    got = build_halo_program(GRID, INTERIOR, off, steps=2).iteration(x.clone(), off)
    assert calls == [] and len(tr) == 0
    assert torch.equal(got, want)


def test_the_blocking_halo_step_records_the_whole_tree_under_a_tracer():
    spec = HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    x = _state(spec.alloc)
    want = make_halo_step(spec, device="cpu")(x.clone())
    tr = Tracer()
    step = make_halo_step(spec, Communicator(device="cpu", tracer=tr), device="cpu")
    tr.clear()
    got = step(x.clone())
    assert torch.equal(got, want)
    (ex,) = [s for s in tr.spans if s.name == "exchange"]
    assert ex.parent_id is None and ex.attrs["fingerprint"] == step.plan.wire.fingerprint
    assert [s.name for s in tr.spans if s.parent_id == ex.span_id] == ["pack", "wire", "unpack"]
    assert validate(to_chrome_trace(tr)) == []


def _tempi_ranges(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler``: its ``tempi.*`` events,
    after checking each is a host ``cpu_op`` and not a user annotation."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ranges = [e for e in prof.events() if e.name.startswith("tempi.")]
    for e in ranges:
        assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    events = json.loads((tmp_path / "profile.json").read_text())["traceEvents"]
    assert {ev["cat"] for ev in events if ev.get("name", "").startswith("tempi.")} == {"cpu_op"}
    return ranges


def _inside(e, outer):
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def test_the_untraced_halo_step_lies_in_tempi_ranges_on_the_profiler_timeline(tmp_path):
    spec = HaloSpec(grid=GRID, interior=INTERIOR, radius=1)
    step = make_halo_step(spec, device="cpu")
    x = step(_state(spec.alloc))
    ranges = _tempi_ranges(lambda: step(x), tmp_path)
    (ex,) = [e for e in ranges if e.name == "tempi.exchange"]
    inner = [e for e in ranges if e is not ex]
    assert all(_inside(e, ex) for e in inner)
    assert sorted(e.name for e in inner) == sorted(
        ["tempi.prep"] * 2 + ["tempi.pack", "tempi.wire"]
        + ["tempi.unpack"] * step.plan.wire.ngroups)


def test_each_stencil_application_is_one_tempi_range(tmp_path):
    comm = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, comm, steps=2)
    x = _state(prog.spec.alloc)
    ranges = _tempi_ranges(lambda: prog.iteration(x, comm), tmp_path)
    (ex,) = [e for e in ranges if e.name == "tempi.exchange"]
    stencil = [e for e in ranges if e.name == "tempi.stencil"]
    assert len(stencil) == prog.applications == 2
    assert all(ex.time_range.end <= e.time_range.start for e in stencil)


# ---------------------------------------------------------------------------
# attributed iterations, export, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", TABLES)
def test_attribute_program_iteration_matches_the_reference(ref_stubs, table):
    ref_params, params = _params(table)
    comm = Communicator(params=params, device="cpu", decisions=DecisionCache())
    ref_comm = rapi.Communicator(axis_name="x", params=ref_params, decisions=RefDecisionCache())
    prog, ref_prog = _program_pair(comm, ref_comm)
    phases = predict_program_phases(prog, comm.model)
    classes = comm.model.price_class_completions(prog.plan.wire)
    tr, ref_tr = Tracer(), robs.Tracer()
    it = attribute_program_iteration(tr, prog, 10.0, 2e-3, phases, iteration=7,
                                     class_pred=classes)
    robs.attribute_program_iteration(ref_tr, ref_prog, 10.0, 2e-3, phases, iteration=7,
                                     class_pred=classes)
    assert _tree(tr) == _tree(ref_tr)
    for a, b in zip(tr.spans, ref_tr.spans):
        assert _close(a.start, b.start) and _close(a.duration + 1.0, b.duration + 1.0)
        assert a.attrs.get("pred") == b.attrs.get("pred")
    assert it.duration == pytest.approx(2e-3) and it.attrs["attributed"] is True
    leaf = [s for s in tr.spans if s.name in ("pack", "wire", "unpack", "stencil")]
    assert sum(s.duration for s in leaf) == pytest.approx(2e-3)
    assert attribute_program_iteration(Tracer(), object(), 0.0, 1e-3, {"pack": 0.0}) is None


def _sample(mod):
    tr = mod.Tracer()
    it = tr.add_manual("program_iteration", 0.0, 1e-3, fingerprint="fp1",
                       strategy="program/s=2", steps=2)
    ex = tr.add_manual("exchange", 0.0, 6e-4, parent=it, fingerprint="fp1",
                       strategy="program/s=2", schedule="uniform", wire_bytes=4096, pred=5e-4)
    tr.add_manual("pack", 0.0, 2e-4, parent=ex, pred=1e-4)
    w = tr.add_manual("wire", 2e-4, 2e-4, parent=ex, pred=2e-4)
    tr.add_manual("wire_class", 2e-4, 1e-4, parent=w, key="wfp/c0", pred=1e-4,
                  **{"class": 0})
    tr.add_manual("unpack", 4e-4, 2e-4, parent=ex, pred=2e-4)
    tr.add_manual("stencil", 6e-4, 2e-4, parent=it, pred=1e-4)
    tr.add_manual("stencil", 8e-4, 2e-4, parent=it, pred=1e-4)
    tr.add_manual("exchange", 1e-3, 1e-4, strategy="wire/uniform")  # unsigned
    return tr


def _without_generator(trace):
    trace = json.loads(json.dumps(trace))
    trace["otherData"].pop("generator")
    return trace


def test_chrome_trace_export_matches_the_reference_both_ways(tmp_path):
    mine, ref = _sample(trace_mod), _sample(robs)
    t_mine, t_ref = to_chrome_trace(mine), robs.to_chrome_trace(ref)
    assert t_mine["otherData"]["generator"] == "repro_torch.obs"
    assert _without_generator(t_mine) == _without_generator(t_ref)
    save_chrome_trace(mine, tmp_path / "mine.json")
    robs.save_chrome_trace(ref, tmp_path / "ref.json")
    for path in ("mine.json", "ref.json"):
        for load, agg, summ, val in (
                (load_chrome_trace, aggregate_events, summary, validate),
                (robs.load_chrome_trace, robs.aggregate_events, robs.summary, robs.validate)):
            trace = load(tmp_path / path)
            assert agg(trace) == robs.aggregate_events(t_ref)
            assert summ(trace) == robs.summary(t_ref)
            assert val(trace) == robs.validate(t_ref)
    assert aggregate_spans(mine.spans) == robs.aggregate_spans(ref.spans) == mine.phase_aggregates()
    assert any("fingerprint missing" in e for e in validate(t_mine))
    assert validate({}) == ["traceEvents missing or not a list"]
    assert validate({"traceEvents": [{"name": "x", "ph": "B"}]}) == robs.validate(
        {"traceEvents": [{"name": "x", "ph": "B"}]})


def test_torch_and_numpy_scalars_export_as_numbers():
    tr = Tracer()
    tr.add_manual("exchange", 0.0, 1e-4, fingerprint="f", strategy="s",
                  wire_bytes=torch.tensor(4096), ratio=torch.tensor(0.5, dtype=torch.float64),
                  steps=np.int64(2), dev=torch.device("cpu"))
    args = json.loads(json.dumps(to_chrome_trace(tr)))["traceEvents"][0]["args"]
    assert (args["wire_bytes"], args["ratio"], args["steps"], args["dev"]) == (4096, 0.5, 2, "cpu")


def test_metrics_files_are_the_reference_format_both_ways(tmp_path):
    regs = []
    for cls in (MetricsRegistry, robs.MetricsRegistry):
        m = cls()
        m.inc("a")
        m.inc("a", 2)
        m.set_counter("comm.exchanges", 7)
        m.set_gauge("occ", 0.125)
        regs.append(m)
    mine, ref = regs
    assert mine.to_json() == ref.to_json() and mine.report() == ref.report()
    mine.save(tmp_path / "mine.json")
    ref.save(tmp_path / "ref.json")
    assert robs.MetricsRegistry.load(tmp_path / "mine.json").snapshot() == mine.snapshot()
    assert MetricsRegistry.load(tmp_path / "ref.json").snapshot() == ref.snapshot()
    assert len(MetricsRegistry.load(tmp_path / "absent.json")) == 0
    (tmp_path / "bad.json").write_text(json.dumps({"format": 99}))
    with pytest.raises(ValueError, match="format"):
        MetricsRegistry.load(tmp_path / "bad.json")


def test_obs_cli_prints_what_the_reference_prints(tmp_path, capsys):
    good = save_chrome_trace(_sample(trace_mod), tmp_path / "good.json")
    tr = Tracer()
    tr.add_manual("program_iteration", 0.0, 1e-3, fingerprint="f", strategy="program/s=2")
    bad = save_chrome_trace(tr, tmp_path / "bad.json")
    it = tr.spans[0]
    tr.add_manual("exchange", 0.0, 1e-4, parent=it, fingerprint="f", strategy="s")
    tr.add_manual("exchange", 0.0, 1e-4, parent=it, fingerprint="f", strategy="s")
    multi = save_chrome_trace(tr, tmp_path / "multi.json")
    (tmp_path / "broken.json").write_text(json.dumps({"traceEvents": [{"ph": "B"}]}))
    for argv in (["validate", str(good)], ["summary", str(good)], ["validate", str(bad)],
                 ["validate", str(multi)], ["summary", str(multi)],
                 ["validate", str(tmp_path / "broken.json")],
                 ["validate", str(tmp_path / "missing.json")]):
        outs = []
        for main in (obs_cli.main, robs_cli.main):
            rc = main(argv)
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
        assert outs[0] == outs[1], argv
    assert obs_cli.main(["validate", str(multi)]) == 1
    assert "2 exchanges in one iteration" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# end to end: traced iterations -> drift audit; the production wiring
# ---------------------------------------------------------------------------

def test_traced_iterations_feed_the_drift_audit():
    tr = Tracer()
    decisions = DecisionCache()
    params = SystemParams.from_reference(name="s", **stencil_fields())
    comm = Communicator(params=params, device="cpu", decisions=decisions, tracer=tr)
    prog = build_halo_program(GRID, INTERIOR, comm, steps="auto")
    x = _state(prog.spec.alloc)
    for _ in range(4):
        x = prog.iteration(x, comm)
    iters = [s for s in tr.spans if s.name == "program_iteration"]
    assert len(iters) == 4
    assert len([s for s in tr.spans if s.name == "exchange"]) == 4
    rep = DriftDetector(min_samples=2).audit(decisions, params, trace=tr.phase_aggregates())
    prog_rows = [f for f in rep.findings if f.strategy.startswith("program/")]
    assert len(prog_rows) == 1
    assert prog_rows[0].source == "trace" and prog_rows[0].phase_ratios
    assert prog_rows[0].samples >= 4
    wire = [f for f in rep.findings if f.fingerprint == prog.plan.wire.fingerprint]
    assert wire and wire[0].source == "trace" and set(wire[0].phase_ratios) == {"wire"}


def test_production_communicator_traces_and_saves(tmp_path):
    comm, save = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          telemetry=True, tracer=True)
    prog = build_halo_program(GRID, INTERIOR, comm, steps=2)
    x = _state(prog.spec.alloc)
    for _ in range(2):
        prog.iteration(x, comm)
    save()
    tel = rfleet.ExchangeTelemetry.load(tmp_path / "telemetry.json")
    assert tel.get(prog.plan.wire.fingerprint).count == 2
    metrics = robs.MetricsRegistry.load(tmp_path / "metrics.json")
    assert metrics.counter("comm.exchanges") == comm.wire_ops > 0
    assert metrics.counter("telemetry.observations") > 0
    trace = robs.load_chrome_trace(save_chrome_trace(comm.tracer, tmp_path / "trace.json"))
    assert robs.validate(trace) == []
    assert sum(ev["name"] == "program_iteration" for ev in trace["traceEvents"]) == 2
