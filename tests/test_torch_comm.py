"""The port's comm layer against ``repro.comm``, and its local-mesh
transport.

* Strategy selection: for the 52 send and receive types of a small halo
  and the same parameter values on both sides (the analytic tables and
  three measured ones), ``PerfModel.select`` picks the same strategy at
  the same price (rel 1e-12), and every strategy's estimate agrees term
  by term.
* Wire plans: ``plan_wire`` with ``native`` passed explicitly to both
  packages gives the identical layout, schedule and byte accounting, and
  the model-priced schedule choice agrees.
* Transport: every schedule of the local mesh moves the same bytes (the
  periodic oracle's), and counts what it issues.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.comm.perfmodel as rpm
import repro.comm.wireplan as rwp
import repro.halo as rhalo
from repro.comm.api import Communicator as RefCommunicator
from repro_torch.comm import (
    Communicator,
    FixedPolicy,
    H100_ANALYTIC,
    PerfModel,
    SystemParams,
    plan_wire,
    reschedule,
)
from repro_torch.core import FLOAT, BYTE, Subarray, Vector
from repro_torch.halo import (
    HaloSpec,
    from_reference,
    halo_exchange,
    make_halo_plan,
    make_halo_types,
)

REF_FIELDS = ("hbm_bw", "ici_bw", "ici_latency", "kernel_launch", "dma_setup",
              "xla_copy_overhead")
PORT_FIELD = {"ici_bw": "link_bw", "ici_latency": "link_latency"}


def _ref_values(name):
    if name == "tpu_v5e":
        return {f: getattr(rpm.TPU_V5E, f) for f in REF_FIELDS}
    return {f: getattr(H100_ANALYTIC, PORT_FIELD.get(f, f)) for f in REF_FIELDS}


def synthetic_fields(seed=16):
    """Reference SystemParams fields with seeded measured tables: the
    measurement grid with a fifth of its points dropped (holes), an
    ``xla`` table only up to the calibration cap, and a wire table with
    its least-squares fit."""
    rng = np.random.default_rng(seed)

    def table(scale):
        rows = [(float(b), float(t), scale * (2e-6 + 2.0 ** t / rng.uniform(2e10, 2e11)))
                for b in (3, 5, 7, 9) for t in (10, 14, 18, 22)]
        keep = rng.random(len(rows)) > 0.2
        keep[0] = True
        return [r for r, k in zip(rows, keep) if k]

    def capped(rows):
        return [r for r in rows if r[1] - r[0] <= 9]

    wire = [(float(t), 1.5e-5 * rng.uniform(0.9, 1.1) + 2.0 ** t / 6e11)
            for t in (10, 14, 18, 22)]
    from repro.measure import fit_latency_bandwidth

    lat, bw = fit_latency_bandwidth(wire)
    return dict(
        _ref_values("h100"),
        pack_table={"rows": table(1.0), "dma": table(1.1), "xla": capped(table(3.0))},
        unpack_table={"rows": table(1.2), "dma": table(1.3), "xla": capped(table(3.5))},
        wire_table=wire, copy_table=[(float(t), 1e-6 + 2.0 ** t / 1e12) for t in (10, 22)],
        wire_latency=lat, wire_bw=bw,
    )


def _param_pair(name):
    """The same parameter values as the reference's and the port's
    SystemParams: the two analytic tables, the reference's checked-in
    ``ci_params.json``, a seeded synthetic table with holes, and the
    port's checked-in H100 tables."""
    if name == "ci":
        from repro.measure import ci_params_path, load_ci_params
        from repro_torch.measure import ParamsStore

        return load_ci_params(), ParamsStore.read_envelope(ci_params_path())
    if name == "h100_measured":
        from repro.measure import ParamsStore as RefStore
        from repro_torch.measure import h100_params_path, load_h100_params

        return RefStore.read_envelope(h100_params_path()), load_h100_params()
    values = synthetic_fields() if name == "synthetic" else _ref_values(name)
    return (rpm.SystemParams(name=name, **values),
            SystemParams.from_reference(name=name, **values))


MEASURED_TABLES = ["ci", "synthetic", "h100_measured"]


def _halo_types(interior=(6, 5, 4), params="tpu_v5e"):
    ref_params, params = _param_pair(params)
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params)
    comm = Communicator(params=params, device="cpu")
    ref_spec = rhalo.HaloSpec(grid=(2, 2, 2), interior=interior, radius=2)
    spec = HaloSpec(grid=(2, 2, 2), interior=interior, radius=2)
    ref_types = rhalo.make_halo_types(ref_spec, ref_comm)
    types = make_halo_types(spec, comm)
    pairs = []
    for d in rhalo.DIRECTIONS:
        for k in range(2):
            pairs.append((ref_types[d][k], types[d][k]))
    return ref_comm, comm, ref_spec, spec, pairs


def test_from_reference_maps_the_link_fields():
    p = SystemParams.from_reference(name="x", ici_bw=1.0, ici_latency=2.0, hbm_bw=3.0,
                                    pack_table=None)
    assert (p.link_bw, p.link_latency, p.hbm_bw) == (1.0, 2.0, 3.0)
    assert json.loads(p.to_json())["ici_bw"] == 1.0 and "link_bw" not in p.to_json()
    assert SystemParams.from_json(p.to_json()) == p
    assert H100_ANALYTIC.name == "h100_sxm_analytic_unmeasured"
    assert H100_ANALYTIC.hbm_bw == 3.35e12


PORTED_TABLES = {
    "pack_table": {"rows": [[3.0, 10.0, 1e-6], [3.0, 14.0, 2e-6]]},
    "unpack_table": {"dma": [[3.0, 10.0, 1e-6]]},
    "wire_table": [[10.0, 1e-5], [22.0, 2e-5]],
    "copy_table": [[10.0, 1e-6]],
    "wire_latency": 1e-5,
    "wire_bw": 1e11,
    "stencil_table": [[4.7, 10.0, 1e-6]],
    "compress_table": {"rlewire": [[10.0, 1e-6, 2e-6, 0.5], [14.0, 3e-6, 4e-6, 0.25]]},
    "wire_tables": {"ici": [[10.0, 1e-5]]},
    "wire_fits": {"ici": [1e-5, 1e11]},
    "link_tables": {"inter": [[10.0, 1e-5]], "ici/intra": [[10.0, 2e-6]]},
    "link_fits": {"inter": [1e-5, 1e11]},
}
#: the per-axis and link-class tables, refused before the port priced them
LATER_TABLES = ("link_fits", "link_tables", "wire_fits", "wire_tables")


@pytest.mark.parametrize("field", sorted(set(PORTED_TABLES) - set(LATER_TABLES))
                         + sorted(LATER_TABLES))
def test_from_reference_maps_the_ported_tables_and_refuses_later_ones(field):
    """Each measured table of the reference maps (frozen into tuples, so
    it is hashable and equal after a JSON round trip), the per-axis and
    link-class tables too; a field the port does not know raises."""
    with pytest.raises(ValueError, match="unknown reference field"):
        SystemParams.from_reference(name="x", **{field + "_x": [[1.0, 2.0]]})
    SystemParams.from_reference(name="x", **{field + "_x": None})  # empty is fine
    value = PORTED_TABLES[field]
    p = SystemParams.from_reference(name="x", **{field: value})
    ref = rpm.SystemParams(name="x", **{field: value})
    assert getattr(p, field) == getattr(ref, field)
    got = getattr(p, field)
    for table in (got.values() if isinstance(got, dict) else [got]):
        hash(table)  # the model keys its interpolators on the table
    assert SystemParams.from_json(p.to_json()) == p
    back = rpm.SystemParams.from_json(p.to_json())
    assert getattr(back, field) == getattr(ref, field)
    assert (back.ici_bw, back.ici_latency) == (p.link_bw, p.link_latency)


@pytest.mark.parametrize("allow_bounding", [True, False])
@pytest.mark.parametrize("params", ["tpu_v5e", "h100"] + MEASURED_TABLES)
def test_selection_matches_the_reference_on_the_52_halo_types(params, allow_bounding):
    ref_comm, comm, _, _, pairs = _halo_types(params=params)
    assert len(pairs) == 52
    for ref_ct, ct in pairs:
        assert ct.fingerprint == ref_ct.fingerprint
        want = ref_comm.model.select(ref_ct, 1, allow_bounding=allow_bounding)
        got = comm.model.select(ct, 1, allow_bounding=allow_bounding)
        assert got.strategy == want.strategy
        assert got.wire_bytes == want.wire_bytes
        assert got.total == pytest.approx(want.total, rel=1e-12, abs=0)
        for name in ("rows", "dma", "xla", "bounding"):
            e = comm.model.estimate(ct, 2, name)
            r = ref_comm.model.estimate(ref_ct, 2, name)
            for term in ("t_pack", "t_link", "t_unpack"):
                assert getattr(e, term) == pytest.approx(getattr(r, term), rel=1e-12, abs=0)
            assert e.wire_bytes == r.wire_bytes
        assert comm.select(ct, 1, wire=allow_bounding).name == ref_comm.select(
            ref_ct, 1, wire=allow_bounding).name


PLAN_FIELDS = ("nranks", "groups", "group_offsets", "schedule", "fused", "wire_bytes",
               "seg_bytes", "send_rows", "recv_rows", "issued_bytes", "wire_ops",
               "padding_bytes", "fingerprint")


def _same_plan(plan, ref):
    for f in PLAN_FIELDS:
        got, want = getattr(plan, f), getattr(ref, f)
        if f == "groups":
            got = [dataclasses.astuple(g) for g in got]
            want = [dataclasses.astuple(g) for g in want]
        assert got == want, f
    assert [dataclasses.astuple(s) for s in plan.segments] == [
        dataclasses.astuple(s) for s in ref.segments
    ]


@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 2, 4), (4, 4, 4)])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("tolerance", [0.0, 1.0])
def test_plan_wire_matches_the_reference(grid, native, tolerance):
    ref_comm, comm, _, _, pairs = _halo_types()
    ref_spec = rhalo.HaloSpec(grid=grid, interior=(6, 5, 4), radius=2)
    spec = HaloSpec(grid=grid, interior=(6, 5, 4), radius=2)
    perms = tuple(tuple(spec.perm(d)) for d in rhalo.DIRECTIONS)
    assert perms == tuple(tuple(ref_spec.perm(d)) for d in rhalo.DIRECTIONS)
    sends = pairs[0::2]
    sizes = tuple(ct.packed_extent() for _, ct in sends)
    fps = tuple(ct.fingerprint for _, ct in sends)
    plan = plan_wire(sizes, perms, fingerprints=fps, uniform_waste_tolerance=tolerance,
                     native=native)
    ref = rwp.plan_wire(sizes, perms, fingerprints=fps, uniform_waste_tolerance=tolerance,
                        native=native)
    _same_plan(plan, ref)
    for sched in ("grouped", "uniform", "ragged"):
        if sched != "grouped" and not ref.fused:
            with pytest.raises(ValueError):
                reschedule(plan, sched)
            continue
        _same_plan(reschedule(plan, sched), rwp.reschedule(ref, sched))
    got, got_costs = comm.model.choose_wire_schedule(plan, native)
    want, want_costs = ref_comm.model.choose_wire_schedule(ref, native=native)
    assert got.schedule == want.schedule
    assert got_costs.keys() == want_costs.keys()
    for k in want_costs:
        assert got_costs[k] == pytest.approx(want_costs[k], rel=1e-12, abs=0)
    est, ref_est = comm.model.price_exchange(got), ref_comm.model.price_exchange(want)
    assert (est.strategy, est.wire_bytes) == (ref_est.strategy, ref_est.wire_bytes)
    assert est.total == pytest.approx(ref_est.total, rel=1e-12, abs=0)


@pytest.mark.parametrize("policy", ["exact", "model"])
def test_halo_plan_matches_the_reference(policy):
    """The whole halo setup (types, strategies, layout) agrees; only the
    native-ragged answer differs by construction, so the reference's plan
    is re-laid out with the port's transport's answer."""
    ref_comm, comm, ref_spec, spec, _ = _halo_types()
    ref_plan = rhalo.make_halo_plan(ref_spec, ref_comm, schedule_policy=policy)
    plan = make_halo_plan(spec, comm, schedule_policy=policy)
    assert [s.name for s in plan.strategies] == [s.name for s in ref_plan.strategies]
    assert [ct.fingerprint for ct in plan.send_cts] == [ct.fingerprint for ct in ref_plan.send_cts]
    assert [ct.fingerprint for ct in plan.recv_cts] == [ct.fingerprint for ct in ref_plan.recv_cts]
    assert plan.perms == ref_plan.perms
    segs = [s.wire_segment(ct) for s, ct in zip(ref_plan.strategies, ref_plan.send_cts)]
    ref_wire = rwp.plan_wire(
        tuple(s.nbytes for s in segs), ref_plan.perms,
        fingerprints=tuple(s.fingerprint for s in segs), native=comm.transport.native_ragged,
    )
    if policy == "model":
        ref_wire, _ = ref_comm.model.choose_wire_schedule(
            ref_wire, native=comm.transport.native_ragged)
    _same_plan(plan.wire, ref_wire)
    assert plan.wire_bytes == ref_plan.wire_bytes


# ---------------------------------------------------------------------------
# the local-mesh transport
# ---------------------------------------------------------------------------

def _halo_state(spec):
    r = spec.radius
    nz, ny, nx = spec.interior
    g = [p * n for p, n in zip(spec.grid, spec.interior)]
    gvals = np.arange(np.prod(g), dtype=np.float32).reshape(g)
    local = np.full((spec.nranks,) + spec.alloc, -1.0, np.float32)
    want = np.empty_like(local)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        local[rank, r:r + nz, r:r + ny, r:r + nx] = gvals[
            c[0] * nz:(c[0] + 1) * nz, c[1] * ny:(c[1] + 1) * ny, c[2] * nx:(c[2] + 1) * nx]
        idx = [(np.arange(a) - r + ci * n) % gn
               for a, ci, n, gn in zip(spec.alloc, c, spec.interior, g)]
        want[rank] = gvals[np.ix_(*idx)]
    return local, want


@pytest.mark.parametrize("schedule", ["grouped", "uniform", "ragged"])
@pytest.mark.parametrize("strategy", ["rows", "bounding"])
def test_every_schedule_moves_the_same_bytes(schedule, strategy):
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    comm = Communicator(policy=FixedPolicy(strategy), device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    plan = dataclasses.replace(plan, wire=reschedule(plan.wire, schedule))
    start, want = _halo_state(spec)
    local = from_reference(start, spec, device="cpu")
    halo_exchange(local, spec, comm, plan=plan)
    np.testing.assert_array_equal(local.numpy(), want)
    assert comm.wire_ops == plan.wire.wire_ops == (7 if schedule == "grouped" else 1)
    assert comm.wire_payload_bytes == plan.wire.issued_bytes
    if schedule != "uniform":
        assert comm.wire_payload_bytes == plan.wire_bytes


@pytest.mark.parametrize("schedule", ["varlen", "tiered"])
def test_unported_schedules_raise(schedule):
    """Both schedules are ported; each raises the reference's ValueError
    on a plan without its annotation, in the transport and in the model:
    ``varlen`` without stream lengths, ``tiered`` without a topology."""
    spec = HaloSpec(grid=(2, 2, 2), interior=(4, 4, 4), radius=2)
    comm = Communicator(device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    wire = dataclasses.replace(plan.wire, schedule=schedule)
    match = "stream-unannotated" if schedule == "varlen" else "unannotated plan"
    with pytest.raises(ValueError, match=match):
        comm.transport.exchange(torch.zeros((8, wire.wire_bytes), dtype=torch.uint8), wire)
    with pytest.raises(ValueError, match="stream-annotated" if schedule == "varlen"
                       else "topology-annotated"):
        comm.model.price_exchange(wire)


@pytest.mark.parametrize("mode", ["rows", "dma", "bounding", "xla"])
@pytest.mark.parametrize("incount", [1, 2])
def test_sendrecv_on_the_local_mesh(mode, incount):
    """Rank r's packed vector lands in rank perm(r)'s buffer, in place."""
    R = 4
    comm = Communicator(policy=FixedPolicy(mode), device="cpu")
    ct = comm.commit(Vector(6, 5, 12, FLOAT))
    perm = [(r, (r + 1) % R) for r in range(R)]
    n = ct.extent * incount // 4 + 3
    src = torch.arange(R * n, dtype=torch.float32).view(R, n)
    dst = torch.full((R, n), -1.0)
    assert comm.sendrecv(src, dst, ct, perm, incount=incount) is dst
    idx = np.concatenate([
        np.arange(6 * 5).reshape(6, 5) // 5 * 12 + np.arange(5) + rep * ct.extent // 4
        for rep in range(incount)
    ]).reshape(-1)
    want = np.full((R, n), -1.0, np.float32)
    for s, d in perm:
        want[d, idx] = src.numpy()[s, idx]
    np.testing.assert_array_equal(dst.numpy(), want)
    assert comm.wire_ops == 1
    assert comm.wire_payload_bytes == comm.select(ct, incount).wire_bytes(ct, incount)


def test_pack_and_unpack_serve_every_rank():
    R = 3
    comm = Communicator(device="cpu")
    ct = comm.commit(Subarray((16, 8, 4), (5, 3, 2), (2, 1, 1), BYTE))
    buf = torch.randint(0, 256, (R, 16 * 8 * 4), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(5))
    packed = comm.pack(buf, ct)
    assert tuple(packed.shape) == (R, ct.size)
    out = torch.zeros_like(buf)
    assert comm.unpack(out, packed, ct) is out
    for r in range(R):
        np.testing.assert_array_equal(packed[r].numpy(), comm.pack(buf[r:r + 1], ct)[0].numpy())
    np.testing.assert_array_equal(comm.pack(out, ct).numpy(), packed.numpy())


def test_model_caches_selections():
    model = PerfModel()
    comm = Communicator(device="cpu")
    ct = comm.commit(Vector(13, 25, 64, FLOAT))
    a = model.select(ct)
    assert model.select(ct) is a
    assert (model.lookups, model.hits) == (2, 1)


def test_segments_at_odd_wire_offsets():
    """Two byte types share one delta class, so the second segment starts
    at byte 15 of the wire; the exchange still moves exactly its bytes."""
    R = 2
    comm = Communicator(policy=FixedPolicy("rows"), device="cpu")
    send = [comm.commit(Subarray((16, 16), (5, 3), (0, 0), BYTE)),
            comm.commit(Subarray((16, 16), (8, 4), (0, 4), BYTE))]
    recv = [comm.commit(Subarray((16, 16), (5, 3), (8, 8), BYTE)),
            comm.commit(Subarray((16, 16), (8, 4), (8, 12), BYTE))]
    perm = [(0, 1), (1, 0)]
    _, plan = comm.plan_neighbor(send, [perm, perm], schedule_policy="exact")
    assert [s.offset for s in plan.segments] == [0, 15]
    buf = torch.randint(0, 256, (R, 256), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(11))
    want = buf.numpy().copy().reshape(R, 16, 16)
    src = buf.numpy().copy().reshape(R, 16, 16)
    for s, d in perm:
        want[d, 8:11, 8:13] = src[s, 0:3, 0:5]
        want[d, 12:16, 8:16] = src[s, 4:8, 0:8]
    out = comm.neighbor_alltoallv(buf, send, recv, [perm, perm], plan=plan)
    assert out is buf
    np.testing.assert_array_equal(buf.numpy().reshape(R, 16, 16), want)
    assert comm.wire_payload_bytes == plan.wire_bytes == 15 + 32


# ---------------------------------------------------------------------------
# the public names the reference's tests use
# ---------------------------------------------------------------------------

@pytest.fixture
def exact_reference_ladder(monkeypatch):
    """The reference planner without its native ragged collective (XLA:CPU
    cannot run it), its ``plan_wire`` cache cleared around the patch."""
    import repro.compat

    rwp.plan_wire.cache_clear()
    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    yield
    rwp.plan_wire.cache_clear()


@pytest.mark.parametrize("grid", [(2, 2, 2), (3, 3, 3)])
def test_plan_neighbor_alltoallv_is_the_references(grid, exact_reference_ladder):
    from repro.comm.api import plan_neighbor_alltoallv as ref_plan
    from repro_torch.comm import plan_neighbor_alltoallv

    _, _, _, _, pairs = _halo_types()
    spec = HaloSpec(grid=grid, interior=(6, 5, 4), radius=2)
    perms = [spec.perm(d) for d in rhalo.DIRECTIONS]
    sends = pairs[0::2]
    sizes = [ct.packed_extent() for _, ct in sends]
    fps = tuple(ct.fingerprint for _, ct in sends)
    _same_plan(plan_neighbor_alltoallv(sizes, perms, fingerprints=fps),
               ref_plan(sizes, perms, fingerprints=fps))


def test_strategy_registry_copy_is_independent():
    from repro_torch.comm import StrategyRegistry, default_registry
    from repro_torch.comm.api import Strategy

    class Probe(Strategy):
        name = "probe_copy"

    src = default_registry()
    dup = src.copy()
    assert isinstance(dup, StrategyRegistry) and dup is not src
    assert dup.names() == src.names()
    assert [dup.get(n) for n in dup.names()] == [src.get(n) for n in src.names()]
    dup.register(Probe())
    assert "probe_copy" in dup and "probe_copy" not in src
    empty = StrategyRegistry()
    other = empty.copy()
    other.register(Probe())
    assert len(empty) == 0 and len(other) == 1


@pytest.mark.parametrize("params", ["tpu_v5e", "synthetic"])
@pytest.mark.parametrize("strategy", ["rows", "dma", "xla", "ref"])
@pytest.mark.parametrize("incount", [1, 3])
def test_t_pack_and_t_unpack_are_the_references(params, strategy, incount):
    ref_comm, comm, _, _, pairs = _halo_types(params=params)
    for ref_ct, ct in pairs:
        for term in ("t_pack", "t_unpack"):
            got = getattr(comm.model, term)(ct, incount, strategy)
            want = getattr(ref_comm.model, term)(ref_ct, incount, strategy)
            assert got == pytest.approx(want, rel=1e-12, abs=0), (term, ref_ct)


PAYLOAD_REFERENCE = r"""
import json
import numpy as np
import jax
import jax.core, jax.extend.core
import jax.numpy as jnp
from jax.sharding import Mesh
import repro.compat
# the reference's counter walks jax.core.Jaxpr, which JAX 0.9 moved to
# jax.extend.core; its native ragged collective does not run on XLA:CPU
jax.core.Jaxpr, jax.core.ClosedJaxpr = jax.extend.core.Jaxpr, jax.extend.core.ClosedJaxpr
repro.compat.has_ragged_all_to_all = lambda: False
from repro.comm import Communicator, FixedPolicy, collective_payload_bytes
from repro.halo import HaloSpec, make_halo_plan, make_halo_step

spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
mesh = Mesh(np.array(jax.devices()), ("ranks",))
comm = Communicator(axis_name="ranks", policy=FixedPolicy("rows"))
plan = make_halo_plan(spec, comm, schedule_policy="exact")
step = make_halo_step(spec, comm, mesh, schedule_policy="exact")
x0 = jnp.zeros((spec.nranks * spec.alloc[0],) + tuple(spec.alloc[1:]), jnp.float32)
print(json.dumps({"counts": collective_payload_bytes(step, x0), "wire_bytes": plan.wire_bytes}))
"""


def test_collective_payload_bytes_of_the_halo_exchange_is_the_references():
    from repro_torch.comm import WIRE_COLLECTIVES, collective_payload_bytes
    from repro_torch.halo import make_halo_step
    from tests._subproc import run_with_devices

    want = json.loads(run_with_devices(PAYLOAD_REFERENCE, ndev=8).strip().splitlines()[-1])
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    comm = Communicator(policy=FixedPolicy("rows"), device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    step = make_halo_step(spec, comm, device="cpu", schedule_policy="exact")
    local, _ = _halo_state(spec)
    got = collective_payload_bytes(step, torch.from_numpy(local))
    assert got == want["counts"]
    assert got == {"ops": 7, "ppermute": plan.wire_bytes, "total": plan.wire_bytes}
    assert plan.wire_bytes == want["wire_bytes"]
    assert set(got) - {"ops", "total"} <= set(WIRE_COLLECTIVES)
    # the other schedules name their primitives as the reference's jaxpr does
    for sched, prim, ops in (("uniform", "all_to_all", 1), ("ragged", "ragged_all_to_all", 1)):
        p = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
        counts = collective_payload_bytes(
            lambda x, p=p: halo_exchange(x, spec, comm, plan=p), torch.from_numpy(local))
        assert counts == {"ops": ops, prim: p.wire.issued_bytes, "total": p.wire.issued_bytes}
