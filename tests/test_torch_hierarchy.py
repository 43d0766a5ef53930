"""Hierarchy and scale in the port, against ``repro.comm`` on the same
inputs: the two-level topology's link classes and tier bundles, the
per-axis and per-link-class wire tables, tier-aware pricing (the
inter == intra oracle bit for bit, the slow tier to 1e-12 of the
reference), the ``tiered`` schedule on the local mesh, simulated-scale
pricing to 3072 ranks, and the decision hygiene of an elastic re-mesh
(``DecisionCache.prune``, ``replan_on_remesh``).

Everything here runs on the CPU at small sizes, except the
planning-only checks at full width (the 2x2x2 and 3x3x3 grids of 256^3
blocks, radius 2), which lay plans out and price them without a buffer.  The
reference side plans and prices only (no JAX collective runs).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.comm.perfmodel as rpm
import repro.comm.scale as rscale
import repro.comm.wireplan as rwp
import repro.halo as rhalo
import repro.measure as rmeasure
import repro.train.elastic as relastic
from repro.comm.api import Communicator as RefCommunicator
from repro.comm.topology import Topology as RefTopology
from repro_torch.comm import (
    Communicator,
    FixedPolicy,
    H100_ANALYTIC,
    PerfModel,
    StrategyEstimate,
    SystemParams,
    Topology,
    build_scale_plan,
    plan_wire,
    policy_for_mode,
    reschedule,
    scale_ladder,
    synthetic_two_tier,
)
from repro_torch.core import FLOAT, Subarray
from repro_torch.halo import (
    STENCIL26,
    HaloSpec,
    build_halo_program,
    from_reference,
    halo_exchange,
    make_halo_plan,
    program_fingerprint,
)
from repro_torch.measure import (
    Decision,
    DecisionCache,
    ParamsStore,
    calibrate_params,
    load_h100_params,
    measure_link_class_tables,
    measure_wire_tables,
)
from repro_torch.train import ElasticPolicy, replan_on_remesh
from test_torch_comm import _param_pair, _ref_values
from test_torch_program import _blocks, _global, _oracle_blocks

# ===========================================================================
# the reference's shared geometry (tests/test_hierarchy.py): 8 ranks, 4 a
# node; an intra class and two inter classes with one destination-node
# vector but different destination ranks, which coalesce into one bundle
# ===========================================================================

TOPO84 = Topology.blocked(8, 4)


def _xor1(n):
    return tuple((r, r ^ 1) for r in range(n))


def _shift(n, k):
    return tuple((r, (r + k) % n) for r in range(n))


def _shift_xor(n, k):
    return tuple((r, ((r + k) % n) ^ 1) for r in range(n))


PERMS_TIER = (_xor1(8), _shift(8, 4), _shift_xor(8, 4))
SIZES_TIER = (8, 12, 16)
#: a topology whose nodes differ in size: on a (5, 1, 1) grid each inter
#: class is a bundle of one, so tiered issues no correction hop
UNEVEN = (0, 0, 0, 1, 1)
ALL_PARAMS = ["tpu_v5e", "h100", "ci", "synthetic", "h100_measured"]
#: the param sets with a measured wire sweep: the oracle's intra table is
#: that sweep (without one, synthetic_two_tier interpolates a two-point
#: analytic table, which the flat analytic formula is not)
MEASURED = ["ci", "synthetic", "h100_measured"]
LADDER = (8, 16, 64, 256, 1024, 3072)


def _ref_topo(topo):
    return RefTopology(nodes=topo.nodes)


def _pair_plans(sizes, perms, topo, fingerprints=None):
    """The same layout planned by both packages, annotated with ``topo``."""
    perms = tuple(tuple(map(tuple, p)) for p in perms)
    port = plan_wire(tuple(sizes), perms, fingerprints=fingerprints, native=False,
                     topology=topo)
    ref = rwp.plan_wire(tuple(sizes), perms, fingerprints=fingerprints, native=False,
                        topology=_ref_topo(topo))
    return port, ref


def _halo_pair(grid, topo, interior=(6, 5, 4), radius=2, params="h100"):
    """A small halo's wire plan (laid out by the port's planner) and the
    reference's plan of the same segments and permutations."""
    _, p = _param_pair(params)
    comm = Communicator(params=p, device="cpu", topology=topo)
    spec = HaloSpec(grid=grid, interior=interior, radius=radius)
    wire = make_halo_plan(spec, comm, schedule_policy="exact").wire
    perms = tuple(g.perm for g in wire.groups)
    sizes = tuple(g.nbytes for g in wire.groups)
    return _pair_plans(sizes, perms, topo)


PLANS = {
    "tier84": lambda: _pair_plans(SIZES_TIER, PERMS_TIER, TOPO84),
    "halo222": lambda: _halo_pair((2, 2, 2), TOPO84),
    "halo333": lambda: _halo_pair((3, 3, 3), Topology.blocked(27, 9)),
    "uneven": lambda: _halo_pair((5, 1, 1), Topology(UNEVEN)),
}


def _flat(plan):
    return dataclasses.replace(plan, link_classes=None, tier_bundles=(), topology=None)


# ===========================================================================
# plans: link classes, bundles and fingerprints equal the reference's
# ===========================================================================

@pytest.mark.parametrize("schedule", ["grouped", "tiered"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_annotated_plans_equal_the_reference(case, schedule):
    port, ref = PLANS[case]()
    port, ref = reschedule(port, schedule), rwp.reschedule(ref, schedule)
    assert port.link_classes == ref.link_classes
    assert port.tier_bundles == ref.tier_bundles
    assert port.topology.fingerprint == ref.topology.fingerprint
    assert port.fingerprint == ref.fingerprint
    for attr in ("wire_bytes", "correction_bytes", "issued_bytes", "inter_messages",
                 "wire_ops", "ngroups"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def test_tier_layouts_are_the_expected_ones():
    tier, _ = PLANS["tier84"]()
    assert tier.link_classes == ("intra", "inter", "inter")
    assert tier.tier_bundles == ((1, 2),)
    tiered = reschedule(tier, "tiered")
    assert (tiered.wire_ops, tiered.correction_bytes, tiered.inter_messages) == (3, 16, 1)
    assert tier.inter_messages == 2
    uneven, _ = PLANS["uneven"]()
    assert uneven.tier_bundles == ((0,), (2,)) and uneven.correction_bytes == 0
    with pytest.raises(ValueError, match="topology-annotated"):
        reschedule(_flat(tier), "tiered")


# ===========================================================================
# parameters: the two-tier tables and the lookups
# ===========================================================================

@pytest.mark.parametrize("factors", [(20.0, 4.0), (1.0, 1.0), (3.0, 2.0)])
@pytest.mark.parametrize("params", ALL_PARAMS)
def test_synthetic_two_tier_equals_the_reference(params, factors):
    ref_p, p = _param_pair(params)
    got = synthetic_two_tier(p, *factors)
    want = rpm.synthetic_two_tier(ref_p, *factors)
    assert got.link_tables == want.link_tables
    assert got.link_fits == want.link_fits
    assert set(got.link_tables) == {"intra", "inter"}
    if factors == (1.0, 1.0):
        assert got.link_tables["inter"] == got.link_tables["intra"]
    else:
        intra, inter = dict(got.link_tables["intra"]), dict(got.link_tables["inter"])
        assert all(inter[x] > intra[x] for x in intra)
    # the four fields round-trip through JSON, in both packages
    back = SystemParams.from_json(got.to_json())
    assert back == got
    ref_back = rpm.SystemParams.from_json(got.to_json())
    assert (ref_back.link_tables, ref_back.link_fits) == (want.link_tables, want.link_fits)


def _axis_params():
    """Reference SystemParams fields with per-axis and per-link-class
    tables, a class table keyed by axis, and a fit missing its rate."""
    rows = lambda lat, bw: [(float(x), lat + 2.0 ** x / bw) for x in (10, 14, 18, 22)]
    return dict(
        _ref_values("h100"),
        wire_table=rows(2e-5, 5e10), wire_latency=2e-5, wire_bw=5e10,
        wire_tables={"ici": rows(1e-5, 1e11), "dcn": rows(5e-5, 1e10)},
        wire_fits={"ici": (1e-5, 1e11), "dcn": (5e-5, None)},
        link_tables={"intra": rows(1e-5, 2e11), "inter": rows(8e-5, 1e10),
                     "dcn/inter": rows(2e-4, 5e9)},
        link_fits={"intra": (1e-5, 2e11), "inter": (8e-5, 1e10)},
    )


@pytest.mark.parametrize("link_class", [None, "intra", "inter"])
@pytest.mark.parametrize("axis", [None, "ici", "dcn", "absent"])
def test_link_lookup_order_equals_the_reference(axis, link_class):
    """``"<axis>/<class>"``, then ``"<class>"``, then the per-axis table,
    then the flat one, with extra hops at the axis fit's latency."""
    fields = _axis_params()
    port = PerfModel(SystemParams.from_reference(name="x", **fields), axis="ici")
    ref = rpm.PerfModel(rpm.SystemParams(name="x", **fields), axis="ici")
    for nbytes in (1, 5000, 1 << 20, 1 << 26):
        for hops in (1, 3):
            got = port.t_link(nbytes, hops, axis, link_class)
            assert got == ref.t_link(nbytes, hops, axis, link_class)
    assert port._hop_latency(axis) == ref._hop_latency(axis)


# ===========================================================================
# tier-aware pricing
# ===========================================================================

def _streamed(plan):
    return plan.with_stream_bytes(tuple(max(g.nbytes // 2, 1) for g in plan.groups))


@pytest.mark.parametrize("case", sorted(PLANS))
@pytest.mark.parametrize("params", MEASURED)
def test_inter_equal_to_intra_prices_flat_bit_for_bit(params, case):
    """With ``inter == intra`` every surcharge is exactly 0.0: each
    schedule of the annotated plan costs what it costs flat, ``tiered``
    never undercuts ``grouped``, and the winner is the flat one."""
    _, p = _param_pair(params)
    eq = PerfModel(synthetic_two_tier(p, 1.0, 1.0))
    topo, _ = PLANS[case]()
    flat = _flat(topo)
    for native in (False, True):
        flat_costs = eq.price_wire_schedules(flat, native)
        topo_costs = eq.price_wire_schedules(topo, native)
        for s, c in flat_costs.items():
            assert topo_costs[s] == c, s
        assert set(topo_costs) == set(flat_costs) | {"tiered"}
        assert topo_costs["tiered"] >= topo_costs["grouped"]
        assert eq.choose_wire_schedule(topo, native)[0].schedule == \
            eq.choose_wire_schedule(flat, native)[0].schedule
    assert eq._price_schedule(_streamed(topo), "varlen") == \
        eq._price_schedule(_streamed(flat), "varlen")


@pytest.mark.parametrize("case", sorted(PLANS))
@pytest.mark.parametrize("params", ALL_PARAMS)
def test_slow_tier_prices_equal_the_reference(params, case):
    ref_p, p = _param_pair(params)
    model = PerfModel(synthetic_two_tier(p))
    ref_model = rpm.PerfModel(rpm.synthetic_two_tier(ref_p))
    port, ref = PLANS[case]()
    for native in (False, True):
        got = model.price_wire_schedules(port, native)
        want = ref_model.price_wire_schedules(ref, native=native)
        assert got.keys() == want.keys()
        for s in want:
            assert got[s] == pytest.approx(want[s], rel=1e-12, abs=0), s
        assert model.choose_wire_schedule(port, native)[0].schedule == \
            ref_model.choose_wire_schedule(ref, native=native)[0].schedule
    for sched, plan, rplan in (("varlen", _streamed(port), _streamed(ref)),
                               ("tiered", port, ref)):
        plan, rplan = reschedule(plan, sched), rwp.reschedule(rplan, sched)
        assert model.price_exchange(plan).total == pytest.approx(
            ref_model.price_exchange(rplan).total, rel=1e-12, abs=0)
    # a flat plan ignores the link tables
    assert PerfModel(p).price_wire_schedules(_flat(port)) == \
        model.price_wire_schedules(_flat(port))


def test_slow_tier_makes_coalescing_win():
    _, p = _param_pair("h100_measured")
    tier, _ = PLANS["tier84"]()
    costs = PerfModel(synthetic_two_tier(p)).price_wire_schedules(tier)
    assert costs["tiered"] < costs["grouped"]


def test_decision_rows_carry_the_topology_byte_for_byte():
    """The port's decisions file records the same rows as the
    reference's, ``topo=<fingerprint>`` tag included."""
    ref_p, p = _param_pair("h100_measured")
    port, ref = PLANS["halo222"]()
    dc, rdc = DecisionCache(), rmeasure.DecisionCache()
    model = PerfModel(synthetic_two_tier(p), decisions=dc)
    ref_model = rpm.PerfModel(rpm.synthetic_two_tier(ref_p), decisions=rdc)
    for sched in ("grouped", "tiered", "uniform"):
        model.price_exchange(reschedule(port, sched), note=" n")
        ref_model.price_exchange(rwp.reschedule(ref, sched), note=" n")
    assert len(dc.log) == 3
    assert all(f"topo={TOPO84.fingerprint}" in d.signature for d in dc.log)
    assert dc.to_json() == rdc.to_json()


# ===========================================================================
# the tiered schedule on the local mesh
# ===========================================================================

TIERED_GRIDS = {
    "222": ((2, 2, 2), TOPO84),
    "333": ((3, 3, 3), Topology.blocked(27, 9)),
    "uneven": ((5, 1, 1), Topology(UNEVEN)),
}


@pytest.mark.parametrize("mode", ["tempi", "bounding"])
@pytest.mark.parametrize("case", sorted(TIERED_GRIDS))
def test_tiered_halo_exchange_is_bit_exact(case, mode):
    """``tiered`` fills every halo cell as ``grouped`` and the periodic
    field do, and the transport issues the plan's ops and bytes."""
    grid, topo = TIERED_GRIDS[case]
    spec = HaloSpec(grid=grid, interior=(4, 5, 6), radius=(2, 1, 2))
    policy = policy_for_mode(mode) if mode == "tempi" else FixedPolicy(mode)
    comm = Communicator(policy=policy, device="cpu", topology=topo)
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    g = _global(tuple(p * n for p, n in zip(grid, spec.interior)), 23)
    want = _oracle_blocks(spec, g)
    out = {}
    for sched in ("grouped", "tiered"):
        wire = reschedule(plan.wire, sched)
        local = from_reference(_blocks(spec, g), spec, device="cpu")
        ops, nbytes = comm.wire_ops, comm.wire_payload_bytes
        halo_exchange(local, spec, comm, plan=dataclasses.replace(plan, wire=wire))
        assert comm.wire_ops - ops == wire.wire_ops == wire.ngroups
        assert comm.wire_payload_bytes - nbytes == wire.issued_bytes
        out[sched] = local.numpy()
    np.testing.assert_array_equal(out["tiered"], out["grouped"])
    np.testing.assert_array_equal(out["tiered"], want)
    tiered = reschedule(plan.wire, "tiered")
    assert tiered.issued_bytes == plan.wire_bytes + tiered.correction_bytes
    assert tiered.inter_messages == len(tiered.tier_bundles)
    assert plan.wire.inter_messages == plan.wire.link_classes.count("inter")


def test_tiered_neighbor_alltoallv_on_the_reference_layout():
    """The reference's ``PERMS_TIER``/``SIZES_TIER`` on ``TOPO84`` through
    ``ineighbor_alltoallv``: the two inter classes, bound for different
    ranks of one node, ride one bundle, and every rank receives what
    ``grouped`` and the numpy oracle give it."""
    comm = Communicator(policy=FixedPolicy("rows"), device="cpu", topology=TOPO84)
    n = [s // 4 for s in SIZES_TIER]
    send = [comm.commit(Subarray((64,), (k,), (8 * i,), FLOAT)) for i, k in enumerate(n)]
    recv = [comm.commit(Subarray((64,), (k,), (32 + 8 * i,), FLOAT)) for i, k in enumerate(n)]
    strats, plan = comm.plan_neighbor(send, PERMS_TIER, schedule_policy="exact")
    assert plan.schedule == "grouped" and plan.tier_bundles == ((1, 2),)
    start = np.random.default_rng(5).normal(size=(8, 64)).astype(np.float32)
    want = start.copy()
    for i, perm in enumerate(PERMS_TIER):
        for s, d in perm:
            want[d, 32 + 8 * i:32 + 8 * i + n[i]] = start[s, 8 * i:8 * i + n[i]]
    for sched in ("grouped", "tiered"):
        wire = reschedule(plan, sched)
        buf = torch.from_numpy(start.copy())
        ops, nbytes = comm.wire_ops, comm.wire_payload_bytes
        req = comm.ineighbor_alltoallv(buf, send, recv, PERMS_TIER, plan=wire,
                                       strategies=strats)
        drained = [req.wait_any().index for _ in range(3)]
        assert sorted(drained) == [0, 1, 2]
        np.testing.assert_array_equal(req.wait().numpy(), want)
        assert (comm.wire_ops - ops, comm.wire_payload_bytes - nbytes) == (
            3, wire.issued_bytes)
    assert reschedule(plan, "tiered").issued_bytes == sum(SIZES_TIER) + SIZES_TIER[2]


def test_tiered_on_an_unannotated_plan_raises():
    comm = Communicator(device="cpu")
    spec = HaloSpec(grid=(2, 2, 2), interior=(4, 4, 4), radius=1)
    wire = dataclasses.replace(make_halo_plan(spec, comm).wire, schedule="tiered")
    with pytest.raises(ValueError, match="tiered schedule on an unannotated plan"):
        comm.transport.exchange(torch.zeros((8, wire.wire_bytes), dtype=torch.uint8), wire)
    with pytest.raises(ValueError, match="topology-annotated"):
        comm.model.price_exchange(wire)


# ===========================================================================
# the main path's picks, planned only: a topology changes nothing under
# tables with no link tables
# ===========================================================================

@pytest.mark.parametrize("params", ["analytic", "h100_measured"])
def test_binding_a_topology_leaves_the_main_path_unchanged(params):
    p = H100_ANALYTIC if params == "analytic" else load_h100_params()
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    flat = make_halo_plan(spec, Communicator(params=p, device="cpu"))
    comm = Communicator(params=p, device="cpu", topology=TOPO84)
    plan = make_halo_plan(spec, comm)
    assert [s.name for s in plan.strategies] == [s.name for s in flat.strategies]
    assert plan.wire.schedule == flat.wire.schedule
    # the layout is the flat one; only the annotation keys the fingerprint
    assert _flat(plan.wire).fingerprint == flat.wire.fingerprint
    assert plan.wire.fingerprint != flat.wire.fingerprint
    assert plan.wire.topology == TOPO84
    costs = comm.model.price_wire_schedules(plan.wire)
    assert costs["tiered"] > costs["grouped"]
    assert min(costs, key=costs.get) != "tiered"
    tiered = reschedule(plan.wire, "tiered")
    assert tiered.issued_bytes == plan.wire_bytes + tiered.correction_bytes
    assert (tiered.wire_ops, tiered.inter_messages) == (7, 1)
    assert reschedule(plan.wire, "grouped").inter_messages == 4
    if params == "analytic":
        assert (plan.wire_bytes, tiered.issued_bytes) == (3_195_136, 4_276_480)


#: the full-width grids of chip_smoke.py's [tiered] phase (256^3 blocks,
#: radius 2): ranks a node, then ops, slow-tier messages tiered and
#: grouped, and bytes a rank under tiered.  At 3x3x3 the two bundles'
#: representatives are 32-byte corner classes, so the correction is
#: 1,081,536 bytes, not the 2x2x2 grid's 1,081,344.
FULL_WIDTH_TIERS = {
    (2, 2, 2): (4, (7, 1, 4, 4_276_480)),
    (3, 3, 3): (9, (26, 2, 18, 4_276_672)),
}


@pytest.mark.parametrize("grid", sorted(FULL_WIDTH_TIERS), ids=["222", "333"])
def test_full_width_tier_figures_equal_the_reference(grid):
    rpn, want = FULL_WIDTH_TIERS[grid]
    topo = Topology.blocked(int(np.prod(grid)), rpn)
    spec = HaloSpec(grid=grid, interior=(256, 256, 256), radius=2)
    wire = make_halo_plan(spec, Communicator(params=H100_ANALYTIC, device="cpu",
                                             topology=topo)).wire
    tiered, grouped = reschedule(wire, "tiered"), reschedule(wire, "grouped")
    assert wire.wire_bytes == 3_195_136
    assert (tiered.wire_ops, tiered.inter_messages, grouped.inter_messages,
            tiered.issued_bytes) == want
    port, ref = _pair_plans(tuple(g.nbytes for g in wire.groups),
                            tuple(g.perm for g in wire.groups), topo)
    ref_tiered = rwp.reschedule(ref, "tiered")
    assert port.fingerprint == ref.fingerprint
    assert (ref_tiered.wire_ops, ref_tiered.inter_messages,
            rwp.reschedule(ref, "grouped").inter_messages, ref_tiered.issued_bytes) == want


# ===========================================================================
# simulated scale
# ===========================================================================

SCALE_CASES = [
    (3072, 8, (8, 8, 8), 1),
    (16, 8, (8, 8, 8), 1),
    (8, 8, (8, 8, 8), 1),
    (64, 4, (16, 8, 4), 2),
    (3072, 8, (256, 256, 256), 2),
    (24, 6, (5, 6, 7), 1),
]


@pytest.mark.parametrize("case", range(len(SCALE_CASES)))
def test_build_scale_plan_equals_the_reference(case):
    ranks, rpn, interior, radius = SCALE_CASES[case]
    got = build_scale_plan(ranks, rpn, interior=interior, radius=radius)
    want = rscale.build_scale_plan(ranks, rpn, interior=interior, radius=radius)
    assert (got.nranks, got.grid, got.wire_bytes, got.seg_bytes, got.fused) == (
        want.nranks, want.grid, want.wire_bytes, want.seg_bytes, want.fused)
    assert [(g.directions, g.nbytes) for g in got.groups] == [
        (g.directions, g.nbytes) for g in want.groups]
    assert (got.link_classes, got.tier_bundles) == (want.link_classes, want.tier_bundles)
    assert got.topology.fingerprint == want.topology.fingerprint
    assert (got.correction_bytes, got.class_cum_bytes) == (
        want.correction_bytes, want.class_cum_bytes)
    assert got.grid[0] == ranks // rpn


def test_build_scale_plan_geometry_and_validation():
    plan = build_scale_plan(3072, 8)
    assert plan.nranks == 3072 and plan.topology.nnodes == 384 and plan.grid[0] == 384
    assert "inter" in plan.link_classes and plan.tier_bundles and plan.correction_bytes > 0
    for ranks, rpn in ((10, 8), (0, 8), (8, 0)):
        with pytest.raises(ValueError):
            build_scale_plan(ranks, rpn)
        with pytest.raises(ValueError):
            rscale.build_scale_plan(ranks, rpn)
    with pytest.raises(ValueError, match="does not split"):
        PerfModel().at_scale(10, nodes=3)


def _ladder_models(params, two_tier):
    ref_p, p = _param_pair(params)
    if two_tier:
        ref_p, p = rpm.synthetic_two_tier(ref_p), synthetic_two_tier(p)
    dc, rdc = DecisionCache(), rmeasure.DecisionCache()
    return PerfModel(p, decisions=dc), rpm.PerfModel(ref_p, decisions=rdc)


@pytest.mark.parametrize("geometry", [((8, 8, 8), 1), ((256, 256, 256), 2)])
@pytest.mark.parametrize("params,two_tier", [("h100_measured", True), ("h100", True),
                                             ("ci", False), ("ci", True)])
def test_scale_ladder_equals_the_reference(params, two_tier, geometry):
    interior, radius = geometry
    model, ref_model = _ladder_models(params, two_tier)
    for native in (False, True):
        got = scale_ladder(model, LADDER, 8, interior=interior, radius=radius,
                           native=native, pin=False)
        want = rscale.scale_ladder(ref_model, LADDER, 8, interior=interior, radius=radius,
                                   native=native, pin=False)
        for g, w in zip(got, want):
            assert (g.ranks, g.nodes, g.grid, g.schedule, g.wire_bytes, g.correction_bytes,
                    g.inter_messages, g.fingerprint, g.pinned) == (
                w.ranks, w.nodes, w.grid, w.schedule, w.wire_bytes, w.correction_bytes,
                w.inter_messages, w.fingerprint, w.pinned)
            assert g.costs.keys() == w.costs.keys()
            for s in w.costs:
                assert g.costs[s] == pytest.approx(w.costs[s], rel=1e-12, abs=0)
    if not two_tier:
        # the reference's oracle on flat tables: the predicted cost never
        # falls as the grid grows (two-tier tables may: uniform's padded
        # row shrinks from 16 to 64 ranks under the card's sweep)
        best = [min(e.costs.values()) for e in got]
        assert all(b >= a - 1e-15 for a, b in zip(best, best[1:]))
    if two_tier:
        assert got[0].schedule != "tiered" and "tiered" not in got[0].costs
        assert got[-1].schedule == "tiered"
        assert got[-1].inter_messages["tiered"] < got[-1].inter_messages["grouped"]


def test_scale_pins_replay_as_the_reference_does():
    model, ref_model = _ladder_models("h100_measured", True)
    first = scale_ladder(model, LADDER, 8)
    ref_first = rscale.scale_ladder(ref_model, LADDER, 8, native=False)
    assert not any(e.pinned for e in first)
    again = scale_ladder(model, LADDER, 8)
    assert all(e.pinned for e in again)
    assert [e.schedule for e in again] == [e.schedule for e in first]
    assert [e.fingerprint for e in again] == [e.fingerprint for e in ref_first]
    rows = [d for d in model.decisions.log if d.strategy == "wire/tiered"]
    assert rows and all("topo=" in d.signature for d in rows)
    assert model.decisions.to_json() == ref_model.decisions.to_json()


# ===========================================================================
# elastic re-planning and DecisionCache.prune
# ===========================================================================

def _rows(old, new):
    return [
        ("wire/tiered", "fp1", f"... topo={old.fingerprint}"),
        ("program/s=2", "fp2", "grid=(2,2,2)"),
        ("overlap/mode=region", "fp3", ""),
        ("xla", "fp4", "contig"),
        ("wire/grouped", "fp5", f"... topo={new.fingerprint}"),
    ]


def _caches(rows):
    def mk(cls, cache):
        return cache([cls(fingerprint=fp, incount=1, hops=1, allow_bounding=True,
                          strategy=s, t_pack=0.0, t_link=1e-5, t_unpack=0.0, signature=sig)
                      for s, fp, sig in rows])

    return mk(Decision, DecisionCache), mk(rmeasure.Decision, rmeasure.DecisionCache)


def _comm_pair(dc, rdc, topo):
    ref_p, p = _param_pair("h100_measured")
    port = SimpleNamespace(model=PerfModel(synthetic_two_tier(p), decisions=dc,
                                           topology=topo))
    ref = SimpleNamespace(model=rpm.PerfModel(rpm.synthetic_two_tier(ref_p), decisions=rdc,
                                              topology=None if topo is None
                                              else _ref_topo(topo)))
    return port, ref


@pytest.mark.parametrize("old,new", [((8, 4), (4, 4)), ((8, 4), (8, 2)), (None, (8, 4)),
                                     ((8, 4), None), ((8, 4), (8, 4))])
def test_replan_on_remesh_prunes_what_the_reference_prunes(old, new):
    old_t = Topology.blocked(*old) if old else None
    new_t = Topology.blocked(*new) if new else None
    tags = (old_t or Topology.flat(8), new_t or Topology.flat(8))
    dc, rdc = _caches(_rows(*tags))
    port, ref = _comm_pair(dc, rdc, old_t)
    port.model._cache["x"] = "stale"
    got = replan_on_remesh(port, new_t)
    want = relastic.replan_on_remesh(ref, None if new_t is None else _ref_topo(new_t))
    assert (got.old_topology, got.new_topology, got.pruned, got.cache_cleared) == (
        want.old_topology, want.new_topology, want.pruned, want.cache_cleared)
    assert port.model.topology == new_t and not port.model._cache
    assert dc.to_json() == rdc.to_json()
    if old == new:
        assert got.npruned == 0 and len(dc.log) == 5
    elif new == (4, 4):
        assert set(got.pruned) == {"wire/tiered@fp1", "program/s=2@fp2",
                                   "overlap/mode=region@fp3"}


def test_remesh_and_replan_repins_fresh():
    dc, rdc = DecisionCache(), rmeasure.DecisionCache()
    port, ref = _comm_pair(dc, rdc, Topology.blocked(8, 4))
    est = port.model.at_scale(3072, ranks_per_node=8)
    assert port.model.at_scale(3072, ranks_per_node=8).pinned
    ref.model.at_scale(3072, ranks_per_node=8, native=False)
    mesh, report = ElasticPolicy(model_parallel=4, global_batch=64).remesh_and_replan(
        16, port, ranks_per_node=4)
    rmesh, rreport = relastic.ElasticPolicy(model_parallel=4, global_batch=64) \
        .remesh_and_replan(16, ref, ranks_per_node=4)
    assert mesh.shape == rmesh.shape == (4, 4) and mesh.global_batch == rmesh.global_batch
    assert report.pruned == rreport.pruned and report.npruned >= 1
    assert port.model.topology.nranks == 16
    assert dc.to_json() == rdc.to_json()
    redo = port.model.at_scale(3072, ranks_per_node=8)
    assert not redo.pinned and redo.fingerprint == est.fingerprint


def test_prune_returns_the_dropped_rows_and_rebuilds_the_index():
    rows = [("wire/grouped", "a", ""), ("xla", "b", ""), ("wire/tiered", "c", "")]
    dc, rdc = _caches(rows)
    pred = lambda d: d.strategy.startswith("wire/")
    dropped = dc.prune(pred)
    assert [d.fingerprint for d in dropped] == [d.fingerprint for d in rdc.prune(pred)]
    assert [d.fingerprint for d in dropped] == ["a", "c"]
    assert dc.lookup("a", 1, 1, True) is None and dc.lookup("b", 1, 1, True) is not None
    assert len(dc) == len(dc.log) == 1 and dc.to_json() == rdc.to_json()
    dc.record("d", 1, 1, True, StrategyEstimate("xla", 0.0, 1e-5, 0.0))
    assert [d.fingerprint for d in dc.log] == ["b", "d"]
    assert dc.prune(lambda d: False) == [] and len(dc.log) == 2


# ===========================================================================
# programs key on the topology
# ===========================================================================

def test_program_key_changes_with_the_topology():
    from repro.core.datatypes import FLOAT as RFLOAT

    base = program_fingerprint((2, 2, 2), (8, 8, 8), STENCIL26, FLOAT)
    topo = program_fingerprint((2, 2, 2), (8, 8, 8), STENCIL26, FLOAT, TOPO84.fingerprint)
    assert base != topo
    assert program_fingerprint((2, 2, 2), (8, 8, 8), STENCIL26, FLOAT, "") == base
    ref_op = rhalo.StencilOp(radii=STENCIL26.radii, weight=STENCIL26.weight)
    assert topo == rhalo.program_fingerprint((2, 2, 2), (8, 8, 8), ref_op, RFLOAT,
                                             topology_fingerprint=TOPO84.fingerprint)


@pytest.mark.parametrize("topo", [None, (8, 4), (8, 2)])
def test_program_decisions_equal_the_reference_under_a_topology(topo, monkeypatch, request):
    """The local mesh has no native ragged collective; neither has the
    reference here (``has_ragged_all_to_all`` patched to False; the
    reference's plan cache, whose key does not hold the answer, is cleared
    before and after)."""
    import repro.comm.wireplan as rwp
    import repro.compat

    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    rwp.plan_wire.cache_clear()
    request.addfinalizer(rwp.plan_wire.cache_clear)
    t = Topology.blocked(*topo) if topo else None
    ref_p, p = _param_pair("h100")
    dc, rdc = DecisionCache(), rmeasure.DecisionCache()
    comm = Communicator(params=p, device="cpu", decisions=dc, topology=t)
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_p, decisions=rdc,
                               topology=None if t is None else _ref_topo(t))
    prog = build_halo_program((2, 2, 2), (6, 6, 6), comm, steps="auto")
    want = rhalo.build_halo_program((2, 2, 2), (6, 6, 6), ref_comm, steps="auto")
    assert prog.steps == want.steps and prog.fingerprint == want.fingerprint
    assert prog.topology_fingerprint == (t.fingerprint if t else "")
    assert prog.plan.wire.fingerprint == want.plan.wire.fingerprint
    row = dc.lookup(prog.fingerprint, 0, 1, True)
    assert row.strategy == f"program/s={prog.steps}"
    again = build_halo_program((2, 2, 2), (6, 6, 6), comm, steps="auto")
    assert again.pinned and again.steps == prog.steps


# ===========================================================================
# measurement: the per-axis and per-link-class sweeps
# ===========================================================================

def test_link_class_tables_on_the_local_mesh():
    sizes = (1 << 10, 1 << 12)
    tables = measure_link_class_tables(TOPO84, sizes, iters=1, device="cpu")
    assert set(tables) == {"intra", "inter"}
    for rows in tables.values():
        assert [r[0] for r in rows] == [10.0, 12.0] and all(r[1] > 0 for r in rows)
    assert set(measure_link_class_tables(Topology.flat(4), sizes, 1, "cpu")) == {"intra"}
    # nodes of 3 and 2 ranks: j -> j of the next node is no permutation
    assert set(measure_link_class_tables(Topology(UNEVEN), sizes, 1, "cpu")) == {"intra"}
    odd = Topology((0, 0, 1, 1, 2, 2))
    assert set(measure_link_class_tables(odd, sizes, 1, "cpu")) == {"intra", "inter"}


def test_wire_tables_ring_along_each_axis():
    tables = measure_wire_tables({"a": 4, "b": 2}, (1 << 10,), iters=1, ranks=8,
                                 device="cpu")
    assert set(tables) == {"a", "b"} and all(len(r) == 1 for r in tables.values())
    assert set(measure_wire_tables(None, (1 << 10,), 1, ranks=8, device="cpu")) == {"wire"}
    with pytest.raises(ValueError, match="holds 6 ranks"):
        measure_wire_tables({"a": 3, "b": 2}, (1 << 10,), 1, ranks=8, device="cpu")


def test_calibration_fills_the_tier_tables_and_they_round_trip(tmp_path):
    p = calibrate_params(reduced=True, iters=1, ranks=8, device="cpu",
                         mesh_axes={"x": 4, "y": 2}, topology=TOPO84)
    assert set(p.wire_tables) == set(p.wire_fits) == {"x", "y"}
    assert set(p.link_tables) == set(p.link_fits) == {"intra", "inter"}
    ref = rpm.SystemParams.from_json(p.to_json())
    for f in ("wire_tables", "wire_fits", "link_tables", "link_fits"):
        assert getattr(ref, f) == getattr(p, f)
    store = ParamsStore(tmp_path, device="cpu")
    back = ParamsStore.read_envelope(store.save(p))
    assert back == p
    ref_back = rmeasure.ParamsStore.read_envelope(store.path_for())
    assert ref_back.link_tables == p.link_tables
    model = PerfModel(p, topology=TOPO84)
    assert model.t_link(4096, 1, link_class="inter") > 0


def test_communicator_binds_the_axis_and_the_topology():
    comm = Communicator(device="cpu", topology=TOPO84, axis_name="ici")
    assert comm.model.topology is TOPO84 and comm.model.axis == "ici"
    from repro_torch.launch.stencil3d import parse_args

    assert parse_args(["--ranks-per-node", "4"]).ranks_per_node == 4
    assert parse_args([]).ranks_per_node is None
