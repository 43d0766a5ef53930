"""The port's measurement subsystem against ``repro.measure`` and the
reference's lookup half of ``repro.comm.perfmodel``.

Numpy makes every input from a seed; the same values go through both
packages.  Tolerance 0 (bit for bit) unless stated.

* The interpolators, the measured-table lookups (``measured``,
  ``measured_unpack``, ``measured_copy``), the latency/bandwidth fit and
  ``t_link`` agree, on and off the grid, clamped, past the grid, with
  extra hops, on a one-row grid and on a grid with holes.
* Wire-schedule pricing agrees on three process grids under measured
  tables (``native=False`` on both sides: the reference's native ragged
  path does not run on XLA:CPU).
* A decisions file written by either package is read by the other and
  pins the same picks; a port-written store envelope is read by
  ``repro.measure.ParamsStore``, and foreign formats and systems are
  refused.
* ``calibrate_params(reduced=True, device="cpu")`` gives finite positive
  tables for the reference's measurable strategies, and
  ``production_communicator`` records and then pins.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.comm.perfmodel as rpm
import repro.comm.wireplan as rwp
import repro.core as rcore
import repro.halo as rhalo
import repro.measure as rmeasure
from repro.comm.api import Communicator as RefCommunicator
from repro.comm.api import default_registry as ref_default_registry
from repro.measure.decisions import DecisionCache as RefDecisionCache
import repro_torch.comm.perfmodel as pm
from repro_torch.comm import Communicator, H100_ANALYTIC, PerfModel, SystemParams
from repro_torch.comm import default_registry, plan_wire
from repro_torch.core import BYTE, TypeRegistry, Vector
from repro_torch.halo import HaloSpec, make_halo_plan, make_halo_types
from repro_torch.measure import (
    COMPATIBLE_FORMATS,
    DECISIONS_FILENAME,
    DecisionCache,
    ParamsStore,
    STORE_FORMAT,
    calibrate_params,
    fit_latency_bandwidth,
    production_communicator,
    system_description,
    system_fingerprint,
    time_fn,
)
from repro_torch.measure.bench import REDUCED_BLOCK_BYTES, REDUCED_TOTAL_BYTES

from test_torch_comm import MEASURED_TABLES, _param_pair, synthetic_fields

SEED = 16


def _grid_table(rng, xs, ys, holes=0.0):
    rows = [(float(x), float(y), float(rng.uniform(1e-6, 1e-3))) for x in xs for y in ys]
    keep = rng.random(len(rows)) >= holes
    keep[0] = True
    return tuple(r for r, k in zip(rows, keep) if k)


def _queries(rng, n=64):
    # on-grid, between grid points and outside the grid on every side
    pts = [(3.0, 10.0), (9.0, 22.0), (5.0, 14.0), (1.0, 30.0), (12.0, 2.0)]
    pts += [(float(x), float(y)) for x, y in zip(rng.uniform(0, 12, n), rng.uniform(6, 26, n))]
    return pts


@pytest.mark.parametrize("case", ["full", "holes", "one_row", "one_column", "one_point"])
def test_interpolators_agree_bit_for_bit(case):
    rng = np.random.default_rng(SEED)
    xs, ys = (3, 5, 7, 9), (10, 14, 18, 22)
    if case == "one_row":
        xs = (5,)
    elif case == "one_column":
        ys = (14,)
    elif case == "one_point":
        xs, ys = (5,), (14,)
    table = _grid_table(rng, xs, ys, holes=0.3 if case == "holes" else 0.0)
    mine, ref = pm._Interp2D(table), rpm._Interp2D(table)
    for x, y in _queries(rng):
        got, want = mine(x, y), ref(x, y)
        assert got == want and type(got) is float
        assert pm._interp2d(table, x, y) == rpm._interp2d(table, x, y)
    if case == "holes":
        assert np.isnan(mine.grid).any()
    line = tuple((float(y), float(rng.uniform(1e-6, 1e-3))) for y in rng.permutation(ys))
    one, ref_one = pm._Interp1D(line), rpm._Interp1D(line)
    for x in np.linspace(0, 30, 61):
        assert one(float(x)) == ref_one(float(x))
    assert pm._interp2d((), 1.0, 1.0) is None and rpm._interp2d((), 1.0, 1.0) is None


def _fits():
    rng = np.random.default_rng(SEED)
    return {
        "noisy": [(float(t), 2e-5 * rng.uniform(0.8, 1.2) + 2.0 ** t / 5e11)
                  for t in (10, 14, 18, 22)],
        "one_row": [(10.0, 1e-5)],
        "empty": [],
        "negative_intercept": [(10.0, 1e-9), (22.0, 1e-2)],
        "negative_slope": [(10.0, 2e-5), (22.0, 1e-5)],
    }


@pytest.mark.parametrize("case", sorted(_fits()))
def test_fit_latency_bandwidth_agrees(case):
    rows = _fits()[case]
    got, want = fit_latency_bandwidth(rows), rmeasure.fit_latency_bandwidth(rows)
    assert got == want
    if case in ("one_row", "empty"):
        assert got == (None, None)
    if case == "negative_intercept":
        assert got[0] is None and got[1] is not None
    if case == "negative_slope":
        assert got[1] is None


@pytest.mark.parametrize("params", MEASURED_TABLES)
def test_measured_lookups_and_t_link_agree(params):
    """``measured``, ``measured_unpack``, ``measured_copy`` and ``t_link``
    (in the grid, past it at the fitted rate, with extra hops at the
    fitted latency) equal the reference's bit for bit."""
    ref_params, port_params = _param_pair(params)
    mine, ref = PerfModel(port_params), rpm.PerfModel(ref_params)
    rng = np.random.default_rng(SEED)
    sizes = [1, 1000, 1 << 14, 3_195_136, 8_388_608, 1 << 26]
    sizes += [int(n) for n in rng.integers(1, 1 << 27, 32)]
    contigs = [1, 8, 24, 100, 512, 1040, 4096]
    assert port_params.pack_table and port_params.wire_table
    for strategy in ("rows", "dma", "xla", "bounding"):
        for c in contigs:
            for n in sizes:
                assert mine.measured(strategy, c, n) == ref.measured(strategy, c, n)
                assert mine.measured_unpack(strategy, c, n) == ref.measured_unpack(strategy, c, n)
    for n in sizes:
        assert mine.measured_copy(n) == ref.measured_copy(n)
        for hops in (1, 2, 5):
            assert mine.t_link(n, hops) == ref.t_link(n, hops)
    end = max(x for x, _ in port_params.wire_table)
    past = int(2 ** end) * 4
    lat = port_params.wire_latency
    assert mine.t_link(past, 3) > mine.t_link(int(2 ** end), 3)
    assert mine.t_link(past, 3) - mine.t_link(past, 1) == pytest.approx(2 * lat, rel=1e-9)


def test_t_link_falls_back_to_the_analytic_link_without_a_fit():
    """A wire table whose fit came back None prices extra hops at the
    analytic latency and past the grid at the analytic rate, as the
    reference does."""
    fields = dict(synthetic_fields(), wire_latency=None, wire_bw=None)
    mine = PerfModel(SystemParams.from_reference(name="x", **fields))
    ref = rpm.PerfModel(rpm.SystemParams(name="x", **fields))
    for n in (10, 1 << 20, 1 << 25):
        for hops in (1, 3):
            assert mine.t_link(n, hops) == ref.t_link(n, hops)


def test_calibration_cap_stops_the_tables():
    """Past ``calibration_cap`` blocks the xla strategy is priced by the
    analytic formula even though its table would answer, in both
    packages."""
    ref_params, params = _param_pair("synthetic")
    reg, rreg = TypeRegistry(), rcore.TypeRegistry()
    model, ref = PerfModel(params), rpm.PerfModel(ref_params)
    for nblocks in (64, 512, 513, 4096):
        ct = reg.commit(Vector(nblocks, 8, 512, BYTE))
        rct = rreg.commit(rcore.Vector(nblocks, 8, 512, rcore.BYTE))
        for name in ("rows", "dma", "xla"):
            e, r = model.estimate(ct, 1, name), ref.estimate(rct, 1, name)
            assert (e.t_pack, e.t_unpack) == (r.t_pack, r.t_unpack)
        xla = model.estimate(ct, 1, "xla")
        analytic = nblocks * params.xla_copy_overhead + 2 * ct.size / params.hbm_bw
        assert (xla.t_pack == analytic) == (nblocks > 512)
        assert (xla.t_pack == model.measured("xla", 8, ct.size)) == (nblocks <= 512)


@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 2, 4), (4, 4, 4)])
@pytest.mark.parametrize("params", MEASURED_TABLES)
def test_wire_schedule_pricing_agrees_under_measured_tables(grid, params):
    ref_params, port_params = _param_pair(params)
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params)
    comm = Communicator(params=port_params, device="cpu")
    spec = HaloSpec(grid=grid, interior=(6, 5, 4), radius=2)
    sends = [make_halo_types(spec, comm)[d][0] for d in rhalo.DIRECTIONS]
    perms = tuple(tuple(spec.perm(d)) for d in rhalo.DIRECTIONS)
    sizes = tuple(ct.packed_extent() for ct in sends)
    fps = tuple(ct.fingerprint for ct in sends)
    plan = plan_wire(sizes, perms, fingerprints=fps, native=False)
    ref = rwp.plan_wire(sizes, perms, fingerprints=fps, native=False)
    costs = comm.model.price_wire_schedules(plan, native=False)
    want = ref_comm.model.price_wire_schedules(ref, native=False)
    assert costs == want
    got, _ = comm.model.choose_wire_schedule(plan, native=False)
    exp, _ = ref_comm.model.choose_wire_schedule(ref, native=False)
    assert (got.schedule, got.issued_bytes) == (exp.schedule, exp.issued_bytes)
    assert comm.model.price_exchange(got).total == ref_comm.model.price_exchange(exp).total


# ---------------------------------------------------------------------------
# decisions across packages
# ---------------------------------------------------------------------------

def _halo_pairs(port_params, ref_params, port_decisions=None, ref_decisions=None):
    comm = Communicator(params=port_params, device="cpu", decisions=port_decisions)
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params, decisions=ref_decisions)
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    ref_spec = rhalo.HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    types, ref_types = make_halo_types(spec, comm), rhalo.make_halo_types(ref_spec, ref_comm)
    pairs = [(types[d][k], ref_types[d][k]) for d in rhalo.DIRECTIONS for k in range(2)]
    return comm, ref_comm, pairs


def _picks(model, cts):
    return [model.select(ct, 1, allow_bounding=ab).strategy for ct in cts for ab in (True, False)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_decisions_file_is_read_and_pinned_across_packages(writer, tmp_path):
    """One package records the 52 halo types' picks under measured
    tables and saves; the other loads the file under the analytic
    tables and replays exactly those picks from the pins."""
    ref_params, port_params = _param_pair("synthetic")
    path = tmp_path / "decisions.json"
    if writer == "port":
        rec = DecisionCache()
        comm, _, pairs = _halo_pairs(port_params, ref_params, port_decisions=rec)
        want = _picks(comm.model, [ct for ct, _ in pairs])
        rec.save(path)
        reader = RefDecisionCache.load(path)
        _, ref_comm, pairs = _halo_pairs(H100_ANALYTIC, rpm.TPU_V5E, ref_decisions=reader)
        got = _picks(ref_comm.model, [rct for _, rct in pairs])
        free = _picks(rpm.PerfModel(rpm.TPU_V5E), [rct for _, rct in pairs])
    else:
        rec = RefDecisionCache()
        _, ref_comm, pairs = _halo_pairs(port_params, ref_params, ref_decisions=rec)
        want = _picks(ref_comm.model, [rct for _, rct in pairs])
        rec.save(path)
        reader = DecisionCache.load(path)
        comm, _, pairs = _halo_pairs(H100_ANALYTIC, rpm.TPU_V5E, port_decisions=reader)
        got = _picks(comm.model, [ct for ct, _ in pairs])
        free = _picks(PerfModel(H100_ANALYTIC), [ct for ct, _ in pairs])
    assert got == want
    assert reader.pinned_hits == len(want)
    assert free != want, "the analytic picks equal the measured ones: the pins show nothing"
    assert len(reader) == len(rec)


def test_decisions_file_is_the_references_byte_for_byte(tmp_path):
    ref_params, port_params = _param_pair("ci")
    rec, ref_rec = DecisionCache(), RefDecisionCache()
    comm, ref_comm, pairs = _halo_pairs(port_params, ref_params, rec, ref_rec)
    for ct, rct in pairs:
        comm.model.select(ct, 2, hops=2)
        ref_comm.model.select(rct, 2, hops=2)
    assert rec.to_json() == ref_rec.to_json()
    assert rec.report() == ref_rec.report()
    with pytest.raises(ValueError, match="format"):
        DecisionCache.from_json(json.dumps({"format": 2, "decisions": []}))


def test_plan_neighbor_records_the_priced_exchange_once():
    ref_params, port_params = _param_pair("synthetic")
    rec = DecisionCache()
    comm = Communicator(params=port_params, device="cpu", decisions=rec)
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    plan = make_halo_plan(spec, comm)
    make_halo_plan(spec, comm)
    rows = [d for d in rec.log if d.strategy.startswith("wire/")]
    assert len(rows) == 1
    row = rows[0]
    assert row.strategy == f"wire/{plan.wire.schedule}"
    assert row.wire_bytes == plan.wire.issued_bytes
    assert "priced[grouped=" in row.signature and "uniform=" in row.signature
    assert row.t_link == comm.model.price_exchange(plan.wire).t_link


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_port_envelope_is_read_by_the_reference(tmp_path):
    _, params = _param_pair("synthetic")
    store = ParamsStore(tmp_path, device="cpu")
    path = store.save(params)
    env = json.loads(path.read_text())
    assert env["format"] == STORE_FORMAT
    assert env["system"] == system_fingerprint(8, "cpu") == store.system()
    assert env["system_description"] == ["cpu", "cpu", "8", torch.__version__]
    assert "ici_bw" in env["params"] and "link_bw" not in env["params"]
    ref = rmeasure.ParamsStore.read_envelope(path)
    assert (ref.ici_bw, ref.ici_latency) == (params.link_bw, params.link_latency)
    for f in ("name", "hbm_bw", "kernel_launch", "dma_setup", "xla_copy_overhead",
              "pack_table", "unpack_table", "wire_table", "copy_table", "wire_latency",
              "wire_bw", "stencil_table"):
        assert getattr(ref, f) == getattr(params, f)
    assert store.load() == params
    assert ParamsStore.read_envelope(path) == params


def test_store_refuses_foreign_formats_and_systems(tmp_path):
    _, params = _param_pair("synthetic")
    store = ParamsStore(tmp_path, device="cpu")
    path = store.save(params)
    env = json.loads(path.read_text())
    path.write_text(json.dumps(dict(env, format=STORE_FORMAT + 1)))
    assert store.load() is None and ParamsStore.read_envelope(path) is None
    path.write_text(json.dumps(dict(env, system="0" * 16)))
    assert store.load() is None
    assert ParamsStore.read_envelope(path) == params  # readable, not served
    other = ParamsStore(tmp_path, ranks=4, device="cpu")
    assert other.system() != store.system() and other.load() is None
    # the link-class tables are read (they round-trip); a field the port
    # does not know is refused
    link = dict(env["params"], link_tables={"inter": [[10.0, 1e-5]]}, link_fits={"inter": [1, 2]})
    path.write_text(json.dumps(dict(env, params=link)))
    loaded = store.load()
    assert loaded.link_tables == {"inter": ((10.0, 1e-5),)}
    assert loaded.link_fits == {"inter": (1, 2)}
    assert rmeasure.ParamsStore.read_envelope(path).link_fits == loaded.link_fits
    path.write_text(json.dumps(dict(env, params=dict(env["params"], unknown_table=[[1, 2]]))))
    with pytest.raises(ValueError, match="unknown reference field"):
        store.load()
    assert set(COMPATIBLE_FORMATS) == set(rmeasure.COMPATIBLE_FORMATS)
    assert STORE_FORMAT == rmeasure.STORE_FORMAT


def test_reference_envelope_is_read_by_the_port():
    ref = rmeasure.load_ci_params()
    mine = ParamsStore.read_envelope(rmeasure.ci_params_path())
    assert (mine.link_bw, mine.link_latency) == (ref.ici_bw, ref.ici_latency)
    assert mine.pack_table == ref.pack_table and mine.stencil_table == ref.stencil_table
    assert json.loads(mine.to_json())["stencil_table"] == json.loads(ref.to_json())["stencil_table"]


def test_port_ci_params_are_checked_in_and_round_trip(tmp_path):
    """The port's own reduced-grid CPU calibration (``python -m
    repro_torch.measure --reduced --device cpu``), not the reference's."""
    from repro_torch.measure import ci_params_path, load_ci_params

    path = ci_params_path()
    assert path.name == "ci_params.json" and path.parent.name == "measure"
    assert path != rmeasure.ci_params_path()
    params = load_ci_params()
    env = json.loads(path.read_text())
    assert env["format"] == STORE_FORMAT and env["system_description"][0] == "cpu"
    assert params.name == "cpu_calibrated" and params.pack_table and params.unpack_table
    store = ParamsStore(tmp_path, device="cpu")
    again = store.save(params, path=tmp_path / "copy.json")
    assert ParamsStore.read_envelope(again) == params
    ref = rmeasure.ParamsStore.read_envelope(path)  # the reference reads it too
    assert ref.pack_table == params.pack_table and ref.ici_latency == params.link_latency


def test_system_description_names_the_host_and_the_ranks():
    assert system_description(8, "cpu") == ("cpu", "cpu", "8", torch.__version__)
    assert system_fingerprint(8, "cpu") != system_fingerprint(4, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            system_description()


# ---------------------------------------------------------------------------
# calibration and production wiring on the CPU
# ---------------------------------------------------------------------------

def test_calibrate_reduced_on_the_cpu():
    params = calibrate_params(reduced=True, device="cpu")
    want = {s.name for s in ref_default_registry().measurable()}
    assert {s.name for s in default_registry().measurable()} == want
    assert set(params.pack_table) == set(params.unpack_table) == want
    npts = len(REDUCED_BLOCK_BYTES) * len(REDUCED_TOTAL_BYTES)
    for tables in (params.pack_table, params.unpack_table):
        for name, rows in tables.items():
            assert len(rows) == (npts if name != "xla" else 3)  # 2048 blocks > the cap
            for blk, total, sec in rows:
                assert 2 ** blk in REDUCED_BLOCK_BYTES and 2 ** total in REDUCED_TOTAL_BYTES
                assert math.isfinite(sec) and sec > 0
    for rows in (params.wire_table, params.copy_table):
        assert [2 ** x for x, _ in rows] == list(REDUCED_TOTAL_BYTES)
        assert all(math.isfinite(t) and t > 0 for _, t in rows)
    assert params.hbm_bw > 0 and params.name == "cpu_calibrated"
    assert params.link_bw == (params.wire_bw or H100_ANALYTIC.link_bw)
    model = PerfModel(params)
    assert model.measured("rows", 8, 1 << 12) > 0 and model.measured_copy(1 << 12) > 0


def test_time_fn_times_back_to_back_calls():
    calls = []
    assert time_fn(lambda x: calls.append(x), 1, iters=7) >= 0
    assert calls == [1] * 8  # one warm-up call, then seven timed


def test_production_communicator_records_then_pins(tmp_path):
    comm, save = production_communicator(tmp_path, device="cpu")
    assert comm.model.params.pack_table  # a reduced calibration ran and was stored
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    plan = make_halo_plan(spec, comm)
    path = save()
    assert path == tmp_path / DECISIONS_FILENAME and path.exists()
    again, _ = production_communicator(tmp_path, device="cpu")
    assert again.model.params == comm.model.params  # loaded, not re-measured
    plan2 = make_halo_plan(spec, again)
    assert [s.name for s in plan2.strategies] == [s.name for s in plan.strategies]
    assert plan2.wire.schedule == plan.wire.schedule
    assert again.model.decisions.pinned_hits >= 26
    analytic, _ = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          params=H100_ANALYTIC)
    assert [s.name for s in make_halo_plan(spec, analytic).strategies] == [
        s.name for s in plan.strategies]


@pytest.mark.parametrize("option", ["telemetry", "tracer", "topology"])
def test_production_options_of_later_items_raise(option, tmp_path):
    """The options that once raised for a later roadmap item are all
    ported now: ``topology`` binds the communicator's model,
    ``telemetry=True`` attaches the store's telemetry (saved as
    ``telemetry.json``), ``tracer=True`` a fresh tracer; none raises,
    and ``save()`` writes ``metrics.json`` beside the decisions."""
    if option == "topology":
        from repro_torch.comm import Topology

        topo = Topology.blocked(8, 4)
        comm, _ = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          topology=topo)
        assert comm.model.topology is topo
        return
    from repro_torch.fleet import ExchangeTelemetry
    from repro_torch.obs import Tracer

    comm, save = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          **{option: True})
    want = {"telemetry": ExchangeTelemetry, "tracer": Tracer}[option]
    assert isinstance(getattr(comm, option), want)
    save()
    assert (tmp_path / "metrics.json").exists()
    assert (tmp_path / "telemetry.json").exists() == (option == "telemetry")


def test_cli_calibrates_on_the_cpu(tmp_path, capsys):
    from repro_torch.measure.__main__ import main

    out = tmp_path / "env.json"
    main(["--device", "cpu", "--reduced", "--ranks", "2", str(out)])
    params = rmeasure.ParamsStore.read_envelope(out)
    assert set(params.pack_table) == {"rows", "dma", "xla"}
    assert json.loads(out.read_text())["system_description"][:3] == ["cpu", "cpu", "2"]
    assert f"wrote {out}" in capsys.readouterr().out


def test_h100_envelope_names_the_card():
    from repro_torch.measure import h100_params_path, load_h100_params

    env = json.loads(h100_params_path().read_text())
    platform, name, ranks, _ = env["system_description"]
    assert (platform, ranks) == ("cuda", "8") and "H100" in name
    import hashlib

    desc = "/".join(env["system_description"]).encode()
    assert env["system"] == hashlib.sha256(desc).hexdigest()[:16]
    params = load_h100_params()
    assert set(params.pack_table) == set(params.unpack_table) == {"rows", "dma", "xla"}
    assert len(params.pack_table["rows"]) == 16 and len(params.wire_table) == 4
    assert params.wire_latency and params.wire_bw


@pytest.mark.parametrize("allow_bounding", [True, False])
def test_full_width_halo_picks_match_the_reference_under_the_h100_tables(allow_bounding):
    """The main path's own decisions, made on the host: the 52 region
    types of the 8-rank 256^3 radius-2 halo and its wire schedule, from
    the card's tables in both packages."""
    ref_params, params = _param_pair("h100_measured")
    comm = Communicator(params=params, device="cpu")
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params)
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    ref_spec = rhalo.HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    types, ref_types = make_halo_types(spec, comm), rhalo.make_halo_types(ref_spec, ref_comm)
    for d in rhalo.DIRECTIONS:
        for ct, rct in zip(types[d], ref_types[d]):
            got = comm.model.select(ct, 1, allow_bounding=allow_bounding)
            want = ref_comm.model.select(rct, 1, allow_bounding=allow_bounding)
            assert (got.strategy, got.wire_bytes) == (want.strategy, want.wire_bytes)
            assert got.total == pytest.approx(want.total, rel=1e-12, abs=0)
    plan = make_halo_plan(spec, comm)
    segs = [s.wire_segment(ct) for s, ct in zip(plan.strategies, plan.send_cts)]
    ref_wire = rwp.plan_wire(tuple(s.nbytes for s in segs), plan.perms,
                             fingerprints=tuple(s.fingerprint for s in segs), native=False)
    ref_wire, _ = ref_comm.model.choose_wire_schedule(ref_wire, native=False)
    assert (plan.wire.schedule, plan.wire.issued_bytes) == (ref_wire.schedule,
                                                             ref_wire.issued_bytes)
