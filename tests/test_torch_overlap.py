"""The port's overlap layer against the JAX reference, on the CPU.

* ``halo_regions`` equals the reference's regions (sig, origin, shape,
  bands, transfers) over a sweep of interiors, radii and 1- and 2-op
  cycles, and the regions partition the first application's window: no
  gap, no overlap.  ``max_pipeline_depth`` equals the reference's.
* ``price_class_completions``, ``price_overlap`` and
  ``choose_overlap_mode`` agree with the reference at rel 1e-12 on the
  checked-in H100 tables, the reference's CI tables and a seeded
  synthetic table with a stencil table; the picks and the decisions
  files are equal.  The reference is planned without its native ragged
  collective, which the local mesh does not have.
* ``stencil_interior_chain`` and ``overlapped_stencil_iteration`` in all
  three modes are bit-exact to the port's own ``halo_exchange`` +
  ``stencil_cycle``, and compute as many stencil cells as it: none
  twice.  Against the reference (8 ranks, one subprocess, planned
  ``exact`` and rescheduled to ``grouped``) they agree within its 2e-6.
* On the CPU ``wait_any`` drains in plan order and records ``drained``;
  an empty exchange completes at once.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.comm.perfmodel as rpm
import repro.halo as rhalo
from repro.comm import reschedule as ref_reschedule
from repro.comm.api import Communicator as RefCommunicator
from repro.measure import DecisionCache as RefDecisionCache
from repro_torch.comm import Communicator, NeighborRequest, reschedule
from repro_torch.halo import (
    OVERLAP_MODES,
    STENCIL26,
    HaloSpec,
    StencilOp,
    from_reference,
    halo_exchange,
    halo_regions,
    ihalo_exchange,
    make_halo_plan,
    max_pipeline_depth,
    overlap_region_descriptors,
    overlapped_stencil_iteration,
    stencil_cycle,
    stencil26_interior,
    stencil_interior_chain,
)
from repro_torch.measure import DecisionCache
from tests._subproc import run_with_devices
from test_torch_comm import _param_pair, synthetic_fields

PAIR = [StencilOp((2, 1, 1)), StencilOp((1, 1, 1), 0.3)]
#: (interior, halo radius, cycle): deep, shallow (interior < 2r) and
#: per-dimension geometries
GEOMETRIES = [
    ((6, 5, 4), 2, (STENCIL26,)),
    ((6, 5, 4), 1, (STENCIL26,)),
    ((3, 6, 7), (2, 2, 2), (STENCIL26,)),
    ((1, 2, 9), (1, 1, 1), (STENCIL26,)),
    ((9, 8, 7), (3, 2, 2), (StencilOp((2, 1, 1)),)),
    ((8, 8, 8), (4, 2, 2), tuple(PAIR)),
    ((5, 4, 6), (3, 2, 2), tuple(PAIR)),
    ((2, 3, 2), (3, 2, 2), tuple(PAIR)),
]


def _ref_ops(ops):
    return tuple(rhalo.StencilOp(o.radii, o.weight) for o in ops)


def _specs(interior, radius, grid=(2, 2, 2)):
    return (HaloSpec(grid=grid, interior=interior, radius=radius),
            rhalo.HaloSpec(grid=grid, interior=interior, radius=radius))


@pytest.mark.parametrize("k", range(len(GEOMETRIES)))
def test_halo_regions_match_the_reference_and_partition_the_window(k):
    interior, radius, ops = GEOMETRIES[k]
    spec, ref_spec = _specs(interior, radius)
    got = [dataclasses.astuple(r) for r in halo_regions(spec, ops)]
    want = [dataclasses.astuple(r) for r in rhalo.halo_regions(ref_spec, _ref_ops(ops))]
    assert got == want
    # the regions cover the first application's window once each
    shell = tuple(hr - r for hr, r in zip(spec.radii, ops[0].radii))
    lo = tuple(hr - s for hr, s in zip(spec.radii, shell))
    cover = np.zeros(spec.alloc, np.int32)
    for reg in halo_regions(spec, ops):
        (z, y, x), (nz, ny, nx) = reg.origin, reg.shape
        cover[z:z + nz, y:y + ny, x:x + nx] += 1
    window = cover[lo[0]:lo[0] + interior[0] + 2 * shell[0],
                   lo[1]:lo[1] + interior[1] + 2 * shell[1],
                   lo[2]:lo[2] + interior[2] + 2 * shell[2]]
    assert (window == 1).all()
    assert cover.sum() == window.size


@pytest.mark.parametrize("k", range(len(GEOMETRIES)))
def test_max_pipeline_depth_matches_the_reference(k):
    interior, radius, ops = GEOMETRIES[k]
    spec, ref_spec = _specs(interior, radius)
    for steps in (1, 2, 3):
        assert max_pipeline_depth(spec, ops, steps) == rhalo.max_pipeline_depth(
            ref_spec, _ref_ops(ops), steps)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def stencil_fields(seed=17):
    """The seeded synthetic tables plus a stencil table over the
    reference's sweep grid (26, 44, 124 neighbours x 1 KiB-4 MiB)."""
    rng = np.random.default_rng(seed)
    rows = [(float(np.log2(n)), float(t), n * 2.0 ** t / rng.uniform(5e11, 2e12))
            for n in (26, 44, 124) for t in (10, 14, 18, 22)]
    return dict(synthetic_fields(), stencil_table=rows)


def param_pair(name):
    if name == "synthetic_stencil":
        values = stencil_fields()
        from repro_torch.comm import SystemParams

        return (rpm.SystemParams(name=name, **values),
                SystemParams.from_reference(name=name, **values))
    return _param_pair(name)


TABLES = ["h100_measured", "ci", "synthetic_stencil"]


@pytest.fixture
def no_native_ragged(monkeypatch):
    """Plan the reference as the local mesh plans: no native ragged
    collective (the reference's plan cache is cleared around the test,
    since its key does not hold the answer)."""
    import repro.comm.wireplan as rwp
    import repro.compat

    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    rwp.plan_wire.cache_clear()
    yield
    rwp.plan_wire.cache_clear()


def _close(a, b):
    return a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("schedule", ["model", "grouped"])
@pytest.mark.parametrize("table", TABLES)
def test_overlap_pricing_and_pick_match_the_reference(table, schedule, no_native_ragged):
    ref_params, params = param_pair(table)
    rec, ref_rec = DecisionCache(), RefDecisionCache()
    comm = Communicator(params=params, device="cpu", decisions=rec)
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params, decisions=ref_rec)
    spec, ref_spec = _specs((16, 12, 10), 2)
    plan = make_halo_plan(spec, comm).wire
    ref_plan = rhalo.make_halo_plan(ref_spec, ref_comm).wire
    if schedule == "grouped":
        plan = reschedule(plan, "grouped")
        ref_plan = ref_reschedule(ref_plan, "grouped")
    assert plan.fingerprint == ref_plan.fingerprint
    core, rims = overlap_region_descriptors(spec, STENCIL26, plan)
    assert (core, rims) == rhalo.overlap_region_descriptors(
        ref_spec, rhalo.STENCIL26, ref_plan)
    got = comm.model.price_class_completions(plan)
    want = ref_comm.model.price_class_completions(ref_plan)
    assert len(got) == plan.ngroups and all(map(_close, got, want))
    ests = comm.model.price_overlap(plan, rims, core, 26)
    ref_ests = ref_comm.model.price_overlap(ref_plan, rims, core, 26)
    for mode in ("monolithic", "region"):
        a, b = ests[mode], ref_ests[mode]
        assert _close(a.t_total, b.t_total) and _close(a.t_core, b.t_core)
        assert all(map(_close, a.t_rims, b.t_rims))
    mode, _, pinned = comm.model.choose_overlap_mode(plan, rims, core, 26)
    ref_mode, _, ref_pinned = ref_comm.model.choose_overlap_mode(ref_plan, rims, core, 26)
    assert (mode, pinned) == (ref_mode, ref_pinned) == (mode, False)
    assert rec.to_json() == ref_rec.to_json()
    # the reloaded file pins the pick in both packages
    again = Communicator(params=params, device="cpu",
                         decisions=DecisionCache.from_json(rec.to_json()))
    assert again.model.choose_overlap_mode(plan, rims, core, 26)[::2] == (mode, True)
    ref_again = RefCommunicator(axis_name="ranks", params=ref_params,
                                decisions=RefDecisionCache.from_json(rec.to_json()))
    assert ref_again.model.choose_overlap_mode(ref_plan, rims, core, 26)[::2] == (mode, True)


# ---------------------------------------------------------------------------
# values: bit-exact to the plain path, cells computed once
# ---------------------------------------------------------------------------

#: (interior, halo radius, cycle, repeats) of the overlapped iterations
CASES = {
    "26pt_s2": ((6, 5, 4), 2, (STENCIL26,), 2),
    "26pt_s3": ((9, 8, 7), 3, (STENCIL26,), 3),
    "shallow": ((3, 6, 7), 2, (STENCIL26,), 2),
    "cycle": ((8, 8, 8), (3, 2, 2), tuple(PAIR), 1),
}


def _start(spec, seed=11):
    rng = np.random.default_rng(seed)
    return from_reference(rng.normal(size=(8,) + spec.alloc).astype(np.float32), spec,
                          device="cpu")


def _plain(spec, comm, plan, x, ops, steps):
    return stencil_cycle(halo_exchange(x, spec, comm, plan=plan), spec, ops, steps)


class _CountCells:
    """Counts the computed cells (a copied rim is not computed) of every
    stencil window update the halo layer asks for, from the windows it
    passes: single updates, both updates of a fused pair and each stage
    of a chain."""

    def __init__(self, monkeypatch):
        import repro_torch.halo.stencil as st

        update, pair, chain = (st.stencil_window_update, st.stencil_window_pair,
                               st.stencil_window_chain)
        self.cells = 0

        def cells(arr, shape):
            return arr[..., 0, 0, 0].numel() * shape[0] * shape[1] * shape[2]

        def counted_update(arr, offsets, weight, origin, shape, **kw):
            self.cells += cells(arr, shape)
            return update(arr, offsets, weight, origin, shape, **kw)

        def counted_pair(arr, offsets, weights, origin, shape, **kw):
            self.cells += cells(arr, shape) + cells(arr, [n - 2 for n in shape])
            return pair(arr, offsets, weights, origin, shape, **kw)

        def counted_chain(arr, stages):
            shape = arr.shape[-3:]
            for _, _, radii in stages:
                shape = [n - 2 * r for n, r in zip(shape, radii)]
                self.cells += cells(arr, shape)
            return chain(arr, stages)

        monkeypatch.setattr(st, "stencil_window_update", counted_update)
        monkeypatch.setattr(st, "stencil_window_pair", counted_pair)
        monkeypatch.setattr(st, "stencil_window_chain", counted_chain)


@pytest.mark.parametrize("mode", OVERLAP_MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_overlapped_iteration_is_bit_exact_and_computes_each_cell_once(case, mode,
                                                                       monkeypatch):
    interior, radius, ops, steps = CASES[case]
    spec = HaloSpec(grid=(2, 2, 2), interior=interior, radius=radius)
    comm = Communicator(device="cpu")
    plan = make_halo_plan(spec, comm)
    counter = _CountCells(monkeypatch)
    want = _plain(spec, comm, plan, _start(spec), ops, steps)
    plain_cells, counter.cells = counter.cells, 0
    probe = {}
    got = _start(spec)
    out = overlapped_stencil_iteration(got, spec, comm, steps=steps, probe=probe, plan=plan,
                                       op=ops, mode=mode)
    assert out is got and torch.equal(got, want)
    assert counter.cells == plain_cells
    assert probe["pending_during_interior"] is True
    assert probe["pipeline_depth"] == max_pipeline_depth(spec, ops, steps)
    assert probe["overlap_mode"] in ("monolithic", "region")
    if probe["overlap_mode"] == "region":
        assert probe["rim_regions"] == 26
        assert probe["class_drain_order"] == tuple(range(plan.wire.ngroups))


@pytest.mark.parametrize("case", sorted(CASES))
def test_interior_chain_is_bit_exact_and_matches_the_reference(case):
    interior, radius, ops, steps = CASES[case]
    spec, ref_spec = _specs(interior, radius)
    comm = Communicator(device="cpu")
    depth = max_pipeline_depth(spec, ops, steps)
    start = _start(spec)
    chain = stencil_interior_chain(start, spec, depth, ops)
    ref_chain = rhalo.stencil_interior_chain(
        jnp.asarray(start[0].numpy()), ref_spec, depth, _ref_ops(ops))
    assert len(chain) == len(ref_chain) == depth >= 1
    if ops == (STENCIL26,):
        assert torch.equal(stencil26_interior(start, spec), chain[0])
    x, valid = _start(spec), spec.radii
    halo_exchange(x, spec, comm)
    cum = (0, 0, 0)
    for k, o in enumerate(itertools.islice(itertools.cycle(ops), depth)):
        stencil_cycle(x, spec, (o,), 1, valid)
        valid = tuple(v - r for v, r in zip(valid, o.radii))
        cum = tuple(c + r for c, r in zip(cum, o.radii))
        lo = tuple(hr + c for hr, c in zip(spec.radii, cum))
        block = chain[k]
        (z, y, w), (nz, ny, nx) = lo, block.shape[-3:]
        assert torch.equal(block, x[..., z:z + nz, y:y + ny, w:w + nx])
        np.testing.assert_allclose(block[0].numpy(), np.asarray(ref_chain[k]),
                                   rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# per-class requests on the CPU
# ---------------------------------------------------------------------------

def test_wait_any_drains_in_plan_order_on_the_cpu():
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    comm = Communicator(device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    local = _start(spec)
    req = ihalo_exchange(local, spec, comm, plan=plan)
    assert isinstance(req, NeighborRequest) and not req.completed
    assert len(req.pending) == plan.wire.ngroups == 7
    assert all(c.ready() and c.event is None for c in req.classes)
    order = []
    while req.pending:
        cls = req.wait_any()
        assert cls.applied and cls.nbytes == plan.wire.groups[cls.index].nbytes
        order.append(cls.index)
    assert order == req.drained == list(range(7))
    assert req.completed and req.wait() is local and req.buffer is local
    with pytest.raises(ValueError, match="drained"):
        req.wait_any()
    want = halo_exchange(_start(spec), spec, comm, plan=plan)
    assert torch.equal(local, want)
    fp = plan.wire.fingerprint
    assert comm.wire_class_drains == {f"{fp}/c{g}": g + 1 for g in range(7)}
    assert comm.wire_class_ops == {f"{fp}/c{g}": 2 for g in range(7)}
    assert sum(comm.wire_class_bytes.values()) == 2 * plan.wire_bytes
    assert sorted({t for c in req.classes for t in c.transfers}) == list(range(26))


def test_empty_exchange_completes_at_once():
    comm = Communicator(device="cpu")
    buf = torch.zeros((8, 16))
    req = comm.ineighbor_alltoallv(buf, [], [], [])
    assert isinstance(req, NeighborRequest)
    assert req.completed and req.pending == () and req.drained == []
    assert req.wait() is buf


# ---------------------------------------------------------------------------
# against the reference on 8 ranks
# ---------------------------------------------------------------------------

REFERENCE_CODE = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import Communicator, reschedule
from repro.compat import shard_map
from repro.halo import HaloSpec, make_halo_plan, overlapped_stencil_iteration

OUT = {out!r}
mesh = Mesh(np.array(jax.devices()), ("ranks",))
spec = HaloSpec(grid=(2, 2, 2), interior={interior!r}, radius=2)
start = np.load(f"{{OUT}}/in.npy")
R, az, ay, ax = start.shape
comm = Communicator(axis_name="ranks")
plan = make_halo_plan(spec, comm, schedule_policy="exact")
plan = dataclasses.replace(plan, wire=reschedule(plan.wire, "grouped"))
for mode in ("monolithic", "region"):
    def it(local, mode=mode):
        return overlapped_stencil_iteration(local, spec, comm, "ranks", steps=2,
                                            plan=plan, mode=mode)
    step = jax.jit(shard_map(it, mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"),
                             check_vma=False))
    out = np.asarray(step(jnp.asarray(start.reshape(R * az, ay, ax))))
    np.save(f"{{OUT}}/{{mode}}.npy", out.reshape(R, az, ay, ax))
print("REFERENCE_OK")
"""

REF_INTERIOR = (6, 5, 4)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("overlap_reference")
    spec = HaloSpec(grid=(2, 2, 2), interior=REF_INTERIOR, radius=2)
    start = np.random.default_rng(21).normal(size=(8,) + spec.alloc).astype(np.float32)
    np.save(out / "in.npy", start)
    log = run_with_devices(REFERENCE_CODE.format(out=str(out), interior=REF_INTERIOR), ndev=8)
    assert "REFERENCE_OK" in log
    return out, start


@pytest.mark.parametrize("mode", OVERLAP_MODES)
def test_overlapped_iteration_matches_the_reference_8_ranks(reference_run, mode):
    out, start = reference_run
    spec = HaloSpec(grid=(2, 2, 2), interior=REF_INTERIOR, radius=2)
    comm = Communicator(device="cpu")
    local = from_reference(start, spec, device="cpu")
    probe = {}
    overlapped_stencil_iteration(local, spec, comm, steps=2, probe=probe, mode=mode)
    want = np.load(out / f"{probe['overlap_mode']}.npy")
    np.testing.assert_allclose(local.numpy(), want, rtol=2e-6, atol=2e-6)
