"""The port's deep-halo programs against the JAX reference, on the CPU.

* ``program_fingerprint`` and ``_feasible_steps`` equal the reference's:
  the fingerprint keys the decisions file both packages read.
* ``price_program`` agrees with the reference at rel 1e-12 on the
  checked-in H100 tables (no stencil table: the copy proxy prices the
  redundant compute), the reference's CI tables and a seeded synthetic
  table with a stencil table.
* ``build_halo_program(steps="auto")`` picks the reference's depth from
  the same candidates, records a decisions file equal to the reference's
  byte for byte, and a reloaded file pins the pick in both packages.
* ``HaloProgram.iteration`` at s = 1, 2, 3 and for a 2-op cycle is
  bit-exact to the port's ``halo_exchange`` + ``stencil_cycle`` on a
  plan built apart, the interiors agree bit for bit across depths when
  the applications match, and the values agree with the reference
  (8 ranks, one subprocess, planned ``exact`` and rescheduled to
  ``grouped``) within its 2e-6.
* On grids with self-neighbours and uneven extents, (1,1,1), (1,2,3) and
  (4,1,1), with per-dimension radii, the plain exchange and a program at
  s = 2 equal the periodic numpy oracle bit for bit.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.halo as rhalo
import repro.halo.program as rprogram
from repro.comm.api import Communicator as RefCommunicator
from repro.core.datatypes import FLOAT as REF_FLOAT, DOUBLE as REF_DOUBLE
from repro.measure import DecisionCache as RefDecisionCache
from repro_torch.comm import Communicator
from repro_torch.core import DOUBLE, FLOAT
from repro_torch.halo import (
    MAX_AUTO_STEPS,
    STENCIL26,
    HaloSpec,
    StencilOp,
    build_halo_program,
    cycle_halo_radii,
    from_reference,
    get_default_halo_steps,
    halo_exchange,
    make_halo_plan,
    make_program_step,
    op_sequence,
    overlapped_stencil_iteration,
    parse_halo_steps,
    program_fingerprint,
    set_default_halo_steps,
    stencil_apply,
    stencil_cycle,
)
import repro_torch.halo.stencil as st
from repro_torch.halo.program import _feasible_steps
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.measure import DecisionCache, production_communicator
from tests._subproc import run_with_devices
from test_torch_overlap import TABLES, no_native_ragged, param_pair  # noqa: F401

PAIR = (StencilOp((2, 1, 1)), StencilOp((1, 1, 1), 0.3))
CYCLES = {"26pt": (STENCIL26,), "2x1x1": (StencilOp((2, 1, 1), 0.25),), "pair": PAIR}


def _ref_ops(ops):
    return tuple(rhalo.StencilOp(o.radii, o.weight) for o in ops)


@pytest.mark.parametrize("topo", ["", "a1b2c3d4e5f60718"])
@pytest.mark.parametrize("cycle", sorted(CYCLES))
def test_program_fingerprint_matches_the_reference(cycle, topo):
    ops = CYCLES[cycle]
    for grid, interior, (el, ref_el) in (((2, 2, 2), (256, 256, 256), (FLOAT, REF_FLOAT)),
                                         ((1, 2, 3), (6, 5, 4), (DOUBLE, REF_DOUBLE))):
        got = program_fingerprint(grid, interior, ops, el, topo)
        assert got == rprogram.program_fingerprint(grid, interior, _ref_ops(ops), ref_el, topo)
    assert program_fingerprint((2, 2, 2), (8, 8, 8), PAIR, FLOAT) != program_fingerprint(
        (2, 2, 2), (8, 8, 8), PAIR[::-1], FLOAT)


@pytest.mark.parametrize("cycle", sorted(CYCLES))
def test_feasible_steps_match_the_reference(cycle):
    ops = CYCLES[cycle]
    for interior in ((6, 5, 4), (1, 2, 9), (3, 3, 3), (256, 256, 256), (9, 2, 2)):
        for cap in (1, MAX_AUTO_STEPS, 5):
            assert _feasible_steps(interior, ops, cap) == rprogram._feasible_steps(
                interior, _ref_ops(ops), cap)


def test_halo_steps_parse_and_default():
    assert parse_halo_steps("auto") == "auto" and parse_halo_steps("3") == 3
    with pytest.raises(ValueError, match=">= 1"):
        parse_halo_steps(0)
    old = get_default_halo_steps()
    try:
        assert set_default_halo_steps(2) == 2 == get_default_halo_steps()
        comm = Communicator(device="cpu")
        assert build_halo_program((2, 2, 2), (6, 5, 4), comm).steps == 2
    finally:
        set_default_halo_steps(old)


def test_production_installs_the_default_halo_steps(tmp_path):
    old = get_default_halo_steps()
    try:
        comm, _ = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          halo_steps="1")
        assert get_default_halo_steps() == 1
        assert build_halo_program((2, 2, 2), (6, 5, 4), comm).steps == 1
    finally:
        set_default_halo_steps(old)


# ---------------------------------------------------------------------------
# pricing and the auto pick
# ---------------------------------------------------------------------------

def _close(a, b):
    return a == pytest.approx(b, rel=1e-12, abs=0.0)


def _same_estimate(a, b):
    assert (a.steps, a.cycle_len, a.wire_bytes, a.applications) == (
        b.steps, b.cycle_len, b.wire_bytes, b.applications)
    assert _close(a.t_exchange, b.t_exchange) and _close(a.t_redundant, b.t_redundant)
    assert _close(a.per_step, b.per_step)
    assert len(a.op_redundant) == len(b.op_redundant)
    assert all(map(_close, a.op_redundant, b.op_redundant))


@pytest.mark.parametrize("cycle", ["26pt", "pair"])
@pytest.mark.parametrize("table", TABLES)
def test_price_program_matches_the_reference(table, cycle, no_native_ragged):
    ref_params, params = param_pair(table)
    comm = Communicator(params=params, device="cpu")
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params)
    ops = CYCLES[cycle]
    for steps in (1, 2, 3):
        got = build_halo_program((2, 2, 2), (16, 12, 10), comm, steps=steps, ops=ops)
        want = rhalo.build_halo_program((2, 2, 2), (16, 12, 10), ref_comm, steps=steps,
                                        ops=_ref_ops(ops))
        assert got.plan.wire.fingerprint == want.plan.wire.fingerprint
        _same_estimate(got.estimate, want.estimate)
        assert got.estimate.t_redundant > 0 or steps == 1
        # the model's direct entry point, with the members' time given
        direct = comm.model.price_program(
            got.plan.wire, (16, 12, 10), [o.radii for o in ops],
            [o.nneighbors for o in ops], steps, t_members=1e-4)
        ref_direct = ref_comm.model.price_program(
            want.plan.wire, (16, 12, 10), [o.radii for o in ops],
            [o.nneighbors for o in ops], steps, t_members=1e-4)
        _same_estimate(direct, ref_direct)


@pytest.mark.parametrize("interior", [(16, 12, 10), (64, 64, 64), (5, 4, 6)])
@pytest.mark.parametrize("table", TABLES)
def test_auto_depth_and_decisions_file_match_the_reference(table, interior, tmp_path,
                                                           no_native_ragged):
    ref_params, params = param_pair(table)
    rec, ref_rec = DecisionCache(), RefDecisionCache()
    got = build_halo_program((2, 2, 2), interior,
                             Communicator(params=params, device="cpu", decisions=rec),
                             steps="auto")
    want = rhalo.build_halo_program(
        (2, 2, 2), interior, RefCommunicator(axis_name="ranks", params=ref_params,
                                             decisions=ref_rec), steps="auto")
    assert got.steps == want.steps and not got.pinned
    assert [e.steps for e in got.candidates] == [e.steps for e in want.candidates]
    for a, b in zip(got.candidates, want.candidates):
        _same_estimate(a, b)
    assert rec.to_json() == ref_rec.to_json()
    assert [d.strategy for d in rec.program_rows()] == [f"program/s={got.steps}"]
    path = rec.save(tmp_path / "decisions.json")
    again = build_halo_program((2, 2, 2), interior,
                               Communicator(params=params, device="cpu",
                                            decisions=DecisionCache.load(path)),
                               steps="auto")
    ref_again = rhalo.build_halo_program(
        (2, 2, 2), interior, RefCommunicator(axis_name="ranks", params=ref_params,
                                             decisions=RefDecisionCache.load(path)),
        steps="auto")
    assert (again.steps, again.pinned, again.candidates) == (got.steps, True, ())
    assert (ref_again.steps, ref_again.pinned) == (got.steps, True)


def test_fixed_depth_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="cannot host"):
        build_halo_program((2, 2, 2), (6, 5, 2), Communicator(device="cpu"), steps=3)


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

def _global(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _blocks(spec, g, fill=-1.0):
    """Every rank's block of the periodic global field ``g`` inside
    halos of ``spec.radii`` set to ``fill``."""
    n, r = spec.interior, spec.radii
    out = np.full((spec.nranks,) + spec.alloc, fill, np.float32)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        out[rank, r[0]:r[0] + n[0], r[1]:r[1] + n[1], r[2]:r[2] + n[2]] = g[
            c[0] * n[0]:(c[0] + 1) * n[0], c[1] * n[1]:(c[1] + 1) * n[1],
            c[2] * n[2]:(c[2] + 1) * n[2]]
    return out


def _interiors(spec, local):
    n, r = spec.interior, spec.radii
    return local[:, r[0]:r[0] + n[0], r[1]:r[1] + n[1], r[2]:r[2] + n[2]]


PROGRAM_INTERIOR = (6, 5, 4)


@pytest.mark.parametrize("overlap", [False, "monolithic", "region"])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_iteration_is_bit_exact_to_the_plain_path(steps, overlap):
    comm = Communicator(device="cpu")
    program = build_halo_program((2, 2, 2), PROGRAM_INTERIOR, comm, steps=steps)
    assert program.spec.radii == (steps,) * 3 and program.applications == steps
    spec = HaloSpec(grid=(2, 2, 2), interior=PROGRAM_INTERIOR, radius=steps)
    plan = make_halo_plan(spec, Communicator(device="cpu"))
    g = _global((12, 10, 8), 3)
    got = from_reference(_blocks(program.spec, g), program.spec, device="cpu")
    want = got.clone()
    step = make_program_step(program, comm, device="cpu", overlap=overlap)
    for _ in range(2):
        assert step(got) is got
        stencil_cycle(halo_exchange(want, spec, comm, plan=plan), spec,
                      STENCIL26, steps)
    assert torch.equal(got, want)


def test_depths_agree_on_the_interior_bit_for_bit():
    comm = Communicator(device="cpu")
    g = _global((12, 10, 8), 4)
    interiors = []
    for steps in (1, 2, 3):
        program = build_halo_program((2, 2, 2), PROGRAM_INTERIOR, comm, steps=steps)
        x = from_reference(_blocks(program.spec, g), program.spec, device="cpu")
        for _ in range(6 // steps):
            program.iteration(x, comm)
        interiors.append(_interiors(program.spec, x))
    assert torch.equal(interiors[0], interiors[1]) and torch.equal(interiors[0], interiors[2])


def test_cycle_program_is_bit_exact_to_the_plain_path():
    comm = Communicator(device="cpu")
    program = build_halo_program((2, 2, 2), (8, 7, 6), comm, steps=2, ops=PAIR)
    assert program.spec.radii == (6, 4, 4) and program.applications == 4
    assert (program.exchanges_per_step, program.exchanges_per_cycle) == (0.25, 0.5)
    with pytest.raises(ValueError, match="2-op cycle"):
        program.op
    spec = HaloSpec(grid=(2, 2, 2), interior=(8, 7, 6), radius=(6, 4, 4))
    plan = make_halo_plan(spec, Communicator(device="cpu"))
    g = _global((16, 14, 12), 5)
    got = from_reference(_blocks(spec, g), spec, device="cpu")
    want = got.clone()
    program.iteration(got, comm)
    stencil_cycle(halo_exchange(want, spec, comm, plan=plan), spec, PAIR, 2)
    assert torch.equal(got, want)
    over = from_reference(_blocks(spec, g), spec, device="cpu")
    program.iteration(over, comm, overlap="region")
    assert torch.equal(over, want)


def _applications_one_by_one(local, spec, ops, repeats):
    """Each application in place through ``stencil_apply``: the schedule
    that the scratch chain of ``stencil_cycle`` replaces."""
    valid = spec.radii
    for o in op_sequence(ops, repeats):
        stencil_apply(local, spec, valid, o)
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    return local


WIDE = StencilOp((2, 1, 1), 0.3)
#: case: (cycle, repeats, whether the chain ends in the fused pair)
SCRATCH_CASES = {
    "26pt_s1": ((STENCIL26,), 1, False),
    "26pt_s2": ((STENCIL26,), 2, False),
    "26pt_s3": ((STENCIL26,), 3, True),
    "26pt_s4": ((STENCIL26,), 4, False),
    "26pt_s5": ((STENCIL26,), 5, True),
    "26pt_s7": ((STENCIL26,), 7, True),
    "pair_s2": ((StencilOp((2, 1, 1)), StencilOp((1, 2, 3), 0.3)), 2, False),
    "pair_s1": ((StencilOp((2, 1, 1)), StencilOp((1, 2, 3), 0.3)), 1, False),
    "wide_26_s1": ((WIDE, STENCIL26), 1, False),
    "wide_26_s2": ((WIDE, STENCIL26), 2, False),
    "26_wide_26_s1": ((STENCIL26, WIDE, STENCIL26), 1, False),
    "wide_26_26_s1": ((WIDE, STENCIL26, StencilOp((1, 1, 1), 0.3)), 1, True),
}


@pytest.fixture
def pair_calls(monkeypatch):
    """The windows of the fused pairs the halo layer asks for, in order."""
    calls, pair = [], st.stencil_window_pair

    def counted(arr, offsets, weights, origin, shape, **kw):
        calls.append((tuple(origin), tuple(shape)))
        return pair(arr, offsets, weights, origin, shape, **kw)

    monkeypatch.setattr(st, "stencil_window_pair", counted)
    return calls


@pytest.mark.parametrize("case", sorted(SCRATCH_CASES))
def test_scratch_cycle_equals_the_applications_one_by_one_halos_included(case, pair_calls):
    ops, repeats, paired = SCRATCH_CASES[case]
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 7), radius=cycle_halo_radii(ops, repeats))
    start = torch.from_numpy(
        np.random.default_rng(8).normal(size=(8,) + spec.alloc).astype(np.float32))
    want = _applications_one_by_one(start.clone(), spec, ops, repeats)
    reset_launch_counts()
    splices = st.splice_copies
    got = start.clone()
    assert stencil_cycle(got, spec, ops, repeats) is got
    assert torch.equal(got, want)
    napp = repeats * len(ops)
    assert len(pair_calls) == paired
    assert st.splice_copies - splices == napp % 2 - paired  # 0 for an even chain
    counts = launch_counts()  # the CPU takes the plain versions and launches nothing
    assert counts["stencil"] == counts["stencil_pairs"] == counts["stencil_runtime"] == 0


@pytest.mark.parametrize("mode", ["monolithic", "region"])
def test_overlapped_iteration_equals_exchange_and_applications_one_by_one(mode):
    comm = Communicator(device="cpu")
    spec = HaloSpec(grid=(2, 2, 2), interior=PROGRAM_INTERIOR, radius=2)
    plan = make_halo_plan(spec, comm)
    got = from_reference(_blocks(spec, _global((12, 10, 8), 6)), spec, device="cpu")
    want = got.clone()
    for _ in range(2):
        _applications_one_by_one(halo_exchange(want, spec, comm, plan=plan), spec,
                                 (STENCIL26,), 2)
        program_iteration = overlapped_stencil_iteration(got, spec, comm, steps=2,
                                                         plan=plan, mode=mode)
        assert program_iteration is got
    assert torch.equal(got, want)


def test_traced_iteration_walks_the_scratch_schedule_one_span_an_application():
    from repro_torch.obs import Tracer

    tracer = Tracer()
    plain = Communicator(device="cpu")
    traced = Communicator(device="cpu", tracer=tracer)
    prog = build_halo_program((2, 2, 2), PROGRAM_INTERIOR, plain, steps=2)
    tprog = build_halo_program((2, 2, 2), PROGRAM_INTERIOR, traced, steps=2)
    g = _global((12, 10, 8), 7)
    want = from_reference(_blocks(prog.spec, g), prog.spec, device="cpu")
    got = want.clone()
    splices = st.splice_copies
    for _ in range(3):
        prog.iteration(want, plain)
        assert tprog.iteration(got, traced) is got
    assert torch.equal(got, want)
    names = [s.name for s in tracer.spans]
    assert names.count("program_iteration") == 3 and names.count("stencil") == 6
    assert [s.attrs["application"] for s in tracer.spans if s.name == "stencil"] == [0, 1] * 3
    assert st.splice_copies == splices  # both schedules' s = 2 chains copy no window


def test_program_step_refuses_another_device():
    comm = Communicator(device="cpu")
    program = build_halo_program((2, 2, 2), PROGRAM_INTERIOR, comm, steps=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_program_step(program, comm)


REFERENCE_CODE = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import Communicator, reschedule
from repro.compat import shard_map
from repro.halo import StencilOp, build_halo_program

OUT = {out!r}
mesh = Mesh(np.array(jax.devices()), ("ranks",))
comm = Communicator(axis_name="ranks")
pair = (StencilOp((2, 1, 1)), StencilOp((1, 1, 1), 0.3))
for name, steps, ops in (("s1", 1, None), ("s2", 2, None), ("s3", 3, None),
                         ("pair", 1, pair)):
    program = build_halo_program((2, 2, 2), {interior!r}, comm, steps=steps, ops=ops,
                                 schedule_policy="exact")
    plan = dataclasses.replace(program.plan, wire=reschedule(program.plan.wire, "grouped"))
    program = dataclasses.replace(program, plan=plan)
    start = np.load(f"{{OUT}}/in_{{name}}.npy")
    R, az, ay, ax = start.shape
    step = jax.jit(shard_map(lambda x: program.iteration(x, comm, "ranks"), mesh=mesh,
                             in_specs=P("ranks"), out_specs=P("ranks"), check_vma=False))
    out = np.asarray(step(jnp.asarray(start.reshape(R * az, ay, ax))))
    np.save(f"{{OUT}}/out_{{name}}.npy", out.reshape(R, az, ay, ax))
print("REFERENCE_OK")
"""

REF_INTERIOR = (6, 5, 4)
REF_PROGRAMS = {"s1": (1, None), "s2": (2, None), "s3": (3, None), "pair": (1, PAIR)}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("program_reference")
    comm = Communicator(device="cpu")
    starts = {}
    for k, (name, (steps, ops)) in enumerate(sorted(REF_PROGRAMS.items())):
        spec = build_halo_program((2, 2, 2), REF_INTERIOR, comm, steps=steps, ops=ops).spec
        starts[name] = np.random.default_rng(30 + k).normal(
            size=(8,) + spec.alloc).astype(np.float32)
        np.save(out / f"in_{name}.npy", starts[name])
    log = run_with_devices(REFERENCE_CODE.format(out=str(out), interior=REF_INTERIOR), ndev=8)
    assert "REFERENCE_OK" in log
    return out, starts


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_program_matches_the_reference_8_ranks(reference_run, name):
    out, starts = reference_run
    steps, ops = REF_PROGRAMS[name]
    comm = Communicator(device="cpu")
    program = build_halo_program((2, 2, 2), REF_INTERIOR, comm, steps=steps, ops=ops)
    local = from_reference(starts[name], program.spec, device="cpu")
    program.iteration(local, comm)
    np.testing.assert_allclose(local.numpy(), np.load(out / f"out_{name}.npy"),
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# more grids: self-neighbours, uneven extents, per-dimension radii
# ---------------------------------------------------------------------------

#: grid -> (interior, exchange radii, the program's op)
GRIDS = {
    (1, 1, 1): ((4, 5, 6), (1, 2, 1), StencilOp((1, 2, 1))),
    (1, 2, 3): ((5, 4, 6), (2, 1, 2), StencilOp((2, 1, 1))),
    (4, 1, 1): ((3, 5, 4), (1, 1, 2), StencilOp((1, 1, 2))),
}


def _oracle_blocks(spec, g):
    """Every cell of every rank, halos included, as the periodic global
    field ``g`` has it."""
    want = np.empty((spec.nranks,) + spec.alloc, np.float32)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        idx = [(np.arange(a) - r + ci * n) % gn
               for a, r, ci, n, gn in zip(spec.alloc, spec.radii, c, spec.interior, g.shape)]
        want[rank] = g[np.ix_(*idx)]
    return want


def _oracle_stencil(g, op):
    """One application of ``op`` on the periodic global field, in the
    port's order and float32 rounding."""
    w = np.float32(op.weight)
    acc = np.zeros_like(g)
    for d in op.offsets:
        acc += np.roll(g, tuple(-x for x in d), (0, 1, 2))
    acc *= w / np.float32(len(op.offsets))
    return acc + g * (np.float32(1) - w)


@pytest.mark.parametrize("what", ["exchange", "program_s2"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_more_grids_match_the_periodic_oracle(grid, what):
    interior, radii, op = GRIDS[grid]
    g = _global(tuple(p * n for p, n in zip(grid, interior)), sum(grid))
    comm = Communicator(device="cpu")
    if what == "exchange":
        spec = HaloSpec(grid=grid, interior=interior, radius=radii)
        local = from_reference(_blocks(spec, g), spec, device="cpu")
        halo_exchange(local, spec, comm)
        np.testing.assert_array_equal(local.numpy(), _oracle_blocks(spec, g))
        return
    program = build_halo_program(grid, interior, comm, steps=2, op=op)
    assert program.spec.radii == tuple(2 * r for r in op.radii)
    local = from_reference(_blocks(program.spec, g), program.spec, device="cpu")
    program.iteration(local, comm)
    want = _oracle_stencil(_oracle_stencil(g, op), op)
    got = _interiors(program.spec, local).numpy()
    np.testing.assert_array_equal(got, _interiors(program.spec, _oracle_blocks(program.spec,
                                                                                want)))
