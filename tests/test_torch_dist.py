"""One process per rank: the port's ``torch.distributed`` transport
under gloo on the CPU, against the local mesh, the periodic numpy oracle
and the JAX reference.

Three runs start together, once for the module, each under its own
timeout: 8 gloo processes over a ``file://`` store (no TCP port), one
reference subprocess on 8 host devices, and the ``stencil3d`` launcher
in 2 processes.  The tests then read what they wrote.

* ``permute`` against the reference: R = 4, a partial ``perm``
  (``[(0, 1)]``), every port strategy, incount 1 and 2, on the local mesh
  and on a 4-rank subgroup of the gloo run; ranks that no edge reaches
  unpack zeros, as under ``lax.ppermute`` (the reference runs ``xla``:
  its ``rows``/``dma`` under ``shard_map`` raise on this JAX).
* 8 processes, 2x2x2 grid, interior 6, radius 2: the exchange under
  ``grouped``, ``uniform`` and ``ragged`` in modes ``tempi`` and
  ``baseline``, bit-exact against the local mesh and the oracle, with
  each process's wire ops and bytes equal to the local mesh's; the plan
  (schedule, strategies, prices) equal to the reference planner's with
  its native ragged collective.
* The same processes: the s = 2 program plain, ``monolithic`` and
  ``region`` bit-exact against the local mesh, within 2e-6 of one
  reference run (planned ``exact``, rescheduled to ``grouped``: the
  reference's ``ragged`` does not run on XLA:CPU); ``steps="auto"`` with
  every rank on the reference's pick.
* A 2-rank subgroup on a (2, 1, 1) grid with per-dimension radii: self
  edges under gloo, against the oracle.  The same subgroup runs the
  compressed-wire gate on a 2-ring under the probed ``varlen`` schedule,
  bit-exact to the local mesh.
* ``python -m repro_torch.launch.stencil3d --nprocs 2 --backend gloo``:
  the reference example's lines, and the gathered interior equals the
  local mesh's.
* ``production_communicator(transport=...)``: every rank records the
  ``program/s=N`` decision, rank 0 alone writes the file.
* The two-level machine: 8 processes, 4 a node
  (``Topology.blocked(8, 4)``), the exchange under ``tiered`` (one
  bundle of the 4 node-crossing classes, 3 correction hops) bit-exact
  against the local mesh and the oracle with equal op and byte counts;
  ``--ranks-per-node 1`` on the launcher prints the topology's
  fingerprint and the flat run's checksum.
* Raising paths: NCCL on the CPU, gloo on the card, a mismatched plan
  or topology across ranks, a block of the wrong shape, and a
  ``tiered`` plan without a topology or a ``varlen`` plan without
  stream lengths.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.comm.perfmodel as rpm
import repro.halo as rhalo
from repro.comm.api import Communicator as RefCommunicator
from repro_torch.comm import (
    Communicator,
    DistributedTransport,
    FixedPolicy,
    Topology,
    policy_for_mode,
    reschedule,
)
from repro_torch.core import FLOAT, Subarray, Vector
from repro_torch.halo import (
    HaloSpec,
    build_halo_program,
    from_reference,
    halo_exchange,
    make_halo_plan,
)
from repro_torch.launch.procgroup import init_process_group
from repro_torch.launch.stencil3d import _seed_block, dims_create
from tests._subproc import REPO
from test_torch_comm import _ref_values
from test_torch_program import _blocks, _global, _interiors, _oracle_blocks

#: every spawn or subprocess of this module ends within this many seconds
TIMEOUT_S = 150
WORLD = 8
GRID, INTERIOR, RADIUS = (2, 2, 2), (6, 6, 6), 2
SPEC = HaloSpec(grid=GRID, interior=INTERIOR, radius=RADIUS)
#: the (2, 1, 1) grid with per-dimension radii, run by ranks 0 and 1
SPEC2 = HaloSpec(grid=(2, 1, 1), interior=(4, 5, 6), radius=(2, 1, 2))
SCHEDULES = ("grouped", "uniform", "ragged")
STRATEGIES = ("rows", "dma", "xla", "ref", "bounding", "auto")
PERM_R, PERM = 4, [(0, 1)]
PERM_TYPE = (6, 5, 12)  # Vector(count, blocklength, stride) of FLOAT
OVERLAPS = ("plain", "monolithic", "region")
#: the compressed-wire gate's Subarray (sizes, subsizes, starts) of FLOAT
GATE_TYPE = ((32, 32), (16, 16), (4, 4))
#: the two-level machine of the tiered exchange: one z slab a node
RANKS_PER_NODE = 4


def _gate_buffers():
    """Two ranks' (32, 32) float32 buffers: zero but for a 2x2 patch
    inside the gate's region, of another value on each rank with the same
    runs of bytes (2.5 and 3.5 differ in one byte), so rank 1's stream
    fits the budget probed on rank 0."""
    out = np.zeros((2, 32, 32), np.float32)
    for rank in range(2):
        out[rank, 10:12, 6:8] = 2.5 + rank
    return out

WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import (Communicator, DistributedTransport, FixedPolicy, Topology,
                              policy_for_mode, reschedule)
from repro_torch.core import FLOAT, Subarray, Vector
from repro_torch.halo import (HaloSpec, build_halo_program, from_reference, halo_exchange,
                              make_halo_plan, make_halo_step, make_program_step)
from repro_torch.launch.procgroup import destroy_process_group, init_process_group
from repro_torch.measure import DecisionCache, production_communicator

rank, world, store, IN = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
C = json.load(open(f"{IN}/config.json"))
info = init_process_group("gloo", "cpu", store_path=store, rank=rank, world_size=world)
res, arrays = {}, {}
g, g2 = np.load(f"{IN}/g.npy"), np.load(f"{IN}/g2.npy")


def comm_for(mode="tempi", group=None, **kw):
    policy = policy_for_mode(mode) if mode in ("tempi", "baseline") else FixedPolicy(mode)
    return Communicator(policy=policy, transport=DistributedTransport(group, "cpu"), **kw)


def block(spec, field, r):
    """Rank r's block of the periodic field, halos -1: (1, az, ay, ax)."""
    n, rad = spec.interior, spec.radii
    c = spec.coords(r)
    out = np.full((1,) + spec.alloc, -1.0, np.float32)
    out[0, rad[0]:rad[0] + n[0], rad[1]:rad[1] + n[1], rad[2]:rad[2] + n[2]] = field[
        c[0] * n[0]:(c[0] + 1) * n[0], c[1] * n[1]:(c[1] + 1) * n[1],
        c[2] * n[2]:(c[2] + 1) * n[2]]
    return torch.from_numpy(out)


spec = HaloSpec(grid=tuple(C["grid"]), interior=tuple(C["interior"]), radius=C["radius"])
for mode in ("tempi", "baseline"):
    for sched in C["schedules"]:
        comm = comm_for(mode)
        plan = make_halo_plan(spec, comm, schedule_policy="exact")
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
        local = block(spec, g, rank)
        halo_exchange(local, spec, comm, plan=plan)
        arrays[f"x_{mode}_{sched}"] = local[0].numpy()
        res[f"x_{mode}_{sched}"] = [comm.wire_ops, comm.wire_payload_bytes]

# the two-level machine: 4 ranks a node, every class with a dz component
# crosses nodes, and the tiered schedule coalesces them into one bundle
topo = Topology.blocked(world, C["ranks_per_node"])
for policy in ("exact", "model"):
    comm = comm_for("tempi", topology=topo)
    plan = make_halo_plan(spec, comm, schedule_policy=policy)
    res[f"topo_plan_{policy}"] = [plan.wire.schedule, plan.wire.fingerprint]
    if policy == "exact":
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, "tiered"))
        local = block(spec, g, rank)
        halo_exchange(local, spec, comm, plan=plan)
        arrays["x_tiered"] = local[0].numpy()
        res["x_tiered"] = [comm.wire_ops, comm.wire_payload_bytes, plan.wire.fingerprint]

comm = comm_for("tempi")
for policy in ("exact", "model"):
    plan = make_halo_plan(spec, comm, schedule_policy=policy)
    res[f"plan_{policy}"] = {
        "schedule": plan.wire.schedule, "fingerprint": plan.wire.fingerprint,
        "wire_bytes": plan.wire_bytes, "issued_bytes": plan.wire.issued_bytes,
        "strategies": [s.name for s in plan.strategies],
        "price": comm.model.price_exchange(plan.wire).total}
    if policy == "exact":
        _, costs = comm.model.choose_wire_schedule(plan.wire, True)
        res["costs"] = costs

prog = build_halo_program(spec.grid, spec.interior, comm, steps=2)
for ov in C["overlaps"]:
    x = block(prog.spec, g, rank)
    step = make_program_step(prog, comm, device="cpu", overlap=False if ov == "plain" else ov)
    for _ in range(2):
        step(x)
    arrays[f"p_{ov}"] = x[0].numpy()
auto = build_halo_program(spec.grid, spec.interior, comm_for("tempi", decisions=DecisionCache()),
                          steps="auto")
x = block(auto.spec, g, rank)
auto.iteration(x, comm)
arrays["p_auto"] = x[0].numpy()
res["auto"] = [auto.steps, auto.pinned, auto.plan.wire.fingerprint]

sub4 = dist.new_group(list(range(C["perm_r"])))
sub2 = dist.new_group([0, 1])
if rank < C["perm_r"]:
    count, blk, stride = C["perm_type"]
    for strat in C["strategies"]:
        for incount in (1, 2):
            comm = comm_for(strat, sub4)
            ct = comm.commit(Vector(count, blk, stride, FLOAT))
            n = ct.extent * incount // 4 + 3
            src = torch.arange(C["perm_r"] * n, dtype=torch.float32).view(-1, n)[rank:rank + 1]
            dst = torch.full((1, n), -1.0)
            assert comm.sendrecv(src.clone(), dst, ct, C["perm"], incount=incount) is dst
            arrays[f"perm_{strat}_{incount}"] = dst[0].numpy()
            res[f"perm_{strat}_{incount}"] = [comm.wire_ops, comm.wire_payload_bytes]
if rank < 2:
    spec2 = HaloSpec(grid=(2, 1, 1), interior=tuple(C["interior2"]), radius=tuple(C["radius2"]))
    for sched in C["schedules"]:
        comm = comm_for("tempi", sub2)
        plan = make_halo_plan(spec2, comm, schedule_policy="exact")
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
        local = block(spec2, g2, rank)
        halo_exchange(local, spec2, comm, plan=plan)
        arrays[f"self_{sched}"] = local[0].numpy()
        res[f"self_{sched}"] = [comm.wire_ops, comm.wire_payload_bytes]
    # the probed varlen exchange of the compressed-wire gate on a 2-ring:
    # every rank plans from the same probe, rank 0's buffer
    gate = np.load(f"{IN}/gate.npy")
    comm = comm_for("tempi", sub2)
    ct = comm.commit(Subarray(*C["gate_type"], FLOAT))
    ring = [(0, 1), (1, 0)]
    strats, plan = comm.plan_neighbor([ct], [ring], probe=torch.from_numpy(gate[0]))
    buf = torch.from_numpy(gate[rank:rank + 1].copy())
    comm.neighbor_alltoallv(buf, [ct], [ct], [ring], plan=plan, strategies=strats)
    arrays["varlen"] = buf[0].numpy()
    res["varlen"] = {"schedule": plan.schedule, "strategies": [x.name for x in strats],
                     "stream_bytes": list(plan.stream_bytes), "fingerprint": plan.fingerprint,
                     "counts": [comm.wire_ops, comm.wire_payload_bytes],
                     "compress": [comm.compress_exchanges, comm.compress_capacity_bytes,
                                  comm.compress_stream_bytes]}

# production wiring: every rank records, rank 0 alone writes the file
pcomm, save = production_communicator(f"{IN}/store{rank}", calibrate=False,
                                      transport=DistributedTransport(None, "cpu"))
build_halo_program(spec.grid, spec.interior, pcomm, steps="auto")
res["production"] = [len(pcomm.model.decisions.program_rows()), str(save())]

# raising paths: every rank reaches the same collectives
comm = comm_for("tempi")
try:
    build_halo_program(spec.grid, spec.interior, comm, steps=1 if rank == 0 else 2)
    res["mismatch"] = None
except RuntimeError as e:
    res["mismatch"] = str(e)
try:
    halo_exchange(torch.zeros((world,) + spec.alloc), spec, comm)
    res["shape"] = None
except ValueError as e:
    res["shape"] = str(e)
try:
    make_halo_step(spec, comm_for("tempi", topology=Topology.blocked(world, 4 if rank else 2)),
                   device="cpu")
    res["topo_mismatch"] = None
except RuntimeError as e:
    res["topo_mismatch"] = str(e)
plan = make_halo_plan(spec, comm, schedule_policy="exact")
res["unported"] = {}
for sched in ("varlen", "tiered"):
    try:
        comm.transport.exchange(torch.zeros((1, plan.wire_bytes), dtype=torch.uint8),
                                dataclasses.replace(plan.wire, schedule=sched))
        res["unported"][sched] = None
    except ValueError as e:
        res["unported"][sched] = str(e)
dist.barrier()
np.savez(f"{IN}/rank{rank}.npz", **arrays)
json.dump(res, open(f"{IN}/rank{rank}.json", "w"))
destroy_process_group()
print("WORKER_OK", rank)
'''

REFERENCE = r'''
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import Communicator, policy_for_mode, reschedule
from repro.compat import shard_map
from repro.core.datatypes import FLOAT, Vector
from repro.halo import build_halo_program

IN = {inp!r}
R = {perm_r}
mesh = Mesh(np.array(jax.devices()[:R]), ("ranks",))
comm = Communicator(axis_name="ranks", policy=policy_for_mode("xla"))
ct = comm.commit(Vector(*{perm_type!r}, FLOAT))
for incount in (1, 2):
    n = ct.extent * incount // 4 + 3
    src = jnp.arange(R * n, dtype=jnp.float32)
    dst = jnp.full((R * n,), -1.0, jnp.float32)
    f = jax.jit(shard_map(lambda a, b: comm.sendrecv(a, b, ct, {perm!r}, incount=incount),
                          mesh=mesh, in_specs=(P("ranks"), P("ranks")),
                          out_specs=P("ranks"), check_vma=False))
    np.save(f"{{IN}}/ref_perm_{{incount}}.npy", np.asarray(f(src, dst)).reshape(R, n))

mesh = Mesh(np.array(jax.devices()), ("ranks",))
comm = Communicator(axis_name="ranks")
program = build_halo_program({grid!r}, {interior!r}, comm, steps=2, schedule_policy="exact")
plan = dataclasses.replace(program.plan, wire=reschedule(program.plan.wire, "grouped"))
program = dataclasses.replace(program, plan=plan)
start = np.load(f"{{IN}}/ref_program_in.npy")
W, az, ay, ax = start.shape
step = jax.jit(shard_map(lambda x: program.iteration(x, comm, "ranks"), mesh=mesh,
                         in_specs=P("ranks"), out_specs=P("ranks"), check_vma=False))
state = jnp.asarray(start.reshape(W * az, ay, ax))
for _ in range(2):
    state = step(state)
np.save(f"{{IN}}/ref_program_out.npy", np.asarray(state).reshape(W, az, ay, ax))
print("REFERENCE_OK")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _wait_all(procs, deadline):
    """Wait for every ``(name, Popen)``; on the deadline end them all and
    fail.  Returns ``{name: stdout}``; a failed process fails the run."""
    outs = {}
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"{name} failed (rc={p.returncode})\n{out}\n{err}")
            outs[name] = out
    except subprocess.TimeoutExpired:
        raise AssertionError(f"processes still running after {TIMEOUT_S} s") from None
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the gloo world, the reference and the launcher together;
    wait for all three."""
    inp = tmp_path_factory.mktemp("dist")
    g = _global(tuple(p * n for p, n in zip(GRID, INTERIOR)), 18)
    g2 = _global(tuple(p * n for p, n in zip(SPEC2.grid, SPEC2.interior)), 19)
    np.save(inp / "g.npy", g)
    np.save(inp / "g2.npy", g2)
    s2 = HaloSpec(grid=GRID, interior=INTERIOR, radius=2)  # the s = 2 program's geometry
    np.save(inp / "ref_program_in.npy", _blocks(s2, g))
    (inp / "config.json").write_text(json.dumps({
        "grid": GRID, "interior": INTERIOR, "radius": RADIUS, "schedules": SCHEDULES,
        "overlaps": OVERLAPS, "strategies": STRATEGIES, "perm_r": PERM_R, "perm": PERM,
        "perm_type": PERM_TYPE, "interior2": SPEC2.interior, "radius2": SPEC2.radius,
        "gate_type": GATE_TYPE, "ranks_per_node": RANKS_PER_NODE}))
    np.save(inp / "gate.npy", _gate_buffers())
    (inp / "worker.py").write_text(WORKER)
    env, deadline = _env(), time.monotonic() + TIMEOUT_S
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(inp))
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(inp / "worker.py"), str(r), str(WORLD), str(inp / "store"),
         str(inp)], env=env, **pipe)) for r in range(WORLD)]
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_env.setdefault("JAX_PLATFORMS", "cpu")
    code = REFERENCE.format(inp=str(inp), perm_r=PERM_R, perm_type=PERM_TYPE, perm=PERM,
                            grid=GRID, interior=INTERIOR)
    procs.append(("reference", subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)], env=ref_env, **pipe)))
    procs.append(("launcher", subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.stencil3d", "--nprocs", "2",
         "--backend", "gloo", "--device", "cpu", "--interior", "6", "--iters", "1",
         "--out", str(inp / "launcher.npy")], env=env, **pipe)))
    procs.append(("launcher_topo", subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.stencil3d", "--nprocs", "2",
         "--backend", "gloo", "--device", "cpu", "--interior", "6", "--iters", "1",
         "--ranks-per-node", "1"], env=env, **pipe)))
    outs = _wait_all(procs, deadline)
    ranks = [(dict(np.load(inp / f"rank{r}.npz")), json.loads((inp / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return {"inp": inp, "g": g, "g2": g2, "ranks": ranks, "out": outs}


def _local_exchange(spec, field, mode, sched):
    """The same exchange on the local mesh: every rank's block and the
    transport's counts."""
    policy = policy_for_mode(mode) if mode in ("tempi", "baseline") else FixedPolicy(mode)
    comm = Communicator(policy=policy, device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    plan = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
    local = from_reference(_blocks(spec, field), spec, device="cpu")
    halo_exchange(local, spec, comm, plan=plan)
    return local.numpy(), [comm.wire_ops, comm.wire_payload_bytes]


# ---------------------------------------------------------------------------
# permute: a rank that no edge reaches receives zeros
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["local", "gloo"])
@pytest.mark.parametrize("incount", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partial_permute_matches_the_reference(runs, strategy, incount, transport):
    want = np.load(runs["inp"] / f"ref_perm_{incount}.npy")
    comm = Communicator(policy=FixedPolicy(strategy), device="cpu")
    ct = comm.commit(Vector(*PERM_TYPE, FLOAT))
    n = ct.extent * incount // 4 + 3
    count, blk, stride = PERM_TYPE
    idx = np.concatenate([np.arange(count * blk) // blk * stride + np.arange(count * blk) % blk
                          + rep * ct.extent // 4 for rep in range(incount)])
    # rank 1 gets rank 0's elements; the ranks no edge reaches unpack zeros
    np.testing.assert_array_equal(want[1, idx], idx.astype(np.float32))
    assert not want[[0, 2, 3]][:, idx].any()
    if transport == "local":
        src = torch.arange(PERM_R * n, dtype=torch.float32).view(PERM_R, n)
        dst = torch.full((PERM_R, n), -1.0)
        comm.sendrecv(src, dst, ct, PERM, incount=incount)
        got, counts = dst.numpy(), [[comm.wire_ops, comm.wire_payload_bytes]] * PERM_R
    else:
        key = f"perm_{strategy}_{incount}"
        got = np.stack([runs["ranks"][r][0][key] for r in range(PERM_R)])
        counts = [runs["ranks"][r][1][key] for r in range(PERM_R)]
    np.testing.assert_array_equal(got, want)
    nbytes = comm.select(ct, incount).wire_bytes(ct, incount)
    assert counts == [[1, nbytes]] * PERM_R


# ---------------------------------------------------------------------------
# 8 processes: the exchange, the plan, the programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", ["tempi", "baseline"])
def test_exchange_under_gloo_is_bit_exact(runs, mode, schedule):
    local, counts = _local_exchange(SPEC, runs["g"], mode, schedule)
    oracle = _oracle_blocks(SPEC, runs["g"])
    np.testing.assert_array_equal(local, oracle)
    for rank, (arrays, res) in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(arrays[f"x_{mode}_{schedule}"], oracle[rank])
        assert res[f"x_{mode}_{schedule}"] == counts


def _ref_comm():
    """The reference's communicator on the port's default table."""
    return RefCommunicator(axis_name="ranks",
                           params=rpm.SystemParams(name="h100", **_ref_values("h100")))


def _ref_plan(policy):
    import repro.comm.wireplan as rwp

    rwp.plan_wire.cache_clear()  # a plan cached under a patched flag must not answer
    ref_spec = rhalo.HaloSpec(grid=GRID, interior=INTERIOR, radius=RADIUS)
    ref_comm = _ref_comm()
    return ref_comm, rhalo.make_halo_plan(ref_spec, ref_comm, schedule_policy=policy)


@pytest.mark.parametrize("policy", ["exact", "model"])
def test_plan_matches_the_reference_with_native_ragged(runs, policy):
    """The reference plans with its native ragged collective (JAX 0.9 has
    it); the distributed transport has one too, so the plans are equal."""
    ref_comm, ref = _ref_plan(policy)
    want = {"schedule": ref.wire.schedule, "fingerprint": ref.wire.fingerprint,
            "wire_bytes": ref.wire_bytes, "issued_bytes": ref.wire.issued_bytes,
            "strategies": [s.name for s in ref.strategies]}
    price = ref_comm.model.price_exchange(ref.wire).total
    for _, res in runs["ranks"]:
        got = dict(res[f"plan_{policy}"])
        assert got.pop("price") == pytest.approx(price, rel=1e-12, abs=0)
        assert got == want
    if policy == "exact":
        assert want["schedule"] == "ragged"
        _, costs = ref_comm.model.choose_wire_schedule(ref.wire, native=True)
        for _, res in runs["ranks"]:
            assert res["costs"].keys() == costs.keys()
            for k in costs:
                assert res["costs"][k] == pytest.approx(costs[k], rel=1e-12, abs=0)


@pytest.mark.parametrize("overlap", OVERLAPS)
def test_program_under_gloo_is_bit_exact_to_the_local_mesh(runs, overlap):
    comm = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, comm, steps=2)
    x = from_reference(_blocks(prog.spec, runs["g"]), prog.spec, device="cpu")
    for _ in range(2):
        prog.iteration(x, comm, overlap=False if overlap == "plain" else overlap)
    for rank, (arrays, _) in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(arrays[f"p_{overlap}"], x[rank].numpy())
    want = np.load(runs["inp"] / "ref_program_out.npy")
    got = np.stack([a[f"p_{overlap}"] for a, _ in runs["ranks"]])
    np.testing.assert_allclose(_interiors(prog.spec, got), _interiors(prog.spec, want),
                               rtol=2e-6, atol=2e-6)


def test_auto_depth_is_the_same_on_every_rank(runs):
    want = rhalo.build_halo_program(GRID, INTERIOR, _ref_comm(), steps="auto")
    picks = {tuple(res["auto"]) for _, res in runs["ranks"]}
    assert picks == {(want.steps, False, want.plan.wire.fingerprint)}
    comm = Communicator(device="cpu")
    prog = build_halo_program(GRID, INTERIOR, comm, steps=want.steps)
    x = from_reference(_blocks(prog.spec, runs["g"]), prog.spec, device="cpu")
    prog.iteration(x, comm)
    for rank, (arrays, _) in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(arrays["p_auto"], x[rank].numpy())


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_self_edges_under_gloo_match_the_oracle(runs, schedule):
    """A (2, 1, 1) grid: every dz = 0 direction is a self edge."""
    oracle = _oracle_blocks(SPEC2, runs["g2"])
    local, counts = _local_exchange(SPEC2, runs["g2"], "tempi", schedule)
    np.testing.assert_array_equal(local, oracle)
    for rank in range(2):
        arrays, res = runs["ranks"][rank]
        np.testing.assert_array_equal(arrays[f"self_{schedule}"], oracle[rank])
        assert res[f"self_{schedule}"] == counts


def test_varlen_under_gloo_is_bit_exact_to_the_local_mesh(runs):
    """The compressed-wire gate on a 2-ring, probed on rank 0's buffer:
    both processes pick ``rlewire`` on the ``varlen`` schedule, ship the
    stream prefix (one all-to-all with the streams' split sizes) and
    receive what the local mesh does, with equal op and byte counts."""
    gate = _gate_buffers()
    comm = Communicator(device="cpu")
    ct = comm.commit(Subarray(*GATE_TYPE, FLOAT))
    ring = [(0, 1), (1, 0)]
    strats, plan = comm.plan_neighbor([ct], [ring], probe=torch.from_numpy(gate[0]))
    buf = torch.from_numpy(gate.copy())
    comm.neighbor_alltoallv(buf, [ct], [ct], [ring], plan=plan, strategies=strats)
    assert plan.schedule == "varlen" and [s.name for s in strats] == ["rlewire"]
    assert plan.stream_bytes[0] < plan.wire_bytes
    for rank in range(2):
        arrays, res = runs["ranks"][rank]
        np.testing.assert_array_equal(arrays["varlen"], buf[rank].numpy())
        assert res["varlen"]["fingerprint"] == plan.fingerprint
        assert res["varlen"]["stream_bytes"] == list(plan.stream_bytes)
        assert res["varlen"]["counts"] == [comm.wire_ops, comm.wire_payload_bytes]
        assert res["varlen"]["compress"] == [1, plan.wire_bytes, plan.stream_bytes[0]]
    # the patch crossed the ring
    np.testing.assert_array_equal(buf[0, 10:12, 6:8].numpy(), np.full((2, 2), 3.5))
    np.testing.assert_array_equal(buf[1, 10:12, 6:8].numpy(), np.full((2, 2), 2.5))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_prints_the_reference_lines_and_the_local_mesh_interior(runs):
    out = runs["out"]["launcher"]
    for head in ("mode=tempi overlap=False ranks=2 interior=(6, 6, 6) halo-radius=(2, 2, 2)",
                 "program: cycle=single (1 op) steps=2 (2)", "committed datatypes: 52",
                 "wire schedule: ", "time per iteration (1 exchange + 2 stencil applications): ",
                 "stencil applications: 2", "interior checksum: "):
        assert any(line.startswith(head) for line in out.splitlines()), (head, out)
    grid = dims_create(2)
    assert grid == (2, 1, 1)
    comm = Communicator(device="cpu")
    prog = build_halo_program(grid, INTERIOR, comm, steps=2)
    x = torch.from_numpy(np.concatenate([_seed_block(prog.spec, r) for r in range(2)]))
    prog.iteration(x, comm)
    got = np.load(runs["inp"] / "launcher.npy")
    np.testing.assert_array_equal(got, _interiors(prog.spec, x).numpy())
    assert f"interior checksum: {float(got.sum()):.6e}" in out


def test_seeding_is_the_reference_examples():
    spec = HaloSpec(grid=(2, 1, 1), interior=(3, 4, 5), radius=1)
    want = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    got = np.concatenate([_seed_block(spec, r) for r in range(2)])
    np.testing.assert_array_equal(_interiors(spec, got), want)
    assert [dims_create(n) for n in (1, 2, 4, 8, 12)] == [
        (1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (3, 2, 2)]


# ---------------------------------------------------------------------------
# raising paths
# ---------------------------------------------------------------------------

def test_production_saves_the_decisions_on_rank_0_alone(runs):
    for rank, (_, res) in enumerate(runs["ranks"]):
        rows, path = res["production"]
        assert rows == 1 and path == str(runs["inp"] / f"store{rank}" / "decisions.json")
        assert os.path.exists(path) == (rank == 0)


def test_a_plan_that_differs_across_ranks_raises_on_every_rank(runs):
    for _, res in runs["ranks"]:
        assert "the halo program differs across ranks" in res["mismatch"]


def test_a_block_of_the_wrong_shape_raises(runs):
    for _, res in runs["ranks"]:
        assert res["shape"].startswith(f"local has shape {(WORLD,) + SPEC.alloc}")
        assert str((1,) + SPEC.alloc) in res["shape"]


def test_unported_schedules_raise_under_the_process_group(runs):
    """Both are ported; each raises the reference's ValueError on a plan
    without its annotation: ``tiered`` without a topology, ``varlen``
    without streams."""
    for _, res in runs["ranks"]:
        assert set(res["unported"]) == {"varlen", "tiered"}
        assert res["unported"]["tiered"] == "tiered schedule on an unannotated plan"
        assert res["unported"]["varlen"] == "varlen schedule on a stream-unannotated plan"


def test_a_topology_that_differs_across_ranks_raises_on_every_rank(runs):
    for _, res in runs["ranks"]:
        assert "the topology differs across ranks" in res["topo_mismatch"]


def test_tiered_exchange_under_gloo_is_bit_exact(runs):
    """8 processes, 4 a node: the tiered exchange (one bundle of the 4
    node-crossing classes along the representative's permutation, then 3
    intra-node correction hops) equals the local mesh's and the oracle,
    with the same op and byte counts.  Planned with a topology, the
    exact ladder still takes the native ragged collective, and the model
    (no link tables) does not take ``tiered``, on every rank alike."""
    topo = Topology.blocked(WORLD, RANKS_PER_NODE)
    comm = Communicator(device="cpu", topology=topo)
    plan = make_halo_plan(SPEC, comm, schedule_policy="exact")
    wire = reschedule(plan.wire, "tiered")
    assert wire.tier_bundles == ((0, 1, 2, 3),) and wire.inter_messages == 1
    local = from_reference(_blocks(SPEC, runs["g"]), SPEC, device="cpu")
    halo_exchange(local, SPEC, comm, plan=dataclasses.replace(plan, wire=wire))
    oracle = _oracle_blocks(SPEC, runs["g"])
    np.testing.assert_array_equal(local.numpy(), oracle)
    assert [comm.wire_ops, comm.wire_payload_bytes] == [7, wire.issued_bytes]
    for rank, (arrays, res) in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(arrays["x_tiered"], oracle[rank])
        assert res["x_tiered"] == [7, wire.issued_bytes, wire.fingerprint]
        assert res["topo_plan_exact"][0] == "ragged"
        assert res["topo_plan_model"][0] != "tiered"
        for key in ("topo_plan_exact", "topo_plan_model"):
            assert res[key] == runs["ranks"][0][1][key]


def test_launcher_prints_the_topology(runs):
    """``--ranks-per-node 1`` on 2 processes: two nodes, the fingerprint
    in the header line, and the flat run's checksum (no link tables, so
    no schedule moves)."""
    out, flat = runs["out"]["launcher_topo"], runs["out"]["launcher"]
    topo = Topology.blocked(2, 1)
    head = [line for line in out.splitlines() if line.startswith("mode=")]
    assert head and head[0].endswith(f" topo={topo.fingerprint}(2 nodes)")
    checksum = [line for line in flat.splitlines() if line.startswith("interior checksum")]
    assert checksum and checksum[0] in out.splitlines()


def test_nccl_on_the_cpu_and_gloo_on_the_card_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="nccl backend moves cuda tensors"):
        init_process_group("nccl", "cpu", store_path=str(tmp_path / "s"), rank=0, world_size=1)
    with pytest.raises(ValueError, match="gloo backend moves cpu tensors"):
        init_process_group("gloo", "cuda", store_path=str(tmp_path / "s"), rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="RANK and WORLD_SIZE"):
        init_process_group("gloo", "cpu")
    assert not (tmp_path / "s").exists()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        DistributedTransport()


def test_from_reference_takes_one_rank():
    state = np.arange(8 * np.prod(SPEC.alloc), dtype=np.float32)
    state = state.reshape((8 * SPEC.alloc[0],) + SPEC.alloc[1:])
    one = from_reference(state, SPEC, device="cpu", rank=5)
    assert tuple(one.shape) == (1,) + SPEC.alloc
    np.testing.assert_array_equal(one.numpy(), state.reshape((8,) + SPEC.alloc)[5:6])
    with pytest.raises(ValueError, match="not one of"):
        from_reference(state, SPEC, device="cpu", rank=8)
