"""The port's fleet layer, packed collectives and Interposer against the
JAX reference, on the CPU.

* Telemetry: the same observations give the same ``telemetry.json``,
  byte for byte, and a file written by either package loads in the
  other; the Communicator registers the reference's predictions
  (rel 1e-12) under the reference's keys (the send type, the wire plan,
  ``<plan>/c<g>``) and observes its blocking calls.
* Drift: ``DriftDetector.audit`` on perturbed tables, with telemetry and
  with trace input, gives the reference's report byte for byte;
  ``remeasure_term`` (with ``measured=``) splices the same table and
  clears the same flags; a reduced re-measurement on the CPU replaces
  only its term; the stale-pin demotions drop the reference's rows.
* Bundles: canonical JSON, ``merge`` (both policies, either order) and
  ``diff`` are byte-identical between the packages, files load across,
  and promote / rollback behave as the reference's.
* The CLIs: ``report``, ``stats``, ``diff``, ``merge`` and ``promote``
  print what the reference prints, apart from paths.
* The packed collectives and the ``Interposer``: ``all_gather_packed``,
  ``all_to_all_packed`` and the shim's ``sendrecv`` equal the reference's
  bytes on 8 host devices (and on 3), and under gloo in 3 processes;
  ``wire_ops`` counts as the reference's.
* The ``permute`` fault: a permutation whose sources or destinations
  repeat raises the reference's ``ValueError`` on the local mesh (R = 4)
  and on every rank under gloo (3 processes), which then go on to a
  collective that completes.

The reference runs in one subprocess on 8 host devices, beside the 3
gloo processes, both under a 150 s deadline.
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

import jax.numpy as jnp
import repro.comm.perfmodel as rpm
import repro.fleet as rfleet
import repro.fleet.__main__ as rfleet_cli
from repro.fleet import drift as rdrift
from repro.measure.decisions import Decision as RefDecision
from repro.measure.decisions import DecisionCache as RefDecisionCache
from repro_torch.comm import Communicator, SystemParams
from repro_torch.comm.interposer import Interposer
from repro_torch.core import FLOAT, Vector
from repro_torch.fleet import (
    CONFLICT_POLICIES,
    DecisionBundle,
    DriftDetector,
    DriftReport,
    ExchangeTelemetry,
    RingAggregate,
    demote_stale_compress,
    demote_stale_modes,
    diff_bundles,
    load_bundle,
    merge_bundles,
    predict_class_completions,
    predict_program_iteration,
    predict_program_phases,
    promote,
    remeasure_term,
    rollback,
)
from repro_torch.fleet import __main__ as fleet_cli
from repro_torch.fleet.drift import TERMS
from repro_torch.halo import build_halo_program
from repro_torch.measure import Decision, DecisionCache
from tests._subproc import REPO

#: every spawn or subprocess of this module ends within this many seconds
TIMEOUT_S = 150
GLOO_WORLD = 3
#: per rank: a float32 vector of N_ELEMS; the gathered type and the
#: all-to-all types (one per peer, equal sizes) cut from it
N_ELEMS = 12
GATHER_TYPE = (3, 2, 4)               # Vector(count, blocklength, stride) of FLOAT
SPREAD_STRIDES = tuple(range(2, 10))  # Vector(2, 1, s, FLOAT), 8 bytes each
FAULTS = ([(0, 1), (2, 1)], [(0, 1), (0, 2)])
FAULT_R, FAULT_TYPE = 4, (3, 2, 4)


def _close(a, b):
    return a == pytest.approx(b, rel=1e-12, abs=0.0)


def _src(R, seed=21):
    return np.random.default_rng(seed).standard_normal((R, N_ELEMS)).astype(np.float32)


def _ring(R):
    return [(r, (r + 1) % R) for r in range(R)]


# ---------------------------------------------------------------------------
# the reference on 8 host devices and the gloo world, started together
# ---------------------------------------------------------------------------

REFERENCE = r'''
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.comm.api import Communicator
from repro.comm.interposer import Interposer
from repro.core import FLOAT, Vector

IN = {inp!r}
out = {{}}


def run(R, mode):
    mesh = Mesh(np.array(jax.devices()[:R]), ("ranks",))
    ip = Interposer(mode)
    comm = ip.comm
    ct = comm.commit(Vector(*{gather!r}, FLOAT))
    cts = [comm.commit(Vector(2, 1, s, FLOAT)) for s in {strides!r}[:R]]
    src = jnp.asarray(np.load(f"{{IN}}/src{{R}}.npy").reshape(-1))
    res = {{}}

    def sm(f, nin):
        return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("ranks"),) * nin,
                                 out_specs=P("ranks"), check_vma=False))

    res["gather"] = np.asarray(sm(lambda a: ip.all_gather_packed(a, ct, "ranks"), 1)(src))
    res["spread"] = np.asarray(sm(lambda a: ip.all_to_all_packed(a, cts, "ranks"), 1)(src))
    ring = [(r, (r + 1) % R) for r in range(R)]
    res["sendrecv"] = np.asarray(sm(lambda a, b: ip.sendrecv(a, b, ct, ring, "ranks"), 2)(
        src, jnp.zeros_like(src)))
    stats = ip.stats()
    out[f"{{R}}/{{mode}}"] = {{k: v.reshape(R, -1).tolist() for k, v in res.items()}}
    out[f"{{R}}/{{mode}}/stats"] = {{k: stats[k] for k in ("wire_ops", "committed_types",
                                                        "strategies")}}


for R in (8, {gloo_world}):
    for mode in ("tempi", "baseline"):
        run(R, mode)

# the permute fault: the reference's error for each permutation
mesh = Mesh(np.array(jax.devices()[:{fault_r}]), ("ranks",))
comm = Communicator(axis_name="ranks")
ct = comm.commit(Vector(*{fault_type!r}, FLOAT))
src = jnp.zeros(({fault_r} * 12,), jnp.float32)
errors = []
for perm in {faults!r}:
    f = jax.jit(shard_map(lambda a, b: comm.sendrecv(a, b, ct, perm), mesh=mesh,
                          in_specs=(P("ranks"), P("ranks")), out_specs=P("ranks"),
                          check_vma=False))
    try:
        f(src, src)
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
out["faults"] = errors
json.dump(out, open(f"{{IN}}/reference.json", "w"))
print("REFERENCE_OK")
'''

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import Communicator, DistributedTransport
from repro_torch.comm.interposer import Interposer
from repro_torch.core import FLOAT, Vector
from repro_torch.launch.procgroup import destroy_process_group, init_process_group

rank, world, store, IN = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
C = json.load(open(f"{IN}/config.json"))
init_process_group("gloo", "cpu", store_path=store, rank=rank, world_size=world)
src = torch.from_numpy(np.load(f"{IN}/src{world}.npy")[rank : rank + 1])
res = {}
for mode in ("tempi", "baseline"):
    ip = Interposer(mode, transport=DistributedTransport(None, "cpu"))
    ct = ip.commit(Vector(*C["gather"], FLOAT))
    cts = [ip.commit(Vector(2, 1, s, FLOAT)) for s in C["strides"][:world]]
    ring = [(r, (r + 1) % world) for r in range(world)]
    res[mode] = {
        "gather": ip.all_gather_packed(src, ct).reshape(-1).tolist(),
        "spread": ip.all_to_all_packed(src, cts).reshape(-1).tolist(),
        "sendrecv": ip.sendrecv(src, torch.zeros_like(src), ct, ring).reshape(-1).tolist(),
        "wire_ops": ip.stats()["wire_ops"],
    }
comm = Communicator(transport=DistributedTransport(None, "cpu"))
ct = comm.commit(Vector(*C["fault_type"], FLOAT))
errors = []
for perm in C["faults"]:
    try:
        comm.sendrecv(src, torch.zeros_like(src), ct, perm)
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
res["faults"] = errors
res["fault_wire_ops"] = comm.wire_ops
# nothing was left issued: the group still completes a collective
every = [torch.zeros(1) for _ in range(world)]
dist.all_gather(every, torch.tensor([float(rank)]))
res["after"] = [float(t) for t in every]
json.dump(res, open(f"{IN}/rank{rank}.json", "w"))
destroy_process_group()
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the gloo world, waited on together."""
    inp = tmp_path_factory.mktemp("fleet")
    for R in (8, GLOO_WORLD):
        np.save(inp / f"src{R}.npy", _src(R))
    (inp / "config.json").write_text(json.dumps({
        "gather": GATHER_TYPE, "strides": SPREAD_STRIDES, "faults": FAULTS,
        "fault_type": FAULT_TYPE}))
    (inp / "worker.py").write_text(WORKER)
    env = _env()
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(inp))
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(inp / "worker.py"), str(r), str(GLOO_WORLD), str(inp / "store"),
         str(inp)], env=env, **pipe)) for r in range(GLOO_WORLD)]
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_env.setdefault("JAX_PLATFORMS", "cpu")
    code = REFERENCE.format(inp=str(inp), gather=GATHER_TYPE, strides=SPREAD_STRIDES,
                            gloo_world=GLOO_WORLD, fault_r=FAULT_R, fault_type=FAULT_TYPE,
                            faults=FAULTS)
    procs.append(("reference", subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)], env=ref_env, **pipe)))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"{name} failed (rc={p.returncode})\n{out}\n{err}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"processes still running after {TIMEOUT_S} s") from None
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {
        "ref": json.loads((inp / "reference.json").read_text()),
        "ranks": [json.loads((inp / f"rank{r}.json").read_text()) for r in range(GLOO_WORLD)],
    }


def _local(R, mode):
    """The same calls on the local mesh: per-rank rows and wire ops."""
    ip = Interposer(mode, device="cpu")
    ct = ip.commit(Vector(*GATHER_TYPE, FLOAT))
    cts = [ip.commit(Vector(2, 1, s, FLOAT)) for s in SPREAD_STRIDES[:R]]
    src = torch.from_numpy(_src(R))
    res = {
        "gather": ip.all_gather_packed(src, ct),
        "spread": ip.all_to_all_packed(src, cts),
        "sendrecv": ip.sendrecv(src, torch.zeros_like(src), ct, _ring(R)),
    }
    return {k: v.reshape(R, -1) for k, v in res.items()}, ip.stats()


def _as_bytes(rows, dtype):
    return np.asarray(rows, dtype=dtype).view(np.uint8)


@pytest.mark.parametrize("mode", ["tempi", "baseline"])
@pytest.mark.parametrize("R", [8, GLOO_WORLD])
def test_packed_collectives_and_interposer_match_the_reference(runs, R, mode):
    got, stats = _local(R, mode)
    want = runs["ref"][f"{R}/{mode}"]
    for key in ("gather", "spread"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key], np.uint8)), key
    assert np.array_equal(got["sendrecv"].numpy(), np.asarray(want["sendrecv"], np.float32))
    ref_stats = runs["ref"][f"{R}/{mode}/stats"]
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert ref_stats["wire_ops"] == 3


@pytest.mark.parametrize("mode", ["tempi", "baseline"])
def test_packed_collectives_under_gloo_match_the_local_mesh(runs, mode):
    got, stats = _local(GLOO_WORLD, mode)
    for r, res in enumerate(runs["ranks"]):
        mine = res[mode]
        for key in ("gather", "spread", "sendrecv"):
            want = got[key][r].reshape(-1).tolist()
            assert mine[key] == want, (r, key)
        assert mine["wire_ops"] == stats["wire_ops"] == 3


def test_calibrate_shim_delegates_to_the_measurement_package(tmp_path, monkeypatch, capsys):
    import repro_torch.comm.calibrate as shim
    from repro_torch.measure import bench

    seen = []
    params = SystemParams.from_json(_reference_params().to_json())
    monkeypatch.setattr(shim, "calibrate_params", lambda **kw: seen.append(kw) or params)
    assert shim.measure_pack_table is bench.measure_pack_table
    assert shim.main([str(tmp_path / "p.json"), "--device", "cpu"]) == 0
    assert seen == [{"name": None, "device": torch.device("cpu")}]
    assert "(cpu backend)" in capsys.readouterr().out
    assert rpm.SystemParams.from_json((tmp_path / "p.json").read_text()) == _reference_params()


def test_all_to_all_packed_refuses_unequal_segments():
    comm = Communicator(device="cpu")
    cts = [comm.commit(Vector(2, 1, 3, FLOAT)), comm.commit(Vector(3, 1, 3, FLOAT))]
    with pytest.raises(ValueError, match="equal-size segments"):
        comm.all_to_all_packed(torch.zeros(2, N_ELEMS), cts)
    with pytest.raises(ValueError, match="not a multiple"):
        comm.all_to_all_packed(torch.zeros(2, N_ELEMS), cts[:1] * 3)


@pytest.mark.parametrize("k", range(len(FAULTS)))
def test_permute_fault_raises_the_reference_error_on_the_local_mesh(runs, k):
    want = runs["ref"]["faults"][k]
    assert want == f"ppermute sources and destinations must be unique, got {tuple(FAULTS[k])}."
    comm = Communicator(device="cpu")
    ct = comm.commit(Vector(*FAULT_TYPE, FLOAT))
    src = torch.from_numpy(_src(FAULT_R))
    with pytest.raises(ValueError) as err:
        comm.sendrecv(src, torch.zeros_like(src), ct, FAULTS[k])
    assert str(err.value) == want
    assert comm.wire_ops == 0


def test_permute_fault_raises_on_every_gloo_rank_before_any_op(runs):
    want = runs["ref"]["faults"]
    for r, res in enumerate(runs["ranks"]):
        assert res["faults"] == want, r
        assert res["fault_wire_ops"] == 0
        assert res["after"] == [float(i) for i in range(GLOO_WORLD)]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _observations(tel_cls):
    tel = tel_cls(capacity=4)
    tel.register("fp", 1e-4, "wire/grouped")
    for i in range(6):
        tel.observe("fp", 1e-4 * (1 + 0.1 * i))
    tel.observe("other", 5e-5, predicted=2e-5, strategy="rows")
    tel.register("fp", 4e-4)
    return tel


def test_ring_aggregates_match_the_reference():
    for cap, n in ((4, 10), (100, 100), (3, 2)):
        mine, ref = RingAggregate("k", 1e-4, "s", cap), rfleet.RingAggregate("k", 1e-4, "s", cap)
        for i in range(n):
            mine.observe(float(i))
            ref.observe(float(i))
        assert (mine.count, mine.total_count, mine.mean, mine.p95, mine.ratio) == (
            ref.count, ref.total_count, ref.mean, ref.p95, ref.ratio)
        assert mine.to_dict() == ref.to_dict()


def test_telemetry_files_are_the_reference_format_both_ways(tmp_path):
    mine, ref = _observations(ExchangeTelemetry), _observations(rfleet.ExchangeTelemetry)
    assert mine.to_json() == ref.to_json()
    assert mine.report() == ref.report()
    mine.save(tmp_path / "mine.json")
    ref.save(tmp_path / "ref.json")
    assert rfleet.ExchangeTelemetry.load(tmp_path / "mine.json").to_json() == ref.to_json()
    assert ExchangeTelemetry.load(tmp_path / "ref.json").to_json() == mine.to_json()
    assert len(ExchangeTelemetry.load(tmp_path / "absent.json")) == 0
    (tmp_path / "bad.json").write_text(json.dumps({"format": 999, "aggregates": []}))
    with pytest.raises(ValueError, match="format"):
        ExchangeTelemetry.load(tmp_path / "bad.json")
    with mine.timed("t", predicted=1.0):
        pass
    assert mine.get("t").count == 1


def _ref_comm(ref_params, **kw):
    from repro.comm import api

    return api.Communicator(axis_name="x", params=ref_params, **kw)


@pytest.fixture
def ref_stubs(monkeypatch):
    """Let the reference's eager paths run outside ``shard_map``: its
    collectives become identities (the spans and predictions do not read
    the bytes), and its ladder has no native ragged collective, as the
    local mesh's."""
    import repro.comm.wireplan as rwp
    import repro.compat
    from repro.comm import api

    monkeypatch.setattr(api.lax, "ppermute", lambda x, axis, perm: x)
    monkeypatch.setattr(api.lax, "all_to_all", lambda x, axis, split_axis, concat_axis: x)
    monkeypatch.setattr(api.lax, "axis_index", lambda axis: 0)
    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    rwp.plan_wire.cache_clear()
    yield
    rwp.plan_wire.cache_clear()


def test_sendrecv_feeds_telemetry_under_the_reference_key(ref_stubs):
    from repro.core import FLOAT as REF_FLOAT, Vector as RefVector

    ref_tel, tel = rfleet.ExchangeTelemetry(), ExchangeTelemetry()
    ref_comm = _ref_comm(rpm.TPU_V5E, telemetry=ref_tel)
    comm = Communicator(params=SystemParams.from_json(rpm.TPU_V5E.to_json()), device="cpu",
                        telemetry=tel)
    ref_ct = ref_comm.commit(RefVector(3, 2, 4, REF_FLOAT))
    ct = comm.commit(Vector(3, 2, 4, FLOAT))
    src = torch.from_numpy(_src(8))
    ref_comm.sendrecv(jnp.asarray(src[0].numpy()), jnp.zeros(N_ELEMS, jnp.float32), ref_ct,
                      [(0, 0)])
    comm.sendrecv(src, torch.zeros_like(src), ct, _ring(8))
    agg, ref_agg = tel.get(ct.fingerprint), ref_tel.get(ref_ct.fingerprint)
    assert ct.fingerprint == ref_ct.fingerprint
    assert agg.count == ref_agg.count == 1
    assert agg.strategy == ref_agg.strategy
    assert _close(agg.predicted, ref_agg.predicted)
    assert comm.stats()["telemetry_keys"] == ref_comm.stats()["telemetry_keys"] == 1


@pytest.mark.parametrize("schedule_policy", ["exact", "model"])
def test_plan_neighbor_registers_the_reference_predictions(ref_stubs, schedule_policy):
    import repro.halo as rhalo
    from test_torch_overlap import _specs

    ref_tel, tel = rfleet.ExchangeTelemetry(), ExchangeTelemetry()
    params = SystemParams.from_json(rpm.TPU_V5E.to_json())
    ref_comm = _ref_comm(rpm.TPU_V5E, telemetry=ref_tel, decisions=RefDecisionCache())
    comm = Communicator(params=params, device="cpu", telemetry=tel, decisions=DecisionCache())
    spec, ref_spec = _specs((6, 6, 6), 1)
    from repro_torch.halo import make_halo_plan

    plan = make_halo_plan(spec, comm, schedule_policy=schedule_policy).wire
    ref_plan = rhalo.make_halo_plan(ref_spec, ref_comm, schedule_policy=schedule_policy).wire
    assert plan.fingerprint == ref_plan.fingerprint and plan.schedule == ref_plan.schedule
    assert sorted(tel._by_key) == sorted(ref_tel._by_key)
    assert f"{plan.fingerprint}/c6" in tel
    for key in tel._by_key:
        assert tel.get(key).strategy == ref_tel.get(key).strategy
        assert _close(tel.get(key).predicted, ref_tel.get(key).predicted), key
    assert any(d.fingerprint == plan.fingerprint for d in comm.model.decisions.log)


@pytest.mark.parametrize("table", ["synthetic_stencil", "ci", "h100_measured"])
def test_program_predictions_match_the_reference(ref_stubs, table):
    import repro.halo.program as rprogram
    from test_torch_overlap import param_pair

    ref_params, params = param_pair(table)
    comm = Communicator(params=params, device="cpu", decisions=DecisionCache())
    ref_comm = _ref_comm(ref_params, decisions=RefDecisionCache())
    prog = build_halo_program((2, 2, 2), (8, 8, 8), comm, steps=2, schedule_policy="exact")
    ref_prog = rprogram.build_halo_program((2, 2, 2), (8, 8, 8), ref_comm, steps=2,
                                           schedule_policy="exact")
    got, want = predict_program_phases(prog, comm.model), rfleet.predict_program_phases(
        ref_prog, ref_comm.model)
    assert got.keys() == want.keys()
    assert all(_close(got[k], want[k]) for k in got)
    assert _close(predict_program_iteration(prog, comm.model),
                  rfleet.predict_program_iteration(ref_prog, ref_comm.model))
    assert predict_program_iteration(prog, comm.model) > prog.estimate.total
    got = predict_class_completions(prog, comm.model)
    want = rfleet.predict_class_completions(ref_prog, ref_comm.model)
    assert got.keys() == want.keys() and all(_close(got[k], want[k]) for k in got)


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def _reference_params():
    return dataclasses.replace(
        rpm.TPU_V5E,
        name="ref",
        wire_table=((10.0, 1e-5), (14.0, 2e-5), (18.0, 9e-5)),
        stencil_table=((2.58, 10.0, 5e-6), (2.58, 14.0, 2e-5)),
        copy_table=((10.0, 1e-6), (14.0, 4e-6)),
        pack_table={"rows": ((3.0, 10.0, 2e-6), (3.0, 14.0, 8e-6))},
        unpack_table={"rows": ((3.0, 10.0, 3e-6), (3.0, 14.0, 9e-6))},
        compress_table={"rlewire": ((10.0, 1e-6, 2e-6, 0.1), (14.0, 4e-6, 5e-6, 0.1))},
    )


def _perturbed(ref):
    """The drift scenarios: each term's table off by a factor."""
    return {
        "same": ref,
        "wire": dataclasses.replace(ref, wire_table=tuple((x, 10 * s) for x, s in ref.wire_table)),
        "stencil": dataclasses.replace(
            ref, stencil_table=tuple((a, b, 8 * s) for a, b, s in ref.stencil_table)),
        "pack": dataclasses.replace(ref, pack_table={
            "rows": tuple((a, b, 20 * s) for a, b, s in ref.pack_table["rows"])}),
        "compress": dataclasses.replace(ref, compress_table={
            "rlewire": tuple((a, 9 * b, 9 * c, r) for a, b, c, r in ref.compress_table["rlewire"])}),
    }


ROWS = [
    ("wplan1", 2, 3, True, "wire/grouped", 0.0, 3e-4, 0.0, "exchange", 4096),
    ("prog1", 0, 1, True, "program/s=2", 1e-5, 3e-5, 0.0, "deep halo", 2048),
    ("ct1", 1, 1, True, "rows", 2e-6, 1e-5, 3e-6, "vec", 1024),
    ("ct2", 1, 1, True, "rlewire", 2e-6, 1e-5, 3e-6, "vec stream_bytes=64", 1024),
    ("ovl1", 0, 1, True, "overlap/mode=region", 1e-5, 2e-5, 0.0, "overlap", 0),
    ("vl1", 2, 1, True, "wire/varlen", 0.0, 1e-4, 0.0, "exchange ratio=0.0500", 512),
]


def _decision_pair():
    return DecisionCache([Decision(*r) for r in ROWS]), RefDecisionCache(
        [RefDecision(*r) for r in ROWS])


def _trace_agg(obs_scale, count=4, key="prog1"):
    return {key: {ph: {"count": count, "observed": obs_scale * pred, "predicted": pred,
                       "attributed": 0}
                  for ph, pred in (("pack", 1e-5), ("wire", 2e-5), ("unpack", 1e-5),
                                   ("stencil", 4e-5))}}


def _telemetry_pair(ratio_decay=1.0):
    pair = []
    for cls in (ExchangeTelemetry, rfleet.ExchangeTelemetry):
        tel = cls()
        tel.register("ct1", 1.5e-5, "rows")
        for _ in range(4):
            tel.observe("ct1", 100 * 1.5e-5)
        tel.register("vl1/ratio", 0.05, "compress/ratio")
        for _ in range(8):
            tel.observe("vl1/ratio", 0.05 * ratio_decay)
        pair.append(tel)
    return pair


AUDITS = {
    "tables": {},
    "telemetry": {"telemetry": True},
    "trace": {"trace": _trace_agg(10.0)},
    "trace_short": {"trace": _trace_agg(10.0, count=3)},
    "trace_in_band": {"trace": _trace_agg(1.1)},
    "ratio_decay": {"telemetry": 2.0},
    "overlap": {"overlap_timings": {"ovl1": {"region": 2.0, "monolithic": 1.0, "off": 0.5}}},
}


@pytest.mark.parametrize("audit", sorted(AUDITS))
@pytest.mark.parametrize("perturb", ["same", "wire", "stencil", "pack", "compress"])
def test_drift_reports_are_the_reference_bytes(perturb, audit):
    ref = _reference_params()
    live = _perturbed(ref)[perturb]
    kw = dict(AUDITS[audit])
    ref_kw = dict(kw)
    if "telemetry" in kw:
        decay = 1.0 if kw["telemetry"] is True else kw["telemetry"]
        kw["telemetry"], ref_kw["telemetry"] = _telemetry_pair(decay)
    dc, ref_dc = _decision_pair()
    det, ref_det = DriftDetector(3.0, 4), rdrift.DriftDetector(3.0, 4)
    port_live, port_ref = (SystemParams.from_json(p.to_json()) for p in (live, ref))
    got = det.audit(dc, port_live, reference=port_ref, system="t", **kw)
    want = ref_det.audit(ref_dc, live, reference=ref, system="t", **ref_kw)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert DriftReport.from_json(want.to_json()).to_json() == want.to_json()
    assert rdrift.DriftReport.from_json(got.to_json()).to_json() == got.to_json()
    # demotion drops the reference's rows
    assert demote_stale_modes(dc, got) == rdrift.demote_stale_modes(ref_dc, want)
    assert demote_stale_compress(dc, got) == rdrift.demote_stale_compress(ref_dc, want)
    assert dc.to_json() == ref_dc.to_json()


@pytest.mark.parametrize("term", ["wire", "stencil", "pack_unpack"])
def test_remeasure_term_splices_what_the_reference_splices(term):
    ref = _reference_params()
    field = {"wire": "wire_table", "stencil": "stencil_table", "pack_unpack": "pack_table"}[term]
    live = _perturbed(ref)[{"pack_unpack": "pack"}.get(term, term)]
    measured = {field: getattr(ref, field)}
    fixed = remeasure_term(SystemParams.from_json(live.to_json()), term, measured=measured)
    ref_fixed = rdrift.remeasure_term(live, term, measured=measured)
    assert json.loads(fixed.to_json()) == json.loads(ref_fixed.to_json())
    port_ref = SystemParams.from_json(ref.to_json())
    det = DriftDetector(threshold=3.0)
    dc, ref_dc = _decision_pair()
    assert det.audit(dc, SystemParams.from_json(live.to_json()), reference=port_ref).drifted_count
    assert det.audit(dc, fixed, reference=port_ref).to_json() == rdrift.DriftDetector(
        threshold=3.0).audit(ref_dc, ref_fixed, reference=ref).to_json()
    assert det.audit(dc, fixed, reference=port_ref).drifted_count == 0
    with pytest.raises(ValueError, match="unknown term"):
        remeasure_term(fixed, "latency")
    assert TERMS == rdrift.TERMS


def test_remeasure_term_on_the_cpu_replaces_only_its_table():
    params = SystemParams.from_json(_reference_params().to_json())
    fresh = remeasure_term(params, "stencil", device="cpu", iters=1)
    assert fresh.stencil_table != params.stencil_table
    assert len(fresh.stencil_table) == 4  # 2 op shapes x the 2 reduced sizes
    for f in ("wire_table", "pack_table", "unpack_table", "copy_table", "compress_table"):
        assert getattr(fresh, f) == getattr(params, f)
    with pytest.raises(ValueError, match="threshold"):
        DriftDetector(threshold=1.0)


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

def _row(fp, strategy="rows", total=1e-5, hops=1):
    return (fp, 1, hops, True, strategy, total / 2, total / 4, total / 4, f"sig-{fp}", 64)


def _bundle_pair(rows, kw=None):
    kw = kw or {}
    return (DecisionBundle(DecisionCache([Decision(*r) for r in rows]), **kw),
            rfleet.DecisionBundle(RefDecisionCache([RefDecision(*r) for r in rows]), **kw))


BUNDLES = {
    "a": ([_row("b"), _row("a"), _row("s", "rows", 1e-5)], dict(generation=1, host="a",
                                                                 system="s1")),
    "b": ([_row("c"), _row("s", "dma", 2e-5), _row("t", "dma", 3e-6)],
          dict(generation=2, host="b", system="s1", topology="abcd")),
    "c": ([_row("s", "rows", 1e-6), _row("t", "rows", 3e-6)], dict(generation=2, system="s2")),
}


@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_bundle_json_is_the_reference_bytes_both_ways(name, tmp_path):
    mine, ref = _bundle_pair(*BUNDLES[name])
    assert mine.to_json() == ref.to_json()
    assert mine.summary() == ref.summary()
    mine.save(tmp_path / "mine.json")
    ref.save(tmp_path / "ref.json")
    assert load_bundle(tmp_path / "ref.json").to_json() == ref.to_json()
    assert rfleet.load_bundle(tmp_path / "mine.json").to_json() == mine.to_json()
    # a raw decisions file is wrapped as generation 0 in both packages
    mine.decisions.save(tmp_path / "decisions.json")
    assert load_bundle(tmp_path / "decisions.json").to_json() == rfleet.load_bundle(
        tmp_path / "decisions.json").to_json()


@pytest.mark.parametrize("policy", CONFLICT_POLICIES)
@pytest.mark.parametrize("names", ["ab", "bc", "abc", "cba"])
def test_merge_and_diff_are_the_reference_bytes(policy, names):
    pairs = [_bundle_pair(*BUNDLES[n]) for n in names]
    mine = merge_bundles([p[0] for p in pairs], policy=policy, host="m")
    ref = rfleet.merge_bundles([p[1] for p in pairs], policy=policy, host="m")
    assert mine.to_json() == ref.to_json()
    assert mine.to_json() == merge_bundles([p[0] for p in pairs[::-1]], policy=policy,
                                           host="m").to_json()
    d = json.dumps(diff_bundles(pairs[0][0], mine), sort_keys=True, indent=2)
    assert d == json.dumps(rfleet.diff_bundles(pairs[0][1], ref), sort_keys=True, indent=2)
    assert json.dumps(json.loads(d), sort_keys=True, indent=2) == d
    with pytest.raises(ValueError, match="conflict policy"):
        merge_bundles([pairs[0][0]], policy="coin-flip")


def test_promote_and_rollback_as_the_reference(tmp_path):
    old, _ = _bundle_pair([_row("old")])
    new, _ = _bundle_pair([_row("new")], {"generation": 2})
    live = tmp_path / "decisions.json"
    old.decisions.save(live)
    installed, backup = promote(new, live)
    assert RefDecisionCache.load(installed).log[0].fingerprint == "new"
    assert backup is not None and backup.exists()
    assert rfleet.load_bundle(live.with_name(live.name + ".bundle")).generation == 2
    rollback(live)
    assert DecisionCache.load(live).log[0].fingerprint == "old"
    with pytest.raises(FileNotFoundError):
        rollback(tmp_path / "none.json")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli(main, argv, capsys, root):
    rc = main(argv)
    out = capsys.readouterr().out.replace(str(root), "<root>")
    return rc, out


def _store(root, tel_cls, dc_cls, dec_cls):
    root.mkdir()
    tel = tel_cls()
    tel.register("fp1", 1e-4, "wire/grouped")
    for _ in range(8):
        tel.observe("fp1", 2e-4)
    tel.save(root / "telemetry.json")
    dc_cls([dec_cls(*_row("fp1", "wire/grouped"))]).save(root / "decisions.json")


def test_fleet_cli_prints_what_the_reference_prints(tmp_path, capsys):
    from repro.obs.metrics import MetricsRegistry as RefMetrics
    from repro_torch.obs.metrics import MetricsRegistry

    _store(tmp_path / "p", ExchangeTelemetry, DecisionCache, Decision)
    _store(tmp_path / "r", rfleet.ExchangeTelemetry, RefDecisionCache, RefDecision)
    ref_env = tmp_path / "reference_params.json"
    ref_env.write_text(json.dumps({"format": 6, "system": "t",
                                   "params": json.loads(_reference_params().to_json())}))
    for cls, root in ((MetricsRegistry, "p"), (RefMetrics, "r")):
        m = cls()
        m.set_counter("comm.exchanges", 12)
        m.set_gauge("telemetry.ring_occupancy", 0.5)
        m.save(tmp_path / root / "metrics.json")
    a, b = _bundle_pair(*BUNDLES["a"])
    c, d = _bundle_pair(*BUNDLES["b"])
    for bun, name in ((a, "a"), (b, "ra"), (c, "b"), (d, "rb")):
        bun.save(tmp_path / f"{name}.json")
    cases = [
        (["report", "--store", "{s}"], 0),
        (["report", "--store", "{s}", "--reference", str(ref_env), "--assert-no-drift",
          "--threshold", "1.5", "--drift-report", "{s}/drift.json"], 1),
        (["stats", "--store", "{s}", "--json"], 0),
        (["diff", "{a}", "{b}"], 0),
        (["diff", "{a}", "{b}", "--assert-same"], 1),
        (["merge", "{a}", "{b}", "--out", "{s}/merged.json", "--policy", "lowest-price"], 0),
        (["promote", "{a}", "--live", "{s}/live.json"], 0),
        (["promote", "{s}/merged.json", "--live", "{s}/live.json"], 0),
        (["promote", "--rollback", "--live", "{s}/live.json"], 0),
    ]
    for argv, rc in cases:
        runs = []
        for main, s, a_, b_ in ((fleet_cli.main, "p", "a", "b"),
                                (rfleet_cli.main, "r", "ra", "rb")):
            args = [x.format(s=tmp_path / s, a=tmp_path / f"{a_}.json",
                             b=tmp_path / f"{b_}.json") for x in argv]
            got_rc, out = _cli(main, args, capsys, tmp_path / s)
            runs.append((got_rc, out.replace(str(tmp_path / f"{a_}.json"), "<a>")
                         .replace(str(tmp_path / f"{b_}.json"), "<b>")))
        assert runs[0] == runs[1], argv
        assert runs[0][0] == rc, argv
    assert (tmp_path / "p" / "drift.json").read_text() == (tmp_path / "r" / "drift.json").read_text()
    assert (tmp_path / "p" / "merged.json").read_text() == (tmp_path / "r" / "merged.json").read_text()
