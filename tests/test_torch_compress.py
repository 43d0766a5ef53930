"""The compressed wire (``Int8Wire``, ``RleWire``) and the length-aware
``varlen`` schedule of the port, against ``repro.comm.compress`` and the
reference's planner and exchange, on the CPU.

* The codecs, bit-exact (against the reference's encoders under
  ``jax.jit``, as its exchange runs them: XLA computes the int8 scale's
  division by 127 as a product with its reciprocal, which can differ
  from the eager division in the last bit): run-length capacity wires of all-zero,
  zero-free (stored mode), run-structured and random payloads of every
  length from 0 up; stream prefixes; a stream cut below its runs (it
  decodes to the reference's bytes, not to the payload); ragged stream
  lengths raise.  Int8 wires at ``block_elems`` 256 and None, the legacy
  one-scale wire read by the default instance, a scale count that
  matches neither raises; the batched ``(R, n)`` encode equals the
  reference row by row; blocks holding a NaN or an infinity equal the
  reference's but for its non-canonical NaN bits, which the port fixes.
* ``probe_stream_bytes`` equals the reference's on the compressed-wire
  gate (``Subarray((32,32),(16,16),(4,4),FLOAT)``) and on every halo
  region type.
* ``plan_neighbor(probe=)`` on a 3x3x3 grid at a small interior, planning
  only: the same picks, schedule, stream lengths, fingerprint, prices and
  decisions file as the reference's with its native ragged collective
  switched off (the port's local mesh has none).
* The gate's one-transfer ``varlen`` exchange end to end against the
  reference's (``repro.compat.has_ragged_all_to_all`` patched to False,
  so it takes its per-class branch): bit-exact, 53 of 1,032 bytes.
* The ``int8wire`` and ``rlewire`` halo exchange on a 2x2x2 grid against
  the reference run on 8 host devices (planned ``exact``, rescheduled to
  ``grouped``): bit-exact; ``rlewire`` equals the periodic oracle under
  every schedule; ``int8wire`` keeps the interior and each halo value
  within ``max|block| / 254`` of its block.
* The 27-rank probed ``varlen`` exchange equal to the capacity run, the
  ``tempi`` exchange and the periodic oracle.
* The compress sweep's rows, the store round trip, and
  ``SystemParams.from_reference(compress_table=...)`` priced as the
  reference prices it.
* With the codecs registered, the main path's 256^3 2x2x2 halo plan keeps
  its strategies and fingerprint.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import repro.comm.compress as rc
import repro.compat
import repro.halo as rhalo
from repro.comm import Communicator as RefCommunicator
from repro.comm import FixedPolicy as RefFixedPolicy
from repro.comm import reschedule as ref_reschedule
from repro.compat import shard_map
from repro.core import FLOAT as REF_FLOAT
from repro.core import Subarray as RefSubarray
from repro.core import TypeRegistry as RefTypeRegistry
from repro.core import BYTE as REF_BYTE
from repro.core import Vector as RefVector
from repro.measure.decisions import DecisionCache as RefDecisionCache
from repro_torch.comm import (
    INT8_WIRE,
    RLE_HEADER_BYTES,
    RLE_RUN_BYTES,
    RLE_WIRE,
    Communicator,
    FixedPolicy,
    Int8Wire,
    PerfModel,
    StrategyRegistry,
    SystemParams,
    default_registry,
    reschedule,
)
from repro_torch.comm.api import AUTO, BOUNDING, DMA, REF, ROWS, XLA
from repro_torch.core import BYTE, FLOAT, Subarray, TypeRegistry, Vector
from repro_torch.halo import (
    DIRECTIONS,
    HaloPlan,
    HaloSpec,
    from_reference,
    halo_exchange,
    make_halo_plan,
    make_halo_types,
)
from repro_torch.measure import DecisionCache, ParamsStore, measure_compress_table
from tests._subproc import run_with_devices
from test_torch_program import _blocks, _global, _oracle_blocks


def _np(t):
    return np.asarray(t)


def _nruns(member):
    return int(np.count_nonzero(member[1:] != member[:-1])) + 1 if member.size else 0


def _payloads():
    """Member bytes the run-length layout can get wrong: degenerate run
    counts, runs on the 5-byte record stride, the run-capacity cliff,
    stored mode, and every short length."""
    rng = np.random.RandomState(0)
    n = 1024
    out = {
        "all_zero": np.zeros(n, np.uint8),
        "zero_free": (np.arange(n) % 7 + 1).astype(np.uint8),  # stored
        "alt_short_runs": np.repeat(np.tile(np.array([1, 2], np.uint8), n // 4), 2),
        "random": rng.randint(0, 256, n).astype(np.uint8),
        "run_structured": np.repeat(rng.randint(0, 4, 60), rng.randint(1, 30, 60)).astype(
            np.uint8),
        "empty_tail": np.concatenate([rng.randint(0, 4, 64), np.zeros(960)]).astype(np.uint8),
    }
    cap = np.zeros(n, np.uint8)
    runs = n // RLE_RUN_BYTES
    cap[: runs - 1] = np.arange(runs - 1) % 2 + 1  # exactly the run capacity
    out["at_run_capacity"] = cap
    over = cap.copy()
    over[runs - 1] = 3  # one run more: stored
    out["over_run_capacity"] = over
    for k in range(0, 12):
        out[f"n{k}"] = rng.randint(0, 2, k).astype(np.uint8)
    return out


PAYLOADS = _payloads()

#: an int8 value is within max|block| / 254 of the float it stands for,
#: up to the float32 rounding of the scale, the quotient and the product:
#: at most 509 units of 2^-24 of the bound
ULPS = 2.0 ** -14


# ---------------------------------------------------------------------------
# the run-length codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_rle_capacity_wire_is_the_references(name):
    member = PAYLOADS[name]
    want = _np(rc.RLE_WIRE.encode_wire(jnp.asarray(member)))
    got = RLE_WIRE.encode_wire(torch.from_numpy(member.copy()))
    assert got.shape == (RLE_HEADER_BYTES + member.size,)
    np.testing.assert_array_equal(got.numpy(), want)
    mode = int(got[:4].numpy().view(np.uint32)[0])
    fits = member.size >= RLE_RUN_BYTES and _nruns(member) <= member.size // RLE_RUN_BYTES
    assert mode == int(fits)
    np.testing.assert_array_equal(RLE_WIRE.decode_wire(got, member.size).numpy(), member)
    np.testing.assert_array_equal(
        RLE_WIRE.decode_wire(got, member.size).numpy(),
        _np(rc.RLE_WIRE.decode_wire(jnp.asarray(want), member.size)))


@pytest.mark.parametrize("name", sorted(k for k, v in PAYLOADS.items() if v.size))
def test_rle_stream_prefix_decodes_and_the_probe_is_the_references(name):
    """The live stream is a prefix of the capacity wire; a stored payload
    reports its capacity and never truncates."""
    member = PAYLOADS[name]
    n = member.size
    ct = TypeRegistry().commit(Vector(1, n, n, BYTE))
    ref_ct = RefTypeRegistry().commit(RefVector(1, n, n, REF_BYTE))
    stream = RLE_WIRE.probe_stream_bytes(ct, 1, torch.from_numpy(member.copy()))
    assert stream == rc.RLE_WIRE.probe_stream_bytes(ref_ct, 1, jnp.asarray(member))
    assert stream <= RLE_WIRE.wire_bytes(ct)
    if stream == RLE_WIRE.wire_bytes(ct):
        return
    assert stream == RLE_HEADER_BYTES + RLE_RUN_BYTES * _nruns(member)
    wire = RLE_WIRE.encode_wire(torch.from_numpy(member.copy()))
    np.testing.assert_array_equal(RLE_WIRE.decode_wire(wire[:stream], n).numpy(), member)


@pytest.mark.parametrize("kept", [1, 2, 7, 20])
def test_a_stream_cut_below_its_runs_decodes_to_the_references_bytes(kept):
    """Over budget: the decoder fills past the kept runs with the last
    record's value, as ``jnp.repeat(..., total_repeat_length=n)`` does;
    the bytes are the reference's and not the payload."""
    member = PAYLOADS["run_structured"]
    wire = _np(rc.RLE_WIRE.encode_wire(jnp.asarray(member)))[: RLE_HEADER_BYTES + 5 * kept]
    want = _np(rc.RLE_WIRE.decode_wire(jnp.asarray(wire), member.size))
    got = RLE_WIRE.decode_wire(torch.from_numpy(wire.copy()), member.size).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, member)
    # a stored payload's body read as records: the reference's bytes too
    stored = _np(rc.RLE_WIRE.encode_wire(jnp.asarray(PAYLOADS["random"])))
    cut = stored[: RLE_HEADER_BYTES + 5 * kept]
    np.testing.assert_array_equal(
        RLE_WIRE.decode_wire(torch.from_numpy(cut.copy()), 1024).numpy(),
        _np(rc.RLE_WIRE.decode_wire(jnp.asarray(cut), 1024)))


@pytest.mark.parametrize("length", [4, 11, 12, 57, 108 + 5])
def test_ragged_stream_lengths_raise(length):
    """Neither the capacity (108) nor header + whole run records (or more
    records than the payload holds): both packages raise."""
    wire = RLE_WIRE.encode_wire(torch.zeros(100, dtype=torch.uint8))
    full = torch.cat([wire, torch.zeros(5, dtype=torch.uint8)])
    with pytest.raises(ValueError, match="rle wire"):
        RLE_WIRE.decode_wire(full[:length], 100)
    with pytest.raises(ValueError, match="rle wire"):
        rc.RLE_WIRE.decode_wire(jnp.asarray(full[:length].numpy()), 100)


def test_batched_encode_and_decode_are_the_references_row_by_row():
    rng = np.random.RandomState(5)
    rows = np.stack([PAYLOADS[k][:512] for k in ("all_zero", "random", "run_structured",
                                                "at_run_capacity")])
    floats = (rng.randn(4, 300) * np.array([[1e-3], [1.0], [1e3], [0.0]])).astype(np.float32)
    for codec, ref, member in ((RLE_WIRE, rc.RLE_WIRE, rows),
                               (INT8_WIRE, rc.INT8_WIRE, floats.view(np.uint8))):
        wire = codec.encode_wire(torch.from_numpy(member.copy()))
        back = codec.decode_wire(wire, member.shape[1])
        for r in range(member.shape[0]):
            want = _np(jax.jit(ref.encode_wire)(jnp.asarray(member[r])))
            np.testing.assert_array_equal(wire[r].numpy(), want)
            np.testing.assert_array_equal(
                back[r].numpy(), _np(ref.decode_wire(jnp.asarray(want), member.shape[1])))


# ---------------------------------------------------------------------------
# the int8 codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_elems", [256, None])
@pytest.mark.parametrize("nfloats", [1, 64, 256, 257, 1000, 4096])
def test_int8_wire_is_the_references(block_elems, nfloats):
    rng = np.random.RandomState(nfloats)
    f = (rng.randn(nfloats) * rng.choice([1e-3, 1.0, 1e3], nfloats)).astype(np.float32)
    f[: nfloats // 3] = 0.0
    member = f.view(np.uint8)
    want = _np(jax.jit(rc.Int8Wire(block_elems).encode_wire)(jnp.asarray(member)))
    got = Int8Wire(block_elems).encode_wire(torch.from_numpy(member.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    ct = TypeRegistry().commit(Vector(1, nfloats, nfloats, FLOAT))
    assert got.shape[0] == Int8Wire(block_elems).wire_bytes(ct)
    # the default instance reads both formats (the legacy one-scale wire too)
    back = INT8_WIRE.decode_wire(got, member.size).numpy()
    np.testing.assert_array_equal(
        back, _np(rc.INT8_WIRE.decode_wire(jnp.asarray(want), member.size)))
    out = back.view(np.float32)
    if block_elems is None:
        bound = np.abs(f).max() / 254
    else:
        blocks = np.abs(np.pad(f, (0, -nfloats % 256))).reshape(-1, 256).max(1)
        bound = np.repeat(blocks / 254, 256)[:nfloats]
    assert np.all(np.abs(out - f) <= bound * (1 + ULPS))


@pytest.mark.parametrize("block_elems", [256, None])
def test_int8_wire_of_non_finite_blocks(block_elems):
    """A block holding a NaN or an infinity: its int8s are the
    reference's (all 0), its scale is infinity as in the reference or NaN
    with fixed bits (the reference's NaN keeps the input's payload, so it
    is the port's only for the canonical NaN), and each of its elements
    decodes to those NaN bits where the reference decodes to some NaN."""
    rng = np.random.RandomState(5)
    f = rng.randn(1100).astype(np.float32)
    bits = f.view(np.uint32)
    bits[[3, 300, 600]] = [0x7FC00000, 0xFFFFFFFF, 0x7F800001]  # blocks 0, 1, 2
    f[800], f[801] = np.inf, -np.inf                              # block 3
    member = f.view(np.uint8)
    want = _np(jax.jit(rc.Int8Wire(block_elems).encode_wire)(jnp.asarray(member)))
    got = Int8Wire(block_elems).encode_wire(torch.from_numpy(member.copy())).numpy()
    nscales = 1 if block_elems is None else 5
    np.testing.assert_array_equal(got[4 * nscales:], want[4 * nscales:])
    scales, ref_scales = got[:4 * nscales].view(np.uint32), want[:4 * nscales].view(np.uint32)
    nan = np.isnan(ref_scales.view(np.float32))
    np.testing.assert_array_equal(scales[~nan], ref_scales[~nan])
    assert np.all(scales[nan] == 0x7FC00000)
    if block_elems is not None:
        assert nan.tolist() == [True, True, True, False, False]
        assert ref_scales[0] == 0x7FC00000 and ref_scales[3] == 0x7F800000
        np.testing.assert_array_equal(got, _np(jax.jit(rc.Int8Wire(256).encode_wire)(
            jnp.asarray(np.where(np.isnan(f), np.nan, f).astype(np.float32).view(np.uint8)))))
    back = Int8Wire(block_elems).decode_wire(torch.from_numpy(got), member.size).numpy()
    ref_back = _np(rc.Int8Wire(block_elems).decode_wire(jnp.asarray(want), member.size))
    back, ref_back = back.view(np.uint32), ref_back.view(np.uint32)
    ref_nan = np.isnan(ref_back.view(np.float32))
    assert ref_nan[:1024].all() if block_elems else ref_nan.all()
    np.testing.assert_array_equal(back[~ref_nan], ref_back[~ref_nan])
    assert np.all(back[ref_nan] == 0x7FC00000)


def test_int8_scale_count_that_matches_neither_format_raises():
    f = np.arange(1000, dtype=np.float32)
    wire = INT8_WIRE.encode_wire(torch.from_numpy(f.view(np.uint8).copy()))
    bad = torch.cat([torch.zeros(4, dtype=torch.uint8), wire])  # one scale too many
    with pytest.raises(ValueError, match="scales for 1000 floats"):
        INT8_WIRE.decode_wire(bad, 4000)
    with pytest.raises(ValueError, match="scales for 1000 floats"):
        rc.INT8_WIRE.decode_wire(jnp.asarray(bad.numpy()), 4000)
    with pytest.raises(ValueError, match="block_elems=None"):
        Int8Wire(None).decode_wire(wire, 4000)


def test_codec_flags_and_cost_hooks_are_the_references():
    from test_torch_comm import _param_pair

    assert (RLE_WIRE.name, INT8_WIRE.name) == (rc.RLE_WIRE.name, rc.INT8_WIRE.name)
    assert RLE_WIRE.wire_only and INT8_WIRE.wire_only
    assert RLE_WIRE.selectable and RLE_WIRE.supports_varlen
    assert not INT8_WIRE.selectable and not INT8_WIRE.supports_varlen
    assert {"rlewire", "int8wire"} <= set(default_registry().names())
    ct = TypeRegistry().commit(Subarray((32, 32), (16, 16), (4, 4), FLOAT))
    ref_ct = RefTypeRegistry().commit(RefSubarray((32, 32), (16, 16), (4, 4), REF_FLOAT))
    table = {"rlewire": [[8.0, 1e-6, 2e-6, 0.1], [12.0, 4e-6, 5e-6, 0.1]],
             "int8wire": [[8.0, 3e-6, 1e-6, 0.3]]}
    for tables in (None, table):
        ref_params, params = _param_pair("h100")
        ref_model = RefCommunicator(
            axis_name="x", params=dataclasses.replace(ref_params, compress_table=tables)).model
        model = PerfModel(dataclasses.replace(params, compress_table=tables))
        for codec, ref in ((RLE_WIRE, rc.RLE_WIRE), (INT8_WIRE, rc.INT8_WIRE)):
            assert codec.wire_bytes(ct) == ref.wire_bytes(ref_ct)
            for hook in ("model_pack", "model_unpack"):
                assert getattr(codec, hook)(model, ct, 2) == pytest.approx(
                    getattr(ref, hook)(ref_model, ref_ct, 2), rel=1e-12, abs=0)
    with pytest.raises(TypeError, match="wire-only"):
        RLE_WIRE.unpack(torch.zeros(4), torch.zeros(4), ct)


# ---------------------------------------------------------------------------
# probes and probed planning
# ---------------------------------------------------------------------------

GATE = ((32, 32), (16, 16), (4, 4))


def _gate_src():
    src = np.zeros((32, 32), np.float32)
    src[10:12, 6:8] = 3.0  # a short nonzero patch inside the region
    return src


def _point_field(spec, rank, radius):
    """A global field that is zero but for a ball of seeded values inside
    ``rank``'s block, centred ``radius // 3`` cells inside its +x face
    and cut off at the block, so its +x send region carries a disc and
    every other region of every rank is zero."""
    g = np.zeros(tuple(p * n for p, n in zip(spec.grid, spec.interior)), np.float32)
    n = spec.interior
    lo = [c * k for c, k in zip(spec.coords(rank), n)]
    z, y, x = np.meshgrid(*[np.arange(k) for k in n], indexing="ij")
    centre = (n[0] // 2, n[1] // 2, n[2] - 1 - radius // 3)
    ball = (z - centre[0]) ** 2 + (y - centre[1]) ** 2 + (x - centre[2]) ** 2 <= radius ** 2
    vals = np.random.default_rng(11).normal(size=n).astype(np.float32)
    g[lo[0]:lo[0] + n[0], lo[1]:lo[1] + n[1], lo[2]:lo[2] + n[2]][ball] = vals[ball]
    return g


def test_probe_is_the_references_on_the_gate_and_the_halo_regions():
    src = _gate_src()
    ct = TypeRegistry().commit(Subarray(*GATE, FLOAT))
    ref_ct = RefTypeRegistry().commit(RefSubarray(*GATE, REF_FLOAT))
    got = RLE_WIRE.probe_stream_bytes(ct, 1, torch.from_numpy(src))
    assert got == rc.RLE_WIRE.probe_stream_bytes(ref_ct, 1, jnp.asarray(src)) == 53
    dense = np.random.RandomState(2).randn(32, 32).astype(np.float32)
    assert RLE_WIRE.probe_stream_bytes(ct, 1, torch.from_numpy(dense)) == 1032
    assert ROWS.probe_stream_bytes(ct, 1, torch.from_numpy(src)) == 1024
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    ref_spec = rhalo.HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    block = _blocks(spec, _point_field(spec, 0, 2))[0]
    types = make_halo_types(spec, Communicator(device="cpu"))
    ref_types = rhalo.make_halo_types(ref_spec, RefCommunicator(axis_name="ranks"))
    streams = []
    for d in DIRECTIONS:
        for k in range(2):
            got = RLE_WIRE.probe_stream_bytes(types[d][k], 1, torch.from_numpy(block))
            assert got == rc.RLE_WIRE.probe_stream_bytes(ref_types[d][k], 1,
                                                         jnp.asarray(block))
            streams.append(got)
    assert min(streams) == 13 and max(streams) > 13


def _grid27(interior=(6, 6, 6)):
    spec = HaloSpec(grid=(3, 3, 3), interior=interior, radius=2)
    g = _point_field(spec, 13, 2)
    return spec, g, _blocks(spec, g)


@pytest.fixture
def no_native_ragged(monkeypatch):
    """The reference prices and takes its native ragged collective when
    this JAX has one; XLA:CPU cannot run it and the port's local mesh
    has none.  The reference's plan cache is cleared around the test
    (its key does not hold the answer), so no plan leaks to a later test."""
    import repro.comm.wireplan as rwp

    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    rwp.plan_wire.cache_clear()
    yield
    rwp.plan_wire.cache_clear()


@pytest.mark.parametrize("policy", ["tempi", "rlewire"])
def test_probed_plan_on_27_ranks_is_the_references(no_native_ragged, policy):
    spec, _, local = _grid27()
    ref_spec = rhalo.HaloSpec(grid=(3, 3, 3), interior=spec.interior, radius=2)
    from test_torch_comm import _param_pair

    ref_params, params = _param_pair("h100")
    rec, ref_rec = DecisionCache(), RefDecisionCache()
    kw = {} if policy == "tempi" else {"policy": FixedPolicy(policy)}
    comm = Communicator(params=params, device="cpu", decisions=rec, **kw)
    ref_kw = {} if policy == "tempi" else {"policy": RefFixedPolicy(policy)}
    ref_comm = RefCommunicator(axis_name="ranks", params=ref_params, decisions=ref_rec,
                               **ref_kw)
    types = make_halo_types(spec, comm)
    ref_types = rhalo.make_halo_types(ref_spec, ref_comm)
    probe = local[13]
    strats, plan = comm.plan_neighbor(
        [types[d][0] for d in DIRECTIONS], [spec.perm(d) for d in DIRECTIONS],
        probe=torch.from_numpy(probe))
    ref_strats, ref_plan = ref_comm.plan_neighbor(
        [ref_types[d][0] for d in rhalo.DIRECTIONS],
        [ref_spec.perm(d) for d in rhalo.DIRECTIONS], probe=jnp.asarray(probe))
    assert [s.name for s in strats] == [s.name for s in ref_strats]
    assert "rlewire" in {s.name for s in strats}
    assert plan.schedule == ref_plan.schedule
    assert plan.stream_bytes == ref_plan.stream_bytes and plan.stream_bytes
    assert plan.fingerprint == ref_plan.fingerprint
    assert comm.model.price_exchange(plan).total == pytest.approx(
        ref_comm.model.price_exchange(ref_plan).total, rel=1e-12, abs=0)
    costs = comm.model.price_wire_schedules(plan)
    ref_costs = ref_comm.model.price_wire_schedules(ref_plan, native=False)
    assert list(costs) == list(ref_costs) and "varlen" in costs
    for k in costs:
        assert costs[k] == pytest.approx(ref_costs[k], rel=1e-12, abs=0)
    varlen = reschedule(plan, "varlen")
    assert varlen.fingerprint == ref_reschedule(ref_plan, "varlen").fingerprint
    comm.model.price_exchange(varlen)
    ref_comm.model.price_exchange(ref_reschedule(ref_plan, "varlen"))
    assert rec.to_json() == ref_rec.to_json()
    assert "stream_bytes=" in rec.to_json()


def _ref_gate_exchange(probe_src):
    """The reference's probed gate exchange on one host device."""
    comm = RefCommunicator(axis_name="x")
    ct = comm.commit(RefSubarray(*GATE, REF_FLOAT))
    strats, plan = comm.plan_neighbor([ct], [[(0, 0)]], probe=jnp.asarray(probe_src))
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    fn = jax.jit(shard_map(
        lambda b: comm.neighbor_alltoallv(b, [ct], [ct], [[(0, 0)]], plan=plan,
                                          strategies=strats),
        mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))
    return strats, plan, _np(fn(jnp.asarray(_gate_src()))), comm


def test_the_gate_exchange_is_the_references(no_native_ragged):
    """One transfer to itself: probed selection picks ``rlewire``, the
    model ``varlen``, and 53 of the 1,032 capacity bytes move; the port
    and the reference (its per-class branch) give the same buffer, equal
    to the capacity run's."""
    ref_strats, ref_plan, want, _ = _ref_gate_exchange(_gate_src())
    comm = Communicator(device="cpu")
    ct = comm.commit(Subarray(*GATE, FLOAT))
    strats, plan = comm.plan_neighbor([ct], [[(0, 0)]], probe=torch.from_numpy(_gate_src()))
    assert [s.name for s in strats] == [s.name for s in ref_strats] == ["rlewire"]
    assert plan.schedule == ref_plan.schedule == "varlen"
    assert plan.fingerprint == ref_plan.fingerprint
    assert (plan.stream_bytes, plan.wire_bytes) == (ref_plan.stream_bytes, ref_plan.wire_bytes)
    assert (plan.stream_bytes, plan.wire_bytes) == ((53,), 1032)
    buf = torch.from_numpy(_gate_src()).unsqueeze(0)
    comm.neighbor_alltoallv(buf, [ct], [ct], [[(0, 0)]], plan=plan, strategies=strats)
    np.testing.assert_array_equal(buf[0].numpy(), want)
    assert (comm.wire_ops, comm.wire_payload_bytes) == (1, 53)
    assert comm.wire_class_bytes == {f"{plan.fingerprint}/c0": 53}
    assert (comm.compress_exchanges, comm.compress_capacity_bytes,
            comm.compress_stream_bytes) == (1, 1032, 53)
    cap = torch.from_numpy(_gate_src()).unsqueeze(0)
    comm.neighbor_alltoallv(cap, [ct], [ct], [[(0, 0)]], plan=reschedule(plan, "grouped"),
                            strategies=strats)
    np.testing.assert_array_equal(cap.numpy(), buf.numpy())
    assert comm.compress_exchanges == 1  # the capacity run is not a varlen exchange
    # an incompressible probe does not buy the compressed wire
    dense = np.random.RandomState(2).randn(32, 32).astype(np.float32)
    strats, plan = comm.plan_neighbor([ct], [[(0, 0)]], probe=torch.from_numpy(dense))
    assert plan.schedule != "varlen" and strats[0].name != "rlewire"


@pytest.mark.parametrize("codec", ["rlewire", "int8wire"])
def test_sendrecv_through_a_codec(codec):
    """``isend``/``irecv`` encode and decode too: rank r's region lands
    in rank r+1's buffer (exactly for rlewire)."""
    comm = Communicator(policy=FixedPolicy(codec), device="cpu")
    ct = comm.commit(Subarray(*GATE, FLOAT))
    src = np.stack([_gate_src() * (r + 1) for r in range(3)])
    dst = torch.zeros((3, 32, 32))
    comm.sendrecv(torch.from_numpy(src), dst, ct, [(0, 1), (1, 2), (2, 0)])
    want = np.zeros_like(src)
    want[:, 4:20, 4:20] = np.roll(src, 1, axis=0)[:, 4:20, 4:20]
    if codec == "rlewire":
        np.testing.assert_array_equal(dst.numpy(), want)
        return
    for r in range(3):  # the region is one block of 256 floats
        assert np.abs(dst[r].numpy() - want[r]).max() <= want[r].max() / 254 * (1 + ULPS)
    np.testing.assert_array_equal(dst.numpy() == 0, want == 0)


# ---------------------------------------------------------------------------
# the halo exchange through the codecs
# ---------------------------------------------------------------------------

HALO_INTERIOR = (6, 5, 4)
HALO_CASES = (("rlewire", "random"), ("rlewire", "point"), ("int8wire", "random"))

REFERENCE_CODE = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import Communicator, FixedPolicy, reschedule
from repro.compat import shard_map
from repro.halo import HaloSpec, halo_exchange, make_halo_plan

OUT = {out!r}
mesh = Mesh(np.array(jax.devices()), ("ranks",))
spec = HaloSpec(grid=(2, 2, 2), interior={interior!r}, radius=2)
for strategy, field in {cases!r}:
    start = np.load(f"{{OUT}}/in_{{field}}.npy")
    R, az, ay, ax = start.shape
    comm = Communicator(axis_name="ranks", policy=FixedPolicy(strategy))
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    plan = dataclasses.replace(plan, wire=reschedule(plan.wire, "grouped"))
    step = jax.jit(shard_map(lambda x: halo_exchange(x, spec, comm, "ranks", plan=plan),
                             mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"),
                             check_vma=False))
    out = np.asarray(step(jnp.asarray(start.reshape(R * az, ay, ax))))
    np.save(f"{{OUT}}/out_{{strategy}}_{{field}}.npy", out.reshape(R, az, ay, ax))
print("REFERENCE_OK")
"""


def _halo_fields(spec):
    return {"random": _global(tuple(p * n for p, n in zip(spec.grid, spec.interior)), 21),
            "point": _point_field(spec, 0, 2)}


@pytest.fixture(scope="module")
def reference_halo(tmp_path_factory):
    out = tmp_path_factory.mktemp("compress_halo")
    spec = HaloSpec(grid=(2, 2, 2), interior=HALO_INTERIOR, radius=2)
    for name, g in _halo_fields(spec).items():
        np.save(out / f"in_{name}.npy", _blocks(spec, g))
    log = run_with_devices(REFERENCE_CODE.format(out=str(out), interior=HALO_INTERIOR,
                                                 cases=HALO_CASES), ndev=8)
    assert "REFERENCE_OK" in log
    return out


def _int8_bound(spec, comm, plan, want):
    """Per received float: ``max|block| / 254`` of its quantization block
    in the sender's packed region, laid out as the receive type's bytes."""
    bound = torch.zeros_like(want)
    for send_ct, recv_ct in zip(plan.send_cts, plan.recv_cts):
        member = comm.pack(want, recv_ct).view(torch.float32)  # the true halo values
        nf = member.shape[1]
        pad = torch.nn.functional.pad(member.abs(), (0, -nf % 256))
        per = pad.view(member.shape[0], -1, 256).amax(2) / 254
        b = per.repeat_interleave(256, dim=1)[:, :nf] * (1 + ULPS)
        comm.unpack(bound, b.contiguous().view(torch.uint8), recv_ct)
    return bound


@pytest.mark.parametrize("strategy, field", HALO_CASES)
def test_codec_halo_exchange_is_the_references(reference_halo, strategy, field):
    spec = HaloSpec(grid=(2, 2, 2), interior=HALO_INTERIOR, radius=2)
    g = _halo_fields(spec)[field]
    start = _blocks(spec, g)
    want = _np(np.load(reference_halo / f"out_{strategy}_{field}.npy"))
    comm = Communicator(policy=FixedPolicy(strategy), device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    assert plan.wire.schedule == "grouped"
    assert {s.name for s in plan.strategies} == {strategy}
    oracle = torch.from_numpy(_oracle_blocks(spec, g))
    for sched in ("grouped", "uniform", "ragged"):
        local = from_reference(start, spec, device="cpu")
        halo_exchange(local, spec, comm, plan=dataclasses.replace(
            plan, wire=reschedule(plan.wire, sched)))
        np.testing.assert_array_equal(local.numpy(), want)
    if strategy == "rlewire":
        np.testing.assert_array_equal(want, oracle.numpy())
        wire = RLE_WIRE.encode_wire(comm.pack(torch.from_numpy(start), plan.send_cts[0]))
        modes = set(wire[:, 0].tolist())
        assert modes == ({0} if field == "random" else {1})
        return
    assert plan.wire_bytes == sum(INT8_WIRE.wire_bytes(ct) for ct in plan.send_cts)
    n, r = spec.interior, spec.radius
    np.testing.assert_array_equal(want[:, r:r + n[0], r:r + n[1], r:r + n[2]],
                                  start[:, r:r + n[0], r:r + n[1], r:r + n[2]])
    bound = _int8_bound(spec, comm, plan, oracle)
    assert torch.all((torch.from_numpy(want) - oracle).abs() <= bound)
    assert not np.array_equal(want, oracle.numpy())  # lossy


@pytest.mark.parametrize("policy", ["tempi", "rlewire"])
def test_probed_varlen_exchange_on_27_ranks(policy):
    """Probed on the centre rank, whose +x region carries the point
    source's disc: the ``varlen`` exchange equals the capacity run, the
    uncompressed ``tempi`` exchange and the periodic oracle, and moves
    fewer bytes per rank than the packed extent."""
    spec, g, start = _grid27()
    comm = Communicator(device="cpu", **({} if policy == "tempi"
                                         else {"policy": FixedPolicy(policy)}))
    types = make_halo_types(spec, comm)
    send_cts = tuple(types[d][0] for d in DIRECTIONS)
    recv_cts = tuple(types[d][1] for d in DIRECTIONS)
    perms = tuple(tuple(spec.perm(d)) for d in DIRECTIONS)
    strats, wire = comm.plan_neighbor(send_cts, perms, probe=torch.from_numpy(start[13]))
    packed = sum(ct.size for ct in send_cts)
    assert wire.stream_bytes and sum(wire.stream_bytes) < packed
    plan = HaloPlan(spec, send_cts, recv_cts, perms, strats, reschedule(wire, "varlen"))
    local = from_reference(start, spec, device="cpu")
    halo_exchange(local, spec, comm, plan=plan)
    assert comm.wire_payload_bytes == sum(wire.stream_bytes) == plan.wire.issued_bytes
    assert comm.wire_ops == 26
    capacity = from_reference(start, spec, device="cpu")
    halo_exchange(capacity, spec, comm, plan=dataclasses.replace(
        plan, wire=reschedule(wire, "grouped")))
    tempi = from_reference(start, spec, device="cpu")
    halo_exchange(tempi, spec, Communicator(device="cpu"))
    np.testing.assert_array_equal(local.numpy(), capacity.numpy())
    np.testing.assert_array_equal(local.numpy(), tempi.numpy())
    np.testing.assert_array_equal(local.numpy(), _oracle_blocks(spec, g))


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def test_compress_sweep_rows_and_the_store_round_trip(tmp_path):
    from repro.measure.bench import measure_compress_table as ref_sweep

    totals = (1 << 10, 1 << 12)
    table = measure_compress_table(total_bytes=totals, iters=1, ranks=2, device="cpu")
    want = ref_sweep(total_bytes=totals, iters=1)
    assert list(table) == list(want) == ["rlewire", "int8wire"]
    for name, rows in table.items():
        assert [(r[0], r[3]) for r in rows] == [(r[0], r[3]) for r in want[name]]
        assert all(r[1] > 0 and r[2] > 0 for r in rows)
    assert all(r[3] < 0.5 for r in table["rlewire"])
    params = SystemParams(name="x", compress_table=table)
    store = ParamsStore(tmp_path, ranks=2, device="cpu")
    back = ParamsStore.read_envelope(store.save(params))
    assert back == params and back.compress_table == params.compress_table
    model = PerfModel(back)
    enc, dec = model.measured_compress("rlewire", 1 << 11)
    assert min(r[1] for r in table["rlewire"]) <= enc <= max(r[1] for r in table["rlewire"])
    assert model.measured_compress("int8wire", 1 << 10) == pytest.approx(
        table["int8wire"][0][1:3])
    assert model.measured_compress("bounding", 1 << 10) is None


def test_from_reference_prices_the_compress_table_as_the_reference_does():
    import repro.comm.perfmodel as rpm

    table = {"rlewire": [[10.0, 1e-6, 2e-6, 0.1], [20.0, 1e-3, 3e-3, 0.1]],
             "int8wire": [[10.0, 3e-6, 1e-6, 0.3], [16.0, 9e-6, 4e-6, 0.3]]}
    p = SystemParams.from_reference(name="x", compress_table=table)
    ref = rpm.SystemParams(name="x", compress_table=table)
    assert p.compress_table == ref.compress_table
    ref_model = rpm.PerfModel(ref)
    for name in table:
        for nbytes in (1, 1000, 1 << 14, 1 << 18, 1 << 22):
            assert PerfModel(p).measured_compress(name, nbytes) == pytest.approx(
                ref_model.measured_compress(name, nbytes), rel=1e-12, abs=0)


def test_the_main_path_plan_keeps_its_strategies_and_fingerprint():
    """Registering the codecs (``rlewire`` is selectable) changes no pick
    of the full-width 256^3 2x2x2 halo plan under the analytic H100
    table: planning only, no buffers."""
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    plan = make_halo_plan(spec, Communicator(device="cpu"))
    base = StrategyRegistry((ROWS, DMA, XLA, REF, AUTO, BOUNDING))
    without = make_halo_plan(spec, Communicator(device="cpu", strategies=base))
    pinned = "d9ff8ce4369e9497"  # the plan before the codecs were registered
    assert plan.wire.fingerprint == without.wire.fingerprint == pinned
    assert plan.wire.schedule == "uniform"
    names = [s.name for s in plan.strategies]
    assert names == [s.name for s in without.strategies]
    assert sorted(set(names)) == ["dma", "rows"] and names.count("dma") == 10

@pytest.mark.parametrize("rows", [1, 3])
def test_pack_ragged_and_unpack_ragged_are_their_long_names(rows):
    """The reference's aliases: no encoder, no decoder."""
    from repro_torch.kernels.pack import pack_compress_ragged, pack_ragged
    from repro_torch.kernels.unpack import decode_unpack_ragged, unpack_ragged

    gen = torch.Generator().manual_seed(rows)
    buf = torch.randint(0, 256, (rows, 64), dtype=torch.uint8, generator=gen)
    spans = [(0, 5, 40), (5, 16, 3), (21, 7, 20)]  # (wire offset, nbytes, source byte)

    def packer(src):
        return lambda b, out: out.copy_(b[:, src:src + out.shape[1]])

    def unpacker(dst_at):
        def unpack(dst, part):
            dst[:, dst_at:dst_at + part.shape[1]] = part
        return unpack

    wire = pack_ragged(buf, [(o, n, packer(src)) for o, n, src in spans], 28)
    want = pack_compress_ragged(buf, [(o, n, packer(src), None) for o, n, src in spans], 28)
    assert torch.equal(wire, want)
    assert torch.equal(wire[:, 5:21], buf[:, 3:19])
    leaves = [(o, n, unpacker(src)) for o, n, src in spans]
    got = unpack_ragged(torch.zeros_like(buf), wire, leaves)
    ref = decode_unpack_ragged(torch.zeros_like(buf), wire,
                               [(o, n, None, f) for o, n, f in leaves])
    assert torch.equal(got, ref)
    for o, n, src in spans:
        assert torch.equal(got[:, src:src + n], buf[:, src:src + n])
