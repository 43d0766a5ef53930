"""The port's main path as a whole: the 26-neighbour halo exchange plus
the 26-point stencil on 8 ranks of a periodic 2x2x2 grid, on the CPU.

* every cell of every rank after one exchange equals the periodic numpy
  oracle bit-exactly, in every mode, and the modes agree with each other
  (the reference's ``HALO_CODE``);
* under ``schedule_policy="exact"`` with the rows kernel forced, the
  local-mesh transport counts exactly ``plan.wire_bytes`` in 7 wire ops;
* exchange + ``stencil_iterations(steps=2)`` matches the JAX reference
  (``repro.halo``, run in a subprocess on 8 host devices) within the
  reference's own stencil tolerance, 2e-6: XLA may contract the
  multiply-adds, so sums can differ in the last ulp.  The reference is
  planned with ``schedule_policy="exact"`` and rescheduled to
  ``grouped``; its native ``ragged`` schedule does not run on XLA:CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator, FixedPolicy, policy_for_mode
from repro_torch.halo import (
    HaloSpec,
    from_reference,
    halo_exchange,
    make_halo_plan,
    make_halo_step,
    stencil_iterations,
)
from tests._subproc import run_with_devices

GRID = (2, 2, 2)
INTERIORS = {"645": (6, 5, 4), "444": (4, 4, 4)}
MODES = ("baseline", "tempi", "rows", "dma", "xla", "ref")


def _spec(interior):
    return HaloSpec(grid=GRID, interior=interior, radius=2)


def _locals(spec, gvals, fill):
    """Each rank's block of the global field, halos set to ``fill``."""
    r = spec.radius
    nz, ny, nx = spec.interior
    out = np.full((spec.nranks,) + spec.alloc, fill, np.float32)
    for rank in range(spec.nranks):
        cz, cy, cx = spec.coords(rank)
        out[rank, r:r + nz, r:r + ny, r:r + nx] = gvals[
            cz * nz:(cz + 1) * nz, cy * ny:(cy + 1) * ny, cx * nx:(cx + 1) * nx
        ]
    return out


def _global_shape(spec):
    return tuple(g * n for g, n in zip(GRID, spec.interior))


def _oracle(spec, gvals):
    """Every cell of every rank (halos included) as the periodic global
    field has it."""
    r = spec.radius
    gz, gy, gx = gvals.shape
    want = np.empty((spec.nranks,) + spec.alloc, np.float32)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        idx = [
            (np.arange(a) - r + ci * n) % g
            for a, ci, n, g in zip(spec.alloc, c, spec.interior, (gz, gy, gx))
        ]
        want[rank] = gvals[np.ix_(*idx)]
    return want


def _unique_field(spec):
    shape = _global_shape(spec)
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def _random_field(spec, seed):
    return np.random.default_rng(seed).normal(size=_global_shape(spec)).astype(np.float32)


def _exchange(spec, start, mode):
    comm = Communicator(policy=policy_for_mode(mode), device="cpu")
    step = make_halo_step(spec, comm, device="cpu")
    local = from_reference(start, spec, device="cpu")
    out = step(local)
    assert out is local  # in place
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(INTERIORS))
def test_exchange_fills_every_halo_cell(name, mode):
    spec = _spec(INTERIORS[name])
    gvals = _unique_field(spec)
    got = _exchange(spec, _locals(spec, gvals, -1.0), mode)
    np.testing.assert_array_equal(got, _oracle(spec, gvals))


@pytest.mark.parametrize("name", sorted(INTERIORS))
def test_baseline_and_tempi_agree_bit_exactly(name):
    spec = _spec(INTERIORS[name])
    start = _locals(spec, _random_field(spec, 3), -1.0)
    np.testing.assert_array_equal(
        _exchange(spec, start, "baseline"), _exchange(spec, start, "tempi")
    )


@pytest.mark.parametrize("schedule_policy", ["exact", "model"])
def test_transport_counts_exactly_the_planned_bytes(schedule_policy):
    spec = _spec(INTERIORS["645"])
    comm = Communicator(policy=FixedPolicy("rows"), device="cpu")
    plan = make_halo_plan(spec, comm, schedule_policy=schedule_policy)
    local = from_reference(_locals(spec, _unique_field(spec), -1.0), spec, device="cpu")
    halo_exchange(local, spec, comm, plan=plan)
    assert plan.wire.ngroups == 7
    assert plan.wire_bytes == sum(ct.packed_extent() for ct in plan.send_cts)
    assert comm.wire_ops == plan.wire.wire_ops
    assert comm.wire_payload_bytes == plan.wire.issued_bytes
    if schedule_policy == "exact":
        # the local mesh has no native ragged op: the exact ladder is the
        # per-class grouped schedule, one wire op per displacement class
        assert plan.wire.schedule == "grouped"
        assert comm.wire_ops == 7
        assert comm.wire_payload_bytes == plan.wire_bytes
    np.testing.assert_array_equal(local.numpy(), _oracle(spec, _unique_field(spec)))


REFERENCE_CODE = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import Communicator, reschedule
from repro.compat import shard_map
from repro.halo import HaloSpec, halo_exchange, make_halo_plan, stencil_iterations

OUT = {out!r}
mesh = Mesh(np.array(jax.devices()), ("ranks",))
for name, interior in {interiors!r}.items():
    spec = HaloSpec(grid=(2, 2, 2), interior=interior, radius=2)
    start = np.load(f"{{OUT}}/in_{{name}}.npy")
    R, az, ay, ax = start.shape
    comm = Communicator(axis_name="ranks")
    plan = make_halo_plan(spec, comm, schedule_policy="exact")
    plan = dataclasses.replace(plan, wire=reschedule(plan.wire, "grouped"))

    def exchange(local):
        return halo_exchange(local, spec, comm, "ranks", plan=plan)

    def iteration(local):
        return stencil_iterations(exchange(local), spec, steps=2)

    for tag, fn in (("exchange", exchange), ("iteration", iteration)):
        step = jax.jit(shard_map(fn, mesh=mesh, in_specs=P("ranks"),
                                 out_specs=P("ranks"), check_vma=False))
        out = np.asarray(step(jnp.asarray(start.reshape(R * az, ay, ax))))
        np.save(f"{{OUT}}/{{tag}}_{{name}}.npy", out.reshape(R, az, ay, ax))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """Inputs made from a seed, and the JAX reference's exchange and
    exchange + 2 stencil applications on them (one subprocess)."""
    out = tmp_path_factory.mktemp("halo_reference")
    inputs = {}
    for k, (name, interior) in enumerate(sorted(INTERIORS.items())):
        spec = _spec(interior)
        inputs[name] = _locals(spec, _random_field(spec, 7 + k), 0.0)
        np.save(out / f"in_{name}.npy", inputs[name])
    log = run_with_devices(
        REFERENCE_CODE.format(out=str(out), interiors=INTERIORS), ndev=8
    )
    assert "REFERENCE_OK" in log
    return out, inputs


@pytest.mark.parametrize("name", sorted(INTERIORS))
def test_exchange_and_stencil_match_the_jax_reference(reference_run, name):
    out, inputs = reference_run
    spec = _spec(INTERIORS[name])
    step = make_halo_step(spec, device="cpu")
    local = from_reference(inputs[name], spec, device="cpu")
    step(local)
    np.testing.assert_array_equal(local.numpy(), np.load(out / f"exchange_{name}.npy"))
    stencil_iterations(local, spec, steps=2)
    np.testing.assert_allclose(
        local.numpy(), np.load(out / f"iteration_{name}.npy"), rtol=2e-6, atol=2e-6
    )
