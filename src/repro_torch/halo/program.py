"""HaloProgram: communication-avoiding deep-halo stencil schedules.

TEMPI's discipline is that an interposed layer with empirical system
measurements should restructure non-contiguous communication wherever
the model says it wins.  The one-exchange-per-step halo loop leaves one
knob untouched: *how often* to exchange.  A :class:`HaloProgram`
compiles the alternative — exchange a halo of depth ``s * r`` once, then
apply ``s`` stencil steps locally over a shrinking valid region
(:func:`repro_torch.halo.stencil.stencil_cycle`) — and lets
:meth:`repro_torch.comm.perfmodel.PerfModel.price_program` choose ``s``
from the same tables every other selection uses: deeper halos buy fewer
exchanges at the price of more wire bytes per exchange and redundant
ghost-shell compute.  The chosen depth is recorded in the
:class:`~repro_torch.measure.decisions.DecisionCache` as a
``program/s=N`` row keyed by :func:`program_fingerprint`, the
reference's key, so a decisions file pins the depth in either package.

Per iteration: ONE fused exchange at the deep radius (the depth-``s*r``
region types are bigger canonical strided blocks, packed and unpacked
by the same kernels) + ``s`` shrinking-region applications, bit-exact on
the interior against the step-per-exchange loop.  Programs also fuse
heterogeneous cycles (``ops=[op_a, op_b]``): one exchange at depth
``s * cycle_radii(ops)`` hosts ``s`` whole cycle passes.

The state is the local mesh's ``(R, az, ay, ax)`` tensor, or under one
process per rank this rank's ``(1, az, ay, ax)`` block; every step runs
on the card unless the communicator lives on the CPU.  Under one process
per rank every process builds the program from the same tables, and
:func:`build_halo_program` checks through the transport (one
``all_gather`` of the program's key) that every rank holds the same
depth and plan.  Each rank records the ``program/s=N`` decision in its
own cache; only rank 0 writes the decisions file
(``repro_torch.measure.production_communicator``'s ``save``).
"""

from __future__ import annotations

import hashlib
from contextlib import contextmanager
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.comm.api import as_communicator
from repro_torch.comm.perfmodel import ProgramEstimate, StrategyEstimate
from repro_torch.core.datatypes import FLOAT, Named
from repro_torch.device import resolve_device
from repro_torch.halo.exchange import HaloPlan, HaloSpec, halo_exchange, make_halo_plan
from repro_torch.halo.stencil import (
    STENCIL26,
    Ops,
    StencilOp,
    as_ops,
    cycle_halo_radii,
    cycle_radii,
    overlapped_stencil_iteration,
    stencil_cycle,
)

__all__ = [
    "HaloProgram",
    "build_halo_program",
    "make_program_step",
    "program_fingerprint",
    "parse_halo_steps",
    "get_default_halo_steps",
    "set_default_halo_steps",
    "MAX_AUTO_STEPS",
]

#: deepest fusion the auto chooser considers
MAX_AUTO_STEPS = 3

#: process default for ``steps=None`` (``production_communicator``'s
#: ``halo_steps`` lands here)
_DEFAULT_HALO_STEPS: Union[int, str] = "auto"


def parse_halo_steps(value: Union[str, int]) -> Union[int, str]:
    """A ``--halo-steps`` value: ``"auto"`` or a positive int."""
    if value == "auto":
        return "auto"
    steps = int(value)
    if steps < 1:
        raise ValueError(f"--halo-steps must be >= 1 or 'auto', got {value!r}")
    return steps


def get_default_halo_steps() -> Union[int, str]:
    return _DEFAULT_HALO_STEPS


def set_default_halo_steps(steps: Union[int, str]) -> Union[int, str]:
    """Set the process-wide default fusion depth (programs built with
    ``steps=None`` use it)."""
    global _DEFAULT_HALO_STEPS
    _DEFAULT_HALO_STEPS = parse_halo_steps(steps)
    return _DEFAULT_HALO_STEPS


def program_fingerprint(
    grid: Tuple[int, int, int],
    interior: Tuple[int, int, int],
    op: Ops,
    element: Named,
    topology_fingerprint: str = "",
) -> str:
    """Stable content hash of a program's geometry — the DecisionCache
    key that pins ``steps="auto"`` across processes, equal to the
    reference's for the same geometry.

    A single-op program keeps the v1 key; a cycle hashes every op in
    application order under a v2 key (``[a, b] != [b, a]``).  A non-empty
    ``topology_fingerprint`` is appended, so a pin never replays across a
    reshaped mesh.
    """
    ops = as_ops(op)
    if len(ops) == 1:
        key = (
            "haloprogram.v1",
            tuple(grid),
            tuple(interior),
            tuple(ops[0].radii),
            float(ops[0].weight),
            element.name,
            element.size,
        )
    else:
        key = (
            "haloprogram.v2",
            tuple(grid),
            tuple(interior),
            tuple((tuple(o.radii), float(o.weight)) for o in ops),
            element.name,
            element.size,
        )
    if topology_fingerprint:
        key = key + (topology_fingerprint,)
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


def _describe_cycle(ops: Tuple[StencilOp, ...]) -> str:
    """Short human-readable cycle signature for the audit log."""
    return "[" + ",".join(
        f"{'x'.join(map(str, o.radii))}w{o.weight:g}" for o in ops
    ) + "]"


@dataclass(frozen=True)
class HaloProgram:
    """A compiled deep-halo schedule: {exchange at depth
    ``steps * cycle_radii(ops)``, apply the op cycle ``steps`` times
    over the shrinking valid region}.  Build with
    :func:`build_halo_program`."""

    spec: HaloSpec              # deep geometry: radius == steps * cycle_radii
    ops: Tuple[StencilOp, ...]
    steps: int                  # cycle repeats per iteration
    plan: HaloPlan              # the one exchange, at the deep radius
    estimate: ProgramEstimate   # model price that selected (or priced) steps
    candidates: Tuple[ProgramEstimate, ...] = ()  # every depth priced
    pinned: bool = False        # steps came from a pinned Decision
    #: topology fingerprint the program was planned under ("" = flat)
    topology_fingerprint: str = ""

    @property
    def op(self) -> StencilOp:
        """The single op of a one-op cycle (raises on real cycles)."""
        if len(self.ops) != 1:
            raise ValueError(f"program fuses a {len(self.ops)}-op cycle; inspect .ops")
        return self.ops[0]

    @property
    def cycle_len(self) -> int:
        return len(self.ops)

    @property
    def applications(self) -> int:
        """Stencil applications per iteration (``steps * cycle_len``)."""
        return self.steps * len(self.ops)

    @property
    def exchanges_per_step(self) -> float:
        """Exchanges issued per stencil application."""
        return 1.0 / self.applications

    @property
    def exchanges_per_cycle(self) -> float:
        """Exchanges issued per cycle repeat (``1/steps``)."""
        return 1.0 / self.steps

    @cached_property
    def fingerprint(self) -> str:
        return program_fingerprint(
            self.spec.grid, self.spec.interior, self.ops, self.spec.element,
            self.topology_fingerprint,
        )

    def iteration(self, local: torch.Tensor, comm, overlap=False,
                  probe: Optional[dict] = None) -> torch.Tensor:
        """One program iteration, in place: ONE fused exchange + ``steps``
        repeats of the shrinking-region op cycle.  With ``overlap`` the
        exchange hides behind the interior chain: ``True`` (or
        ``"monolithic"``) waits for every class, ``"region"`` computes
        each rim region as its classes land, ``"auto"`` lets the model
        pick (:func:`repro_torch.halo.stencil.overlapped_stencil_iteration`).

        When the communicator carries an active
        :class:`repro_torch.obs.Tracer`, the plain iteration records the
        span hierarchy: ``program_iteration`` hosting the fused
        ``exchange`` (with its pack/wire/unpack phases, through
        :meth:`Communicator.neighbor_alltoallv`) and one ``stencil`` span
        per application, each synchronized at its end; the fused pair that
        ends an odd chain (:func:`repro_torch.halo.stencil.stencil_cycle`)
        is one span with ``applications=2``."""
        if overlap:
            mode = "monolithic" if overlap is True else str(overlap)
            return overlapped_stencil_iteration(
                local, self.spec, comm, steps=self.steps, probe=probe,
                plan=self.plan, op=self.ops, mode=mode,
            )
        comm = as_communicator(comm)
        tracer = comm.tracer
        if tracer is not None and tracer.active:
            return self._traced_iteration(local, comm, tracer)
        local = halo_exchange(local, self.spec, comm, plan=self.plan)
        return stencil_cycle(local, self.spec, self.ops, self.steps)

    def _traced_iteration(self, local: torch.Tensor, comm, tracer) -> torch.Tensor:
        """The plain iteration with spans per phase, synchronized at each
        boundary (an observation path: the spans cost a host
        synchronization each)."""
        from repro_torch.fleet.telemetry import predict_program_phases
        from repro_torch.obs.trace import synchronize

        phases = predict_program_phases(self, comm.model)
        napp = max(self.applications, 1)
        with tracer.span(
            "program_iteration", fingerprint=self.fingerprint,
            strategy=f"program/s={self.steps}", steps=self.steps,
            cycle_len=self.cycle_len, pinned=bool(self.pinned),
            pred=sum(phases.values()),
        ):
            # the exchange span and its phases come from the blocking
            # Communicator path
            local = halo_exchange(local, self.spec, comm, plan=self.plan)
            pred_app = phases.get("stencil", 0.0) / napp

            @contextmanager
            def span(i, applications=1):
                # the fused pair's span holds two applications and says so
                extra = {"applications": applications} if applications > 1 else {}
                with tracer.span("stencil", application=i, op=i % self.cycle_len,
                                 pred=pred_app * applications, **extra):
                    yield
                    synchronize(local)

            # the untraced path's own schedule, one span per launch
            stencil_cycle(local, self.spec, self.ops, self.steps, span=span)
        return local


def _feasible_steps(
    interior: Tuple[int, int, int], ops: Tuple[StencilOp, ...], max_steps: int
) -> List[int]:
    """Repeat counts whose halo (= send-slab depth ``s * cycle_radii``)
    still fits inside the interior in every dimension."""
    cr = cycle_radii(ops)
    return [
        s
        for s in range(1, max_steps + 1)
        if all(s * r <= n for n, r in zip(interior, cr))
    ]


def _price_candidate(
    comm,
    grid: Tuple[int, int, int],
    interior: Tuple[int, int, int],
    ops: Tuple[StencilOp, ...],
    steps: int,
    element: Named,
    schedule_policy: Optional[str],
) -> Tuple[HaloSpec, HaloPlan, ProgramEstimate]:
    """Build the deep geometry + wire plan for one candidate repeat count
    and price the full iteration: member pack/unpack + wire per exchange,
    redundant ghost-shell compute per fused application."""
    spec = HaloSpec(
        grid=grid, interior=interior, radius=cycle_halo_radii(ops, steps), element=element,
    )
    plan = make_halo_plan(spec, comm, schedule_policy=schedule_policy)
    model = comm.model
    t_members = 0.0
    for ct, strat in zip(plan.send_cts, plan.strategies):
        est = model.estimate(ct, 1, strat)
        t_members += est.t_pack + est.t_unpack
    estimate = model.price_program(
        plan.wire,
        interior,
        [o.radii for o in ops],
        [o.nneighbors for o in ops],
        steps,
        element_bytes=element.size,
        t_members=t_members,
    )
    return spec, plan, estimate


def build_halo_program(
    grid: Tuple[int, int, int],
    interior: Tuple[int, int, int],
    comm,
    op: StencilOp = STENCIL26,
    steps: Union[int, str, None] = None,
    element: Named = FLOAT,
    max_steps: int = MAX_AUTO_STEPS,
    schedule_policy: Optional[str] = None,
    ops: Optional[Sequence[StencilOp]] = None,
) -> HaloProgram:
    """Compile a deep-halo program for one rank geometry.

    ``ops`` fuses a heterogeneous cycle applied in order each repeat
    (``op`` is the single-op shorthand, ignored when ``ops`` is given).
    ``steps`` counts cycle repeats: a fixed count, ``"auto"`` (the model
    prices every feasible count and takes the cheapest per stencil
    application), or ``None`` (the process default).  With ``"auto"`` and
    a communicator that carries a decision cache, a recorded
    ``program/s=N`` is pinned, else the choice is recorded.
    ``schedule_policy`` goes to the wire planner (``"exact"`` for the
    byte-exact ladder).
    """
    ops = as_ops(ops if ops is not None else op)
    if steps is None:
        steps = get_default_halo_steps()
    topo = comm.model.topology
    topo_fp = topo.fingerprint if topo is not None else ""
    fp = program_fingerprint(grid, interior, ops, element, topo_fp)
    decisions = comm.model.decisions
    candidates: Tuple[ProgramEstimate, ...] = ()
    pinned = False
    built: Optional[Tuple[HaloSpec, HaloPlan, ProgramEstimate]] = None

    if steps == "auto":
        feasible = _feasible_steps(interior, ops, max_steps)
        if not feasible:
            raise ValueError(
                f"no feasible fusion depth: interior {interior} cannot host "
                f"a depth-{cycle_radii(ops)} halo"
            )
        pin = decisions.lookup(fp, 0, 1, True) if decisions is not None else None
        if (
            pin is not None
            and pin.strategy.startswith("program/s=")
            # a pin recorded under a looser cap must not smuggle in a
            # depth this caller's max_steps/feasibility would refuse
            and int(pin.strategy.split("=", 1)[1]) in feasible
        ):
            steps = int(pin.strategy.split("=", 1)[1])
            pinned = True
        else:
            priced: Dict[int, Tuple[HaloSpec, HaloPlan, ProgramEstimate]] = {
                s: _price_candidate(comm, grid, interior, ops, s, element, schedule_policy)
                for s in feasible
            }
            candidates = tuple(priced[s][2] for s in feasible)
            steps = min(priced, key=lambda s: priced[s][2].per_step)
            built = priced[steps]
            if decisions is not None:
                best = priced[steps][2]
                decisions.record(
                    fp, 0, 1, True,
                    StrategyEstimate(
                        f"program/s={steps}",
                        t_pack=best.t_redundant,
                        t_link=best.t_exchange,
                        t_unpack=0.0,
                        wire_bytes=best.wire_bytes,
                    ),
                    signature=(
                        f"halo program grid={tuple(grid)} "
                        f"interior={tuple(interior)} "
                        f"cycle={_describe_cycle(ops)} "
                        + " ".join(f"s={e.steps}:{e.per_step:.3e}" for e in candidates)
                    ),
                )
    else:
        steps = parse_halo_steps(steps)
        if steps not in _feasible_steps(interior, ops, steps):
            raise ValueError(
                f"interior {interior} cannot host a depth-"
                f"{cycle_halo_radii(ops, steps)} halo "
                "(send slabs exceed the interior)"
            )

    if built is None:
        built = _price_candidate(comm, grid, interior, ops, steps, element, schedule_policy)
    spec, plan, estimate = built
    comm.transport.agree("the topology", topo_fp or "flat")
    comm.transport.agree("the halo program", f"{fp} s={steps} {plan.wire.fingerprint}")
    return HaloProgram(
        spec=spec, ops=ops, steps=steps, plan=plan, estimate=estimate,
        candidates=candidates, pinned=pinned, topology_fingerprint=topo_fp,
    )


def make_program_step(program: HaloProgram, comm, *, device="cuda", overlap=False):
    """A plain callable ``step(local) -> local`` running one program
    iteration on the state in place (the local mesh's
    ``(R, az, ay, ax)``, or this rank's ``(1, az, ay, ax)`` block under
    one process per rank; ``overlap``: a
    bool or an overlap-mode string, see :meth:`HaloProgram.iteration`).
    ``comm`` is the communicator the program was built with; it must live
    on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if comm.device != dev:
        raise ValueError(f"communicator on {comm.device}; step asked for {dev}")

    def step(local: torch.Tensor) -> torch.Tensor:
        return program.iteration(local, comm, overlap=overlap)

    step.program = program
    step.comm = comm
    return step
