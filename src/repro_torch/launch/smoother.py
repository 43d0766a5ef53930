"""In-launch diffusion-style smoother over the data axis.

The port of the reference's ``repro.launch.smoother``: a 3D scalar field
split over R ranks along its leading (slow) dimension, smoothed by a
stencil cycle compiled into ONE fused deep-halo program, so the
production communicator's tables price the fusion depth, the choice
lands in the job's decisions file as a ``program/s=N`` row, and a rerun
pins it.  The serve driver runs it once at deployment startup; CI runs
it one step and asserts the decision row exists.

The ranks are the local mesh's: all R blocks in one ``(R, az, ay, ax)``
tensor on one device (the card unless ``device="cpu"``), R = 8 by
default (the rank count the model's tables are measured for).  Each
iteration is one exchange through the port's pack/unpack kernels plus
``steps`` repeats of the cycle.

Cycles:

``smooth``
    the paper's 26-point op applied each repeat.
``predictor-corrector``
    a two-op cycle: a far-reaching predictor (radii ``(2, 1, 1)``,
    deeper along the sharded axis) followed by a local corrector (the
    26-point op at a lighter weight).

    python -m repro_torch.launch.smoother --iters 1 --halo-steps auto \\
        --comm-cache /tmp/ci_store --assert-decision [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.comm.api import Communicator, as_communicator
from repro_torch.halo.program import HaloProgram, build_halo_program, make_program_step
from repro_torch.halo.stencil import STENCIL26, StencilOp
from repro_torch.measure.bench import RANKS

__all__ = ["CYCLES", "SmootherReport", "main", "run_smoother", "smoother_cycle"]

#: the in-launch cycles by name (argparse choices on every driver)
CYCLES: Tuple[str, ...] = ("smooth", "predictor-corrector")

OVERLAPS = ("off", "monolithic", "region", "auto")


def smoother_cycle(name: str) -> Tuple[StencilOp, ...]:
    """The op cycle a ``--smoother-cycle`` name denotes."""
    if name == "smooth":
        return (STENCIL26,)
    if name == "predictor-corrector":
        return (StencilOp((2, 1, 1), weight=0.5), StencilOp((1, 1, 1), weight=0.25))
    raise ValueError(f"unknown smoother cycle {name!r}; expected one of {CYCLES}")


@dataclass(frozen=True)
class SmootherReport:
    """What one smoother run did: the launch drivers print it and the CI
    step asserts on it."""

    program: HaloProgram
    iterations: int
    checksum: float          # interior sum after the run (reproducibility probe)
    decision_recorded: bool  # a program/s=N row exists in the decisions
    #: the ranks' final (R, az, ay, ax) blocks, kept on request (``keep_state``)
    state: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)

    @property
    def summary(self) -> str:
        p = self.program
        return (
            f"smoother: cycle_len={p.cycle_len} steps={p.steps}"
            f"{' (pinned)' if p.pinned else ''} "
            f"applications={self.iterations * p.applications} "
            f"exchanges/cycle={p.exchanges_per_cycle:.2f} "
            f"wire={p.plan.wire.schedule}/{p.plan.wire.issued_bytes}B "
            f"checksum={self.checksum:.6e}"
        )


@contextmanager
def _probes_detached(comm: Communicator):
    """Run the step as one timed unit: the communicator's own per-call
    telemetry and spans (which synchronize inside the iteration) are
    detached meanwhile, and the launch loop records the iteration
    instead, as the reference's compiled step is observed."""
    tel, tr = comm.telemetry, comm.tracer
    comm.telemetry = comm.tracer = None
    try:
        yield
    finally:
        comm.telemetry, comm.tracer = tel, tr


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def run_smoother(
    comm=None,
    iters: int = 1,
    interior: Tuple[int, int, int] = (8, 8, 8),
    cycle: str = "predictor-corrector",
    halo_steps: Union[int, str, None] = None,
    seed: int = 0,
    ranks: Optional[int] = None,
    overlap: str = "off",
    device=None,
    keep_state: bool = False,
) -> SmootherReport:
    """Smooth a periodic 3D field split over ``ranks`` (default: 8, the
    local mesh's R) along its leading dimension with one fused deep-halo
    program on the grid ``(R, 1, 1)``.

    ``comm``: the communicator (``None`` makes a plain one on ``device``,
    the card unless ``device="cpu"``); ``device`` defaults to the
    communicator's.  ``halo_steps=None`` resolves through the process
    default (``production_communicator(halo_steps=...)``); with
    ``"auto"`` the depth is priced on the communicator's tables and
    recorded/pinned in its decisions cache.  ``overlap``: ``"off"`` (the
    plain exchange-then-cycle iteration), ``"monolithic"``, ``"region"``
    or ``"auto"``; all are bit-identical.

    The interiors are seeded as the reference seeds them
    (``default_rng(seed).normal(size=(R, nz, ny, nx))``), so the checksum
    compares with the reference's.  With telemetry or a tracer on the
    communicator, each iteration is synchronized and timed as a whole:
    observed against the program's prediction, and recorded as an
    attributed span tree (per delta class under overlap).  ``keep_state``
    returns the final blocks in the report."""
    if overlap not in OVERLAPS:
        raise ValueError(
            f"unknown overlap {overlap!r}; expected off, monolithic, region or auto")
    if comm is None:
        comm = Communicator(device="cuda" if device is None else device)
    comm = as_communicator(comm)
    dev = comm.device if device is None else device
    R = int(ranks) if ranks is not None else RANKS
    ops = smoother_cycle(cycle)
    program = build_halo_program((R, 1, 1), interior, comm, ops=ops, steps=halo_steps)
    step = make_program_step(program, comm, device=dev,
                             overlap=False if overlap == "off" else overlap)

    nz, ny, nx = interior
    rz, ry, rx = program.spec.radii
    az, ay, ax = program.spec.alloc
    rng = np.random.default_rng(seed)
    state = np.zeros((R, az, ay, ax), np.float32)
    state[:, rz:rz + nz, ry:ry + ny, rx:rx + nx] = rng.normal(
        size=(R, nz, ny, nx)).astype(np.float32)
    x = torch.from_numpy(state).to(comm.device)

    telemetry = comm.telemetry
    tracer = comm.tracer
    if tracer is not None and not tracer.enabled:
        tracer = None
    if telemetry is None and tracer is None:
        for _ in range(iters):
            x = step(x)
    else:
        from repro_torch.fleet.telemetry import predict_program_phases
        from repro_torch.obs.trace import attribute_program_iteration

        phases = predict_program_phases(program, comm.model)
        if telemetry is not None:
            telemetry.register(program.fingerprint, sum(phases.values()),
                               f"program/s={program.steps}")
        # under overlap the wire span is attributed across the delta
        # classes in the model's predicted completion profile
        class_pred: Tuple[float, ...] = ()
        if overlap != "off" and tracer is not None:
            class_pred = comm.model.price_class_completions(program.plan.wire)
        with _probes_detached(comm):
            if x.device.type == "cuda":
                # a first call builds and loads the kernels: run it on a
                # copy so build time never pollutes the samples
                step(x.clone())
            _sync(x)
            for i in range(iters):
                t0 = time.perf_counter()
                x = step(x)
                _sync(x)
                dt = time.perf_counter() - t0
                if telemetry is not None:
                    telemetry.observe(program.fingerprint, dt)
                if tracer is not None:
                    attribute_program_iteration(tracer, program, t0, dt, phases, iteration=i,
                                                class_pred=class_pred)
    out = x.cpu().numpy()
    checksum = float(out[:, rz:rz + nz, ry:ry + ny, rx:rx + nx].sum())
    decisions = comm.model.decisions
    recorded = bool(
        decisions is not None
        and any(d.fingerprint == program.fingerprint for d in decisions.program_rows())
    )
    return SmootherReport(program=program, iterations=iters, checksum=checksum,
                          decision_recorded=recorded, state=x if keep_state else None)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.smoother",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--interior", type=int, default=8, help="interior cube side per rank")
    ap.add_argument("--cycle", default="predictor-corrector", choices=CYCLES)
    ap.add_argument("--halo-steps", default="auto", metavar="auto|N")
    ap.add_argument("--overlap", default="off", choices=OVERLAPS,
                    help="exchange/compute overlap: off, monolithic (one wait), region "
                         "(per-delta-class drains feed the core/rim scheduler), or auto "
                         "(model-priced, pinned as an overlap/mode=... decision)")
    ap.add_argument("--comm-cache", default=None, metavar="DIR",
                    help="measure-store root for the production communicator (calibrated "
                         "params + decisions file; decisions are saved back)")
    ap.add_argument("--assert-decision", action="store_true",
                    help="exit 1 unless a program/s=N decision row was recorded (or pinned) "
                         "for this program: the CI gate on the --halo-steps seam")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach the runtime exchange probe: per-iteration wall time vs the "
                         "model's prediction, persisted to telemetry.json in the store")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record hierarchical spans and export a Chrome-trace JSON here "
                         "(python -m repro_torch.obs summary|validate PATH)")
    ap.add_argument("--drift-report", default=None, metavar="FILE",
                    help="write a DriftReport JSON after the run (implies --telemetry)")
    ap.add_argument("--drift-reference", default=None, metavar="ENVELOPE",
                    help="reference params envelope for the drift audit (default: "
                         "self-audit on telemetry only)")
    ap.add_argument("--assert-no-drift", action="store_true",
                    help="exit 1 when the drift audit flags any decision: the CI drift gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks' blocks live (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from repro_torch.halo.program import parse_halo_steps
    from repro_torch.measure.production import production_communicator

    halo_steps = parse_halo_steps(args.halo_steps)
    want_telemetry = bool(args.telemetry or args.drift_report or args.assert_no_drift)
    comm, save_decisions = production_communicator(
        args.comm_cache, device=args.device, halo_steps=halo_steps,
        telemetry=want_telemetry or None, tracer=bool(args.trace) or None,
    )
    n = args.interior
    report = run_smoother(comm, iters=args.iters, interior=(n, n, n), cycle=args.cycle,
                          overlap=args.overlap)
    print(report.summary)
    if args.trace:
        from repro_torch.obs.export import save_chrome_trace

        path = save_chrome_trace(comm.tracer, args.trace)
        print(f"trace ({len(comm.tracer)} spans) -> {path}")
    for d in comm.model.decisions.program_rows():
        print(f"decision: {d.strategy} fp={d.fingerprint} {d.signature}")
    path = save_decisions()
    print(f"decisions -> {path}")
    if want_telemetry:
        print(comm.telemetry.report())
    if args.drift_report or args.assert_no_drift:
        from repro_torch.fleet.drift import DriftDetector
        from repro_torch.measure.store import ParamsStore

        reference = (ParamsStore.read_envelope(args.drift_reference)
                     if args.drift_reference else None)
        if args.drift_reference and reference is None:
            raise SystemExit(f"unreadable reference envelope {args.drift_reference}")
        trace_agg = comm.tracer.phase_aggregates() if args.trace else None
        drift = DriftDetector().audit(
            comm.model.decisions, comm.model.params, reference=reference,
            telemetry=comm.telemetry, system="smoother", trace=trace_agg,
        )
        print(drift.summary())
        if args.drift_report:
            print(f"drift report -> {drift.save(args.drift_report)}")
        if args.assert_no_drift and drift.drifted_count:
            raise SystemExit(f"DRIFT: {drift.drifted_count} decision(s) out of band")
    if args.assert_decision:
        if not (report.decision_recorded or report.program.pinned):
            raise SystemExit(
                "no program/s=N decision row recorded for the smoother program: the "
                "--halo-steps auto seam is broken")
        print("SMOOTHER_DECISION_OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
