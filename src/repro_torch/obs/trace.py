"""Structured tracing: hierarchical spans over the exchange stack.

The telemetry rings (:mod:`repro_torch.fleet.telemetry`) answer "is this
decision's *total* wall time tracking the model?" — one scalar per
decision key.  TEMPI's empirical claim is finer: the latency of a
non-contiguous exchange decomposes into pack / wire / unpack terms the
model prices *separately*, and the terms drift independently.  This
module records that decomposition as it happens:

* :class:`Span` — one timed region with free-form attributes.  The
  hierarchy mirrors the execution structure::

      program_iteration            (one deep-halo iteration)
        exchange                   (the fused collective, decision-keyed)
          plan                     (host-side WirePlan construction)
          pack / wire / unpack     (the paper's three phases)
            wire_class × classes   (per-delta-class completion)
        stencil × applications     (per-application compute)

  Every ``exchange`` span carries the decision signature: the
  fingerprint the :class:`~repro_torch.measure.decisions.DecisionCache`
  keys on, the chosen strategy/schedule, ``wire_bytes``, and — for
  deep-halo programs — the fusion depth ``s=N``.  Phase spans carry the
  model's predicted seconds (``pred``), so an exported trace joins
  observed against predicted without the model in hand.

* :class:`Tracer` — the per-process recorder.  It is guarded: a
  ``perf_counter`` pair around work that is being *captured* into a CUDA
  graph measures the capture, not the work, so :meth:`Tracer.span`
  records nothing while the current stream is capturing
  (``torch.cuda.is_current_stream_capturing()``, asked only once CUDA is
  initialized).  The eager paths that record synchronize the buffer's
  device at each span boundary; an iteration timed as a whole (a replayed
  graph, a launch loop) is recorded after the fact by
  :func:`attribute_program_iteration`, which splits the observed time
  across phases in the model's predicted proportions and marks the
  children ``attributed=True``.

Span times are ``time.perf_counter`` seconds on the host clock.  Export
to Chrome-trace JSON / text flamecharts lives in
:mod:`repro_torch.obs.export`; ``python -m repro_torch.obs`` is the CLI.

* :func:`region` — a ``tempi.<name>`` range on the profiler's timeline,
  always on: every recorded span opens one, and the untraced exchange
  opens one per phase (``exchange``, ``prep``, ``pack``, ``wire``, one
  ``unpack`` per drained class, ``stencil``, ``splice`` around the copy
  that closes an odd chain of applications, and in the overlapped
  iteration ``interior`` and ``shell``).  It is a host operation of
  ``torch.profiler`` (a ``cpu_op``, not a ``user_annotation``), so a
  profile charges the device's idle gaps to the phase the host was in and
  no device-side event carries its name.  With no profiler running it
  costs about a microsecond and synchronizes nothing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import torch

__all__ = [
    "TRACE_FORMAT",
    "PHASES",
    "DEFAULT_MAX_SPANS",
    "Span",
    "Tracer",
    "attribute_program_iteration",
    "region",
    "synchronize",
]

#: bump when the exported span schema changes incompatibly (the
#: reference's schema: traces load in either package)
TRACE_FORMAT = 1

#: the phase span names drift attribution understands (module order is
#: the execution order inside an exchange)
PHASES = ("pack", "wire", "unpack", "stencil")

#: span-count cap — a million-iteration job must not grow an unbounded
#: trace; past the cap spans are dropped and counted, never an error
DEFAULT_MAX_SPANS = 200_000


try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # a torch without the fast record function
    _RecordFunctionFast = None


def region(name: str):
    """A ``tempi.<name>`` range on ``torch.profiler``'s host timeline
    around the ``with`` body: a host operation that records nothing when
    no profiler runs, and a ``nullcontext`` where torch lacks
    ``_RecordFunctionFast``."""
    if _RecordFunctionFast is None:
        return nullcontext()
    return _RecordFunctionFast("tempi." + name)


def _capturing() -> bool:
    """True while the current CUDA stream is capturing a graph.  Without
    an initialized CUDA context nothing can be capturing."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def synchronize(t: torch.Tensor) -> None:
    """Block the host until the work on ``t``'s device is done (on the
    card every stream of the device, the communicator's side stream
    included); a no-op for a host tensor.  The port's counterpart of the
    reference's ``block_until_ready`` at a span boundary."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass(slots=True)
class Span:
    """One recorded region.  ``start`` is ``perf_counter`` seconds (the
    export is relative to the earliest span); ``attrs`` is free-form but
    ``exchange`` spans carry the decision signature and phase spans the
    model's predicted seconds under ``pred``."""

    name: str
    start: float
    duration: float
    span_id: int
    parent_id: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict)


class Tracer:
    """Low-overhead hierarchical span recorder (process-local).

    Attach to a :class:`~repro_torch.comm.api.Communicator`
    (``tracer=...``) or request one from
    ``production_communicator(tracer=True)``.
    """

    def __init__(self, enabled: bool = True, max_spans: int = DEFAULT_MAX_SPANS):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.dropped = 0
        self._spans: List[Span] = []
        self._stack: List[int] = []
        self._next_id = 0

    # -- state -----------------------------------------------------------
    @property
    def active(self) -> bool:
        """Whether :meth:`span` would record right now: enabled AND the
        current stream is not capturing a CUDA graph (the guard)."""
        return self.enabled and not _capturing()

    @property
    def spans(self) -> List[Span]:
        return self._spans

    def __len__(self) -> int:
        return len(self._spans)

    def clear(self) -> None:
        self._spans.clear()
        self._stack.clear()
        self.dropped = 0
        self._next_id = 0

    # -- recording -------------------------------------------------------
    def _alloc(self, name: str, start: float, duration: float,
               parent_id: Optional[int], attrs: Dict[str, object]) -> Optional[Span]:
        spans = self._spans
        if len(spans) >= self.max_spans:
            self.dropped += 1
            return None
        sp = Span(name, start, duration, self._next_id, parent_id, attrs)
        self._next_id += 1
        spans.append(sp)
        return sp

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Optional[Span]]:
        """Record a timed region.  Yields the :class:`Span` (mutate
        ``.attrs`` freely before exit) — or ``None`` when guarded off
        (capturing, disabled, or at the span cap), in which case nothing
        is recorded and the body runs untouched.

        The caller owns synchronization: block (:func:`synchronize`)
        before exit or the span under-reports asynchronous launches.  A
        recorded span also opens :func:`region` ``(name)`` around the
        body, so it sits on any ``torch.profiler`` trace's timeline.
        """
        if not self.active:
            yield None
            return
        parent = self._stack[-1] if self._stack else None
        sp = self._alloc(name, time.perf_counter(), 0.0, parent, attrs)
        if sp is None:
            yield None
            return
        self._stack.append(sp.span_id)
        try:
            with region(name):
                yield sp
        finally:
            sp.duration = time.perf_counter() - sp.start
            self._stack.pop()

    def add_manual(self, name: str, start: float, duration: float,
                   parent: Optional[Span] = None, **attrs) -> Optional[Span]:
        """Record a span with explicit timing (attributed iterations,
        host-side planning timed outside a ``with``).  Nests under
        ``parent`` when given, else under the innermost open
        :meth:`span`, else at the root."""
        if not self.enabled:
            return None
        parent_id = (
            parent.span_id if parent is not None
            else (self._stack[-1] if self._stack else None)
        )
        return self._alloc(name, float(start), float(duration), parent_id, attrs)

    # -- aggregation -----------------------------------------------------
    def phase_aggregates(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Per-decision-fingerprint phase sums for drift attribution:
        ``{fingerprint: {phase: {count, observed, predicted, attributed}}}``.
        Each phase span is credited to the nearest enclosing span that
        carries a ``fingerprint`` attribute (the decision key).  See
        :func:`repro_torch.obs.export.aggregate_spans`."""
        from repro_torch.obs.export import aggregate_spans

        return aggregate_spans(self._spans)


def attribute_program_iteration(
    tracer: Tracer,
    program,
    t0: float,
    seconds: float,
    phases: Dict[str, float],
    iteration: Optional[int] = None,
    class_pred: Sequence[float] = (),
) -> Optional[Span]:
    """Record one deep-halo iteration timed as a whole as an attributed
    span tree.

    Only the whole-iteration wall time (``seconds``) is observed; this
    splits it across the pack/wire/unpack/stencil children in the
    proportions of the model's per-phase predictions (``phases``, from
    :func:`repro_torch.fleet.telemetry.predict_program_phases`), marking
    every span ``attributed=True`` so consumers know the split is
    model-shaped while the totals are measured.  The ``exchange`` child
    carries the program's full decision signature.

    ``class_pred`` (the model's per-delta-class completion times, from
    :meth:`~repro_torch.comm.perfmodel.PerfModel.price_class_completions`)
    additionally attributes the wire span across its delta classes: one
    ``wire_class`` child per class, each spanning wire-start to its
    predicted completion fraction of the wire span.
    """
    total = sum(phases.values())
    if total <= 0.0 or not tracer.enabled:
        return None
    # once per iteration on a launch loop: the fingerprint (a content
    # hash) is read once and spans are allocated directly
    scale = seconds / total
    fingerprint = program.fingerprint
    steps = program.steps
    strategy = f"program/s={steps}"
    attrs: Dict[str, object] = {
        "fingerprint": fingerprint, "strategy": strategy,
        "steps": steps, "cycle_len": program.cycle_len,
        "pinned": bool(program.pinned), "attributed": True, "pred": total,
    }
    if iteration is not None:
        attrs["iteration"] = int(iteration)
    alloc = tracer._alloc
    it = alloc("program_iteration", t0, seconds, None, attrs)
    if it is None:
        return None
    wire = program.plan.wire
    pred_ex = phases.get("pack", 0.0) + phases.get("wire", 0.0) + phases.get("unpack", 0.0)
    ex = alloc(
        "exchange", t0, pred_ex * scale, it.span_id,
        {"fingerprint": fingerprint, "strategy": strategy,
         "schedule": wire.schedule, "wire_bytes": int(wire.issued_bytes),
         "attributed": True, "pred": pred_ex},
    )
    ex_id = ex.span_id if ex is not None else it.span_id
    cursor = t0
    for ph in ("pack", "wire", "unpack"):
        p = phases.get(ph, 0.0)
        d = p * scale
        sp = alloc(ph, cursor, d, ex_id, {"pred": p, "attributed": True})
        if ph == "wire" and sp is not None and class_pred:
            # per-delta-class completion profile: each class's span runs
            # wire-start -> its predicted completion fraction
            last = max(class_pred) or 1.0
            for g, tc in enumerate(class_pred):
                alloc("wire_class", cursor, d * (float(tc) / last), sp.span_id,
                      {"pred": float(tc), "attributed": True, "class": g,
                       "key": f"{wire.fingerprint}/c{g}"})
        cursor += d
    napp = max(program.applications, 1)
    pred_st = phases.get("stencil", 0.0)
    per = pred_st * scale / napp
    for a in range(napp):
        alloc("stencil", cursor, per, it.span_id,
              {"pred": pred_st / napp, "attributed": True, "application": a})
        cursor += per
    return it
