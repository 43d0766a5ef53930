"""Runtime exchange telemetry: the engine's first feedback loop.

Every selection is *predictive*: the model prices a transfer on
once-measured tables and the ``DecisionCache`` pins the winner.  Nothing
checks the prediction unless something observes the wire.  Hunold et al.
("MPI Derived Datatypes: Performance Expectations and Status Quo") show
why that matters — datatype performance shifts across implementations
and versions, and the same holds across a fleet's torch/CUDA/hardware
mix: a decision that was optimal at calibration time goes stale
silently.  This module is the observation side of that loop, transcribed
from the reference's ``repro.fleet.telemetry`` (same file format):

* :class:`RingAggregate` — a bounded ring buffer of observed wall times
  for ONE decision key (count / mean / p95 over the window, lifetime
  count), plus the predicted seconds the model recorded for that key,
  so ``observed / predicted`` is always one division away;
* :class:`ExchangeTelemetry` — the per-process registry of aggregates.
  ``observe()`` is the hot-path probe: one dict lookup and one ring
  write; ``register()`` is the planning half, called by
  :meth:`repro_torch.comm.api.Communicator.plan_neighbor` so every
  priced exchange has its prediction on file before the first
  observation.

Keys are the same content fingerprints the
:class:`~repro_torch.measure.decisions.DecisionCache` uses — a committed
type's fingerprint for point-to-point sends, a
:class:`~repro_torch.comm.wireplan.WirePlan` fingerprint for fused
exchanges, a program fingerprint for deep-halo iterations — so telemetry
rows join decision rows by key and :mod:`repro_torch.fleet.drift` can
compare what the model promised against what the wire delivered.

Wall time is only meaningful around work that has finished: the
Communicator's blocking paths synchronize the buffer's device before
they read the clock, and nothing is observed while a CUDA graph is
being captured.
"""

from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Union

__all__ = [
    "TELEMETRY_FORMAT",
    "TELEMETRY_FILENAME",
    "DEFAULT_WINDOW",
    "RingAggregate",
    "ExchangeTelemetry",
    "predict_class_completions",
    "predict_program_iteration",
    "predict_program_phases",
]

#: bump when the persisted telemetry schema changes incompatibly
TELEMETRY_FORMAT = 1

#: the telemetry file lives next to ``decisions.json`` in the store
TELEMETRY_FILENAME = "telemetry.json"

#: ring-buffer window per decision key — enough samples for a stable
#: p95, small enough that a million-exchange job stays bounded
DEFAULT_WINDOW = 256


class RingAggregate:
    """Bounded ring of observed seconds for one decision key.

    The window keeps the newest ``capacity`` samples; ``total_count``
    keeps the lifetime tally so a long job's report still shows how
    much traffic the window summarizes.  Statistics are computed on
    demand (the probe itself never sorts).
    """

    __slots__ = (
        "key", "strategy", "predicted", "capacity",
        "_ring", "_next", "total_count",
    )

    def __init__(
        self,
        key: str,
        predicted: float = 0.0,
        strategy: str = "",
        capacity: int = DEFAULT_WINDOW,
    ):
        self.key = key
        self.strategy = strategy
        self.predicted = float(predicted)
        self.capacity = int(capacity)
        self._ring: List[float] = []
        self._next = 0
        self.total_count = 0

    # -- hot path --------------------------------------------------------
    def observe(self, seconds: float) -> None:
        if len(self._ring) < self.capacity:
            self._ring.append(seconds)
        else:
            self._ring[self._next] = seconds
            self._next = (self._next + 1) % self.capacity
        self.total_count += 1

    # -- statistics ------------------------------------------------------
    @property
    def count(self) -> int:
        """Samples currently in the window."""
        return len(self._ring)

    @property
    def mean(self) -> float:
        if not self._ring:
            return 0.0
        return sum(self._ring) / len(self._ring)

    @property
    def p95(self) -> float:
        if not self._ring:
            return 0.0
        s = sorted(self._ring)
        return s[min(int(math.ceil(0.95 * len(s))) - 1, len(s) - 1)]

    @property
    def ratio(self) -> Optional[float]:
        """observed mean / predicted seconds (None without both)."""
        if not self._ring or self.predicted <= 0.0:
            return None
        return self.mean / self.predicted

    # -- persistence -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "strategy": self.strategy,
            "predicted": self.predicted,
            "capacity": self.capacity,
            "samples": list(self._ring),
            "total_count": self.total_count,
        }

    @staticmethod
    def from_dict(d: dict) -> "RingAggregate":
        agg = RingAggregate(
            d["key"], d.get("predicted", 0.0), d.get("strategy", ""),
            d.get("capacity", DEFAULT_WINDOW),
        )
        for s in d.get("samples", ()):
            agg.observe(float(s))
        agg.total_count = int(d.get("total_count", agg.total_count))
        return agg


class ExchangeTelemetry:
    """Per-process registry of :class:`RingAggregate` rows, keyed like
    the decision cache.  Attach to a
    :class:`~repro_torch.comm.api.Communicator` (``telemetry=...``) or request
    one from :func:`repro_torch.measure.production.production_communicator`
    (``telemetry=True``); ``repro_torch.fleet.drift`` consumes the result.
    """

    def __init__(self, capacity: int = DEFAULT_WINDOW):
        self.capacity = int(capacity)
        self._by_key: Dict[str, RingAggregate] = {}

    # -- registration (planning half of the probe) -----------------------
    def register(
        self, key: str, predicted: float, strategy: str = ""
    ) -> RingAggregate:
        """Record the model's prediction for a decision key (idempotent;
        a re-plan updates the prediction without dropping samples)."""
        agg = self._by_key.get(key)
        if agg is None:
            agg = RingAggregate(key, predicted, strategy, self.capacity)
            self._by_key[key] = agg
        else:
            agg.predicted = float(predicted)
            if strategy:
                agg.strategy = strategy
        return agg

    # -- observation (hot path) ------------------------------------------
    def observe(
        self,
        key: str,
        seconds: float,
        predicted: Optional[float] = None,
        strategy: str = "",
    ) -> None:
        """One observed exchange: dict lookup + ring write."""
        agg = self._by_key.get(key)
        if agg is None:
            agg = RingAggregate(
                key, predicted or 0.0, strategy, self.capacity
            )
            self._by_key[key] = agg
        elif predicted is not None:
            agg.predicted = float(predicted)
        agg.observe(seconds)

    @contextmanager
    def timed(self, key: str, predicted: Optional[float] = None,
              strategy: str = ""):
        """Time a block of *blocking* work against a decision key.  The
        caller is responsible for synchronization
        (:func:`repro_torch.obs.trace.synchronize`) — an asynchronous
        launch timed here would under-report."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(key, time.perf_counter() - t0, predicted, strategy)

    # -- queries ---------------------------------------------------------
    def get(self, key: str) -> Optional[RingAggregate]:
        return self._by_key.get(key)

    def aggregates(self) -> List[RingAggregate]:
        """All rows, key-sorted (deterministic report order)."""
        return [self._by_key[k] for k in sorted(self._by_key)]

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: object) -> bool:
        return key in self._by_key

    # -- report ----------------------------------------------------------
    def report(self) -> str:
        """Aligned observed-vs-predicted table, one decision key per
        line (the runtime counterpart of ``DecisionCache.report()``)."""
        lines = [
            f"{'key':16s} {'strategy':14s} {'n':>5s} {'total':>7s}"
            f" {'mean_us':>10s} {'p95_us':>10s} {'pred_us':>10s}"
            f" {'obs/pred':>9s}"
        ]
        for agg in self.aggregates():
            ratio = agg.ratio
            shown = f"{ratio:9.3f}" if ratio is not None else f"{'-':>9s}"
            lines.append(
                f"{agg.key:16s} {agg.strategy:14s} {agg.count:5d}"
                f" {agg.total_count:7d} {agg.mean * 1e6:10.3f}"
                f" {agg.p95 * 1e6:10.3f} {agg.predicted * 1e6:10.3f}"
                f" {shown}"
            )
        return "\n".join(lines)

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "format": TELEMETRY_FORMAT,
                "capacity": self.capacity,
                "aggregates": [
                    self._by_key[k].to_dict() for k in sorted(self._by_key)
                ],
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "ExchangeTelemetry":
        d = json.loads(s)
        if d.get("format") != TELEMETRY_FORMAT:
            raise ValueError(
                f"telemetry file format {d.get('format')!r} != "
                f"{TELEMETRY_FORMAT}; re-run with telemetry on"
            )
        tel = ExchangeTelemetry(d.get("capacity", DEFAULT_WINDOW))
        for row in d.get("aggregates", ()):
            tel._by_key[row["key"]] = RingAggregate.from_dict(row)
        return tel

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(self.to_json())
        tmp.replace(p)  # atomic: concurrent readers never see a torn file
        return p

    @staticmethod
    def load(path: Union[str, Path]) -> "ExchangeTelemetry":
        """Load saved telemetry; an absent file yields an empty registry
        (a cold job starts observing from zero)."""
        p = Path(path)
        if not p.exists():
            return ExchangeTelemetry()
        return ExchangeTelemetry.from_json(p.read_text())


def predict_program_phases(program, model) -> Dict[str, float]:
    """The model's per-phase prediction of ONE deep-halo iteration:
    ``{"pack", "wire", "unpack", "stencil"}`` seconds, summing to
    :func:`predict_program_iteration`.

    The member pack/unpack terms are re-priced per committed type
    through the plan's strategies; the wire phase is what remains of the
    estimate's exchange half (so the decomposition is exactly
    consistent with the recorded decision price).  The stencil phase is
    the redundant ghost-shell compute the estimate prices *plus* the
    interior compute it deliberately excludes (every candidate depth
    pays the interior equally — but a wall-clock observer sees it).
    Feeds the per-phase ``pred`` attributes on
    :func:`repro_torch.obs.trace.attribute_program_iteration` span trees and,
    through them, trace-sourced drift attribution.
    """
    est = program.estimate
    t_pack = t_unpack = 0.0
    for ct, strat in zip(program.plan.send_cts, program.plan.strategies):
        e = model.estimate(ct, 1, strat)
        t_pack += e.t_pack
        t_unpack += e.t_unpack
    t_wire = max(est.t_exchange - t_pack - t_unpack, 0.0)
    t_stencil = est.t_redundant
    interior_bytes = (
        math.prod(program.spec.interior) * program.spec.element.size
    )
    for op in program.ops:
        t_app = model.measured_stencil(op.nneighbors, interior_bytes)
        if t_app is None:
            t_app = (op.nneighbors + 2) * (
                interior_bytes / model.params.hbm_bw
            )
        t_stencil += t_app * program.steps
    return {
        "pack": t_pack, "wire": t_wire, "unpack": t_unpack,
        "stencil": t_stencil,
    }


def predict_class_completions(program, model) -> Dict[str, float]:
    """The model's per-delta-class wire-completion predictions for a
    deep-halo program, keyed exactly like the Communicator's per-class
    telemetry rows (``{wire_fingerprint}/c{g}``, the keys
    :meth:`repro_torch.comm.api.Communicator.plan_neighbor` registers when
    the plan has more than one class).  Joining these against the
    observed per-class drain latencies attributes drift to the slow
    *direction* rather than the whole exchange — the region-split
    overlap scheduler's feedback loop."""
    wire = program.plan.wire
    completions = model.price_class_completions(wire)
    return {
        f"{wire.fingerprint}/c{g}": float(t)
        for g, t in enumerate(completions)
    }


def predict_program_iteration(program, model) -> float:
    """Predicted wall seconds of ONE deep-halo program iteration as the
    launch layer observes it: the model's exchange + redundant-shell
    estimate plus the interior stencil compute the estimate deliberately
    excludes (every candidate depth pays the interior equally, so
    ``price_program`` never prices it — but the step timer sees it).
    Priced from the measured stencil sweep when calibrated, else the
    same contiguous-copy proxy ``PerfModel._redundant_time`` falls back
    to.  The per-phase split is :func:`predict_program_phases`."""
    return sum(predict_program_phases(program, model).values())
