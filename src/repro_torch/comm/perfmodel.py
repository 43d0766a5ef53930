"""Runtime performance model for datatype transfer strategies (paper §5).

The paper models three ways to move a non-contiguous GPU object between
ranks — "device" (Eq. 1), "one-shot" (Eq. 2), "staged" (Eq. 3) — from
once-measured system parameters, then picks the cheapest per call site.
The strategy menu and its cost formulas are the reference's, so both
packages make the same choice from the same parameter values:

    rows      pack with the SIMT row kernel, then one send  ≙ "device"
    dma       pack with the staged-tile kernel, then send   ≙ "staged"
    xla       one copy per contiguous block (the naive
              CUDA-aware-MPI baseline every MPI shares)     ≙ baseline
    bounding  send the *contiguous bounding extent* of the object with
              no pack; the receiver extracts             ≙ "one-shot"

Each strategy time decomposes as  T = T_pack + T_link(bytes) + T_unpack.
This slice carries the analytic part only: every term comes from a
:class:`SystemParams` table of constants, and the measured-table lookups
(:meth:`PerfModel.measured`, :meth:`PerfModel.measured_unpack`) answer
None until the port measures its own tables (ROADMAP Queue 1 step 7).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.commit import CommittedType

__all__ = [
    "SystemParams",
    "StrategyEstimate",
    "PerfModel",
    "H100_ANALYTIC",
]

#: reference field name -> port field name (the link terms follow the card)
_REFERENCE_FIELDS = {"ici_bw": "link_bw", "ici_latency": "link_latency"}


@dataclass(frozen=True)
class SystemParams:
    """Analytic system parameters of the §5 model.

    The defaults are those of one H100 SXM and are **unmeasured**:
    ``hbm_bw`` (3.35 TB/s) and ``link_bw`` (NVLink 4: 900 GB/s per card,
    450 GB/s each way) are NVIDIA data-sheet figures; the latency and
    per-operation constants are placeholders of the right order until
    the port's measurement step replaces them.
    """

    name: str
    hbm_bw: float = 3.35e12           # bytes/s of device memory
    link_bw: float = 450e9            # bytes/s per direction of one link
    link_latency: float = 2.0e-6      # per-hop collective latency floor
    kernel_launch: float = 3.0e-6     # fixed cost of one kernel launch
    dma_setup: float = 1.0e-8         # per staged tile of the dma kernel
    xla_copy_overhead: float = 2.0e-6  # per-block copy (cudaMemcpyAsync)

    @staticmethod
    def from_reference(**fields) -> "SystemParams":
        """Parameters from the reference's ``SystemParams`` field values
        (``ici_bw``/``ici_latency`` become ``link_bw``/``link_latency``).
        Measured tables are not ported yet: a non-empty one raises."""
        known = {f.name for f in dataclasses.fields(SystemParams)}
        out = {}
        for k, v in fields.items():
            k = _REFERENCE_FIELDS.get(k, k)
            if k in known:
                out[k] = v
            elif v:
                raise ValueError(f"reference field {k!r} is not ported yet")
        return SystemParams(**out)


#: the default table: one H100 SXM, analytic and unmeasured
H100_ANALYTIC = SystemParams(name="h100_sxm_analytic_unmeasured")


@dataclass(frozen=True)
class StrategyEstimate:
    strategy: str
    t_pack: float
    t_link: float
    t_unpack: float
    #: exact bytes this strategy puts on the wire
    wire_bytes: int = 0

    @property
    def total(self) -> float:
        return self.t_pack + self.t_link + self.t_unpack


class PerfModel:
    """Strategy selection per (committed type, incount, hop count).

    The per-strategy cost formulas live on the
    :class:`~repro_torch.comm.api.Strategy` plugins; this model supplies
    the shared terms (link time, system parameters) and picks the
    cheapest among whatever strategies are registered.  Queries are pure
    functions of their arguments, so results are cached (paper §4/§6.3).
    """

    def __init__(self, params: SystemParams = H100_ANALYTIC):
        self.params = params
        self._cache: Dict[Tuple, StrategyEstimate] = {}
        self.lookups = 0
        self.hits = 0

    @staticmethod
    def _resolve(strategy, registry=None):
        from repro_torch.comm.api import resolve_strategy

        return resolve_strategy(strategy, registry)

    # -- measured tables (none yet: ROADMAP Queue 1 step 7) ---------------
    def measured(self, strategy: str, contig: int, total: int) -> Optional[float]:
        """Measured pack time for a named strategy; None until measured."""
        return None

    def measured_unpack(
        self, strategy: str, contig: int, total: int
    ) -> Optional[float]:
        """Measured unpack time; None until measured."""
        return None

    # -- link term ------------------------------------------------------
    def t_link(self, nbytes: int, hops: int = 1) -> float:
        p = self.params
        return hops * p.link_latency + nbytes / p.link_bw

    # -- exchange pricing (exact-byte wire plans) -----------------------
    def _price_schedule(self, plan, schedule: str) -> float:
        """Predicted seconds of ``plan``'s layout under ``schedule``: the
        link term on the bytes the schedule issues plus one launch
        latency per extra collective."""
        if schedule == "grouped":
            t = self.t_link(plan.wire_bytes, 1)
            return t + (plan.ngroups - 1) * self.params.link_latency
        if schedule == "uniform":
            return self.t_link(plan.nranks * plan.seg_bytes, 1)
        if schedule == "ragged":
            return self.t_link(plan.wire_bytes, 1)
        if schedule in ("tiered", "varlen"):
            raise NotImplementedError(
                f"schedule {schedule!r} is not ported yet (ROADMAP)"
            )
        raise ValueError(f"unknown wire schedule {schedule!r}")

    def price_exchange(self, plan) -> StrategyEstimate:
        """Price a :class:`~repro_torch.comm.wireplan.WirePlan`: the link
        term for the bytes its schedule actually issues, plus the
        per-extra-collective latency of the grouped schedule."""
        t = self._price_schedule(plan, plan.schedule)
        return StrategyEstimate(
            f"wire/{plan.schedule}", 0.0, t, 0.0, wire_bytes=plan.issued_bytes
        )

    def price_wire_schedules(self, plan, native: bool = False) -> Dict[str, float]:
        """Predicted seconds for every wire schedule that could carry the
        plan's layout: ``grouped`` always; ``uniform`` (and ``ragged``
        when the transport has it natively) for a fused plan below the
        large-grid threshold.  ``grouped`` comes first so exact ties
        resolve to it."""
        from repro_torch.comm.wireplan import GROUPED_FALLBACK_RANK_FACTOR

        costs = {"grouped": self._price_schedule(plan, "grouped")}
        oversize = (
            plan.ngroups
            and plan.nranks > GROUPED_FALLBACK_RANK_FACTOR * plan.ngroups
        )
        if plan.fused and not oversize:
            costs["uniform"] = self._price_schedule(plan, "uniform")
            if native:
                costs["ragged"] = self._price_schedule(plan, "ragged")
        return costs

    def choose_wire_schedule(self, plan, native: bool = False):
        """Re-schedule a plan onto the model-cheapest feasible wire
        schedule.  Returns ``(plan, costs)``."""
        from repro_torch.comm.wireplan import reschedule

        costs = self.price_wire_schedules(plan, native)
        best = min(costs, key=costs.get)
        return reschedule(plan, best), costs

    # -- full strategy estimates (Eqs. 1-3 analogue) ----------------------
    def estimate(
        self, ct: CommittedType, incount: int, strategy, hops: int = 1
    ) -> StrategyEstimate:
        return self._resolve(strategy).plan(self, ct, incount, hops)

    def select(
        self,
        ct: CommittedType,
        incount: int = 1,
        hops: int = 1,
        allow_bounding: bool = True,
        registry=None,
    ) -> StrategyEstimate:
        """Pick the cheapest applicable registered strategy (cached per
        call signature).  ``allow_bounding`` admits wire-only strategies
        (data actually crosses a link, so shipping the bounding window
        is meaningful)."""
        if registry is None:
            from repro_torch.comm.api import default_registry

            registry = default_registry()
        # keyed on the type's CONTENT fingerprint and the registry's
        # mutation counter, so a newly registered plugin invalidates
        key = (ct.fingerprint, incount, hops, allow_bounding, id(registry),
               registry.version)
        self.lookups += 1
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        cands = [
            s
            for s in registry.selectable()
            if (allow_bounding or not s.wire_only) and s.applicable(ct)
        ]
        if not cands:
            raise ValueError(f"no applicable strategy registered for {ct!r}")
        best = min(
            (s.plan(self, ct, incount, hops) for s in cands), key=lambda e: e.total
        )
        self._cache[key] = best
        return best
