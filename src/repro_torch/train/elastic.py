"""Elastic scaling + straggler mitigation, the port's copy of
``repro.train.elastic`` (pure Python; nothing here touches a device).

At 1000+ nodes the failure model is: a node drops out (hardware,
preemption), or a host straggles (thermal throttling, ECC retries).  The
policies here are mechanism-level, so they run on one machine and on a
real cluster:

* **Elastic re-mesh** (`plan_remesh`): given the surviving device count,
  pick the largest valid (data, model) mesh <= survivors that preserves
  the model-parallel degree (weights reshard cheaply along data/pod
  only), rescale the global batch, and return the new mesh spec.

* **Straggler mitigation** (`StragglerMonitor`): EWMA of per-step wall
  time; a step slower than `threshold` x EWMA flags a straggler event.
  Across steps the monitor recommends checkpoint-and-remesh when a host
  is persistently slow (the same elastic path as failures: a slow node
  is treated as a failed one).

* **Decision re-planning** (`replan_on_remesh`): a mesh reshape changes
  the machine the performance model priced — wire-schedule, fusion-depth
  and overlap-mode pins recorded under the old rank->node map are stale
  opinions about a machine that no longer exists.  Rather than silently
  replaying them, the replan rebinds the communicator's topology, clears
  the model's selection cache, and *prunes* every topology-sensitive
  decision row recorded under a different (or no) topology tag — the
  next planning pass re-prices on the new shape and re-records.  The
  topology fingerprint inside wire/program decision keys already makes
  stale pins unreachable; pruning keeps the persisted audit log from
  accumulating rows no lookup can ever hit again.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

__all__ = [
    "plan_remesh",
    "StragglerMonitor",
    "ElasticPolicy",
    "ReplanReport",
    "replan_on_remesh",
]

#: decision strategy prefixes whose rows encode topology-dependent
#: choices (wire schedules, fusion depth, overlap mode) — the rows an
#: elastic remesh must never replay across a reshape
TOPOLOGY_SENSITIVE_PREFIXES = ("wire/", "program/s=", "overlap/mode=")


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    global_batch: int


def plan_remesh(
    survivors: int,
    model_parallel: int,
    global_batch: int,
    multi_pod: bool = False,
    pod_size: int = 256,
) -> MeshPlan:
    """Largest usable mesh after losing devices.

    Keeps the model axis fixed (weight shards survive in-place) and
    shrinks the data (and pod) axes; the global batch is scaled down
    proportionally in whole microbatch units so per-device batch stays
    constant (loss scale unchanged).
    """
    if survivors < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{survivors} devices"
        )
    if multi_pod and survivors >= pod_size * 2:
        pods = survivors // pod_size
        data = pod_size // model_parallel
        frac = (pods * pod_size) / (2 * pod_size)
        return MeshPlan(
            (pods, data, model_parallel),
            ("pod", "data", "model"),
            max(int(global_batch * frac), 1),
        )
    data = survivors // model_parallel
    # data axis must divide the batch; round down to a power of two
    data = 2 ** int(math.log2(data)) if data > 0 else 1
    orig_data = survivors // model_parallel
    frac = data / max(orig_data, 1)
    return MeshPlan(
        (data, model_parallel),
        ("data", "model"),
        max(global_batch * data // max(orig_data, 1), 1),
    )


class StragglerMonitor:
    """EWMA step-time monitor with a slow-step escalation policy."""

    def __init__(self, alpha: float = 0.1, threshold: float = 1.5,
                 patience: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma: Optional[float] = None
        self.slow_streak = 0
        self.events: List[Tuple[int, float, float]] = []

    def observe(self, step: int, seconds: float) -> str:
        """Returns "ok" | "slow" | "remesh"."""
        if self.ewma is None:
            self.ewma = seconds
            return "ok"
        verdict = "ok"
        if seconds > self.threshold * self.ewma:
            self.slow_streak += 1
            self.events.append((step, seconds, self.ewma))
            verdict = "slow"
            if self.slow_streak >= self.patience:
                verdict = "remesh"
        else:
            self.slow_streak = 0
        # slow steps do not pollute the baseline
        if verdict == "ok":
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return verdict


@dataclass(frozen=True)
class ReplanReport:
    """What an elastic re-plan did to the decision state."""

    old_topology: str           # previous topology fingerprint ("" = flat)
    new_topology: str           # fingerprint now bound to the model
    pruned: Tuple[str, ...]     # "strategy@fingerprint" of demoted rows
    cache_cleared: bool         # model selection cache was dropped

    @property
    def npruned(self) -> int:
        return len(self.pruned)


def replan_on_remesh(comm, topology) -> ReplanReport:
    """Rebind ``comm`` (a :class:`repro_torch.comm.api.Communicator`) to the
    post-reshape ``topology`` and demote every stale topology-sensitive
    pin (see the module docstring).

    A decision row is stale when its strategy is topology-dependent
    (:data:`TOPOLOGY_SENSITIVE_PREFIXES`) and its signature's ``topo=``
    tag names a different topology than the new one — including rows
    recorded with *no* tag (planned flat): the reshape invalidates those
    too, because the flat plan's pricing assumed every hop equal.  Rows
    pinned under the incoming topology's own fingerprint survive (a
    replay onto the same shape is exactly what pins are for).
    """
    model = comm.model
    old = model.topology
    old_fp = old.fingerprint if old is not None else ""
    new_fp = topology.fingerprint if topology is not None else ""
    model.topology = topology
    model._cache.clear()
    pruned: Tuple[str, ...] = ()
    if model.decisions is not None and old_fp != new_fp:
        tag = f"topo={new_fp}" if new_fp else None

        def stale(d) -> bool:
            if not d.strategy.startswith(TOPOLOGY_SENSITIVE_PREFIXES):
                return False
            return tag is None or tag not in (d.signature or "")

        pruned = tuple(
            f"{d.strategy}@{d.fingerprint}"
            for d in model.decisions.prune(stale)
        )
    return ReplanReport(
        old_topology=old_fp,
        new_topology=new_fp,
        pruned=pruned,
        cache_cleared=True,
    )


@dataclass
class ElasticPolicy:
    """Driver-facing bundle: detect -> checkpoint -> remesh -> resume."""

    model_parallel: int
    global_batch: int
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)

    def on_failure(self, survivors: int, multi_pod: bool = False) -> MeshPlan:
        return plan_remesh(
            survivors, self.model_parallel, self.global_batch, multi_pod
        )

    def remesh_and_replan(
        self,
        survivors: int,
        comm,
        ranks_per_node: Optional[int] = None,
        multi_pod: bool = False,
    ) -> Tuple[MeshPlan, ReplanReport]:
        """The failure path with decision hygiene: pick the new mesh,
        rebind the communicator's topology to it (``ranks_per_node``
        blocks the surviving ranks onto nodes; None keeps a single-node
        map), and demote every pin the reshape invalidated.  The next
        ``build_halo_program`` / ``plan_neighbor`` on ``comm`` re-prices
        from scratch on the new shape."""
        from repro_torch.comm.topology import Topology

        mesh = self.on_failure(survivors, multi_pod)
        nranks = math.prod(mesh.shape)
        topo = (
            Topology.blocked(nranks, ranks_per_node)
            if ranks_per_node
            else Topology.flat(nranks)
        )
        return mesh, replan_on_remesh(comm, topo)
