"""repro_torch.train — the training side's wire users.  Ported so far:
elastic re-meshing with decision re-planning (``train.elastic``)."""

from repro_torch.train.elastic import (
    TOPOLOGY_SENSITIVE_PREFIXES,
    ElasticPolicy,
    MeshPlan,
    ReplanReport,
    StragglerMonitor,
    plan_remesh,
    replan_on_remesh,
)

__all__ = [
    "TOPOLOGY_SENSITIVE_PREFIXES",
    "ElasticPolicy",
    "MeshPlan",
    "ReplanReport",
    "StragglerMonitor",
    "plan_remesh",
    "replan_on_remesh",
]
