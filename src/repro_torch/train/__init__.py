"""repro_torch.train — the training side: AdamW, the train and grad step
factories, checkpoints in the reference's format, the gradient wire, and
elastic re-meshing with decision re-planning (the port of the
reference's ``repro.train``)."""

from repro_torch.train.elastic import (
    TOPOLOGY_SENSITIVE_PREFIXES,
    ElasticPolicy,
    MeshPlan,
    ReplanReport,
    StragglerMonitor,
    plan_remesh,
    replan_on_remesh,
)
from repro_torch.train.grad_wire import GRAD_WIRE_MODES, GradWire
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import (
    make_decode_step,
    make_grad_step,
    make_loss_fn,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "GRAD_WIRE_MODES",
    "TOPOLOGY_SENSITIVE_PREFIXES",
    "AdamWConfig",
    "ElasticPolicy",
    "GradWire",
    "MeshPlan",
    "ReplanReport",
    "StragglerMonitor",
    "adamw_update",
    "init_opt_state",
    "make_decode_step",
    "make_grad_step",
    "make_loss_fn",
    "make_prefill_step",
    "make_train_step",
    "plan_remesh",
    "replan_on_remesh",
]
