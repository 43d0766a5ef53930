"""repro_torch.comm — strategy selection (§5 model), exact-byte wire
plans, transports and the Communicator."""

from repro_torch.comm.api import (
    DEFAULT_SCHEDULE_POLICY,
    MODES,
    BaselinePolicy,
    ClassRequest,
    Communicator,
    FixedPolicy,
    ModelPolicy,
    NeighborRequest,
    Policy,
    Request,
    SendRequest,
    Strategy,
    StrategyRegistry,
    default_registry,
    policy_for_mode,
    register_strategy,
    resolve_strategy,
    static_choice,
)
from repro_torch.comm.perfmodel import (
    H100_ANALYTIC,
    OverlapEstimate,
    PerfModel,
    ProgramEstimate,
    StrategyEstimate,
    SystemParams,
)
from repro_torch.comm.distributed import DistributedTransport
from repro_torch.comm.topology import Topology
from repro_torch.comm.transport import LocalMeshTransport
from repro_torch.comm.wireplan import WireGroup, WirePlan, plan_wire, reschedule

__all__ = [
    "DEFAULT_SCHEDULE_POLICY",
    "MODES",
    "BaselinePolicy",
    "ClassRequest",
    "Communicator",
    "DistributedTransport",
    "FixedPolicy",
    "H100_ANALYTIC",
    "LocalMeshTransport",
    "ModelPolicy",
    "NeighborRequest",
    "OverlapEstimate",
    "PerfModel",
    "Policy",
    "ProgramEstimate",
    "Request",
    "SendRequest",
    "Strategy",
    "StrategyEstimate",
    "StrategyRegistry",
    "SystemParams",
    "Topology",
    "WireGroup",
    "WirePlan",
    "default_registry",
    "plan_wire",
    "policy_for_mode",
    "register_strategy",
    "reschedule",
    "resolve_strategy",
    "static_choice",
]
